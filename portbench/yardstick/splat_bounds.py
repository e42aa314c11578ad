"""The least time of the splat path's compositing kernels, K2 and K3
(``uncertainty_nerf_gs_torch/csrc/composite_tiles.cu``), on an H100 at the
peaks of ``peaks.py``.

A call's work is its composited row x pixel pairs: every tile's rows up to
where the kernels stop (``ops/composite.py::executed_rows``: each tile's
live rows, cut before the first 128-row batch at whose start no pixel's
transmittance exceeds 1e-8), times 256 pixels. Float32 operations a pair
(the kernel source's count): forward 22 + 2C (the Gaussian and its exp,
the gates, the blend), backward 56 + 4C (the Gaussian again, g_w, the
suffix and g_alpha, the six partials, w g_img). Bytes: the composited rows
read once, the pixel centres and counts, and the outputs written; K3 also
reads the forward's outputs and their gradients and writes the composited
rows' gradients. A tile's slots past its composited rows are not counted:
the function needs nothing of them, so the zeros K3 writes there are work
a kernel may leave out. The bound is the larger of operations over the
float32 peak and bytes over the bandwidth.
"""

from __future__ import annotations

from portbench.yardstick.peaks import F32_FLOPS, HBM_BYTES_PER_S

PIXELS = 256


def fwd_ops_per_pair(channels: int) -> int:
    return 22 + 2 * channels


def bwd_ops_per_pair(channels: int) -> int:
    return 56 + 4 * channels


def composite_bytes(rows: int, tiles: int, channels: int, backward: bool) -> int:
    """Bytes a K2 (or K3) call over ``tiles`` tiles must move, ``rows`` rows
    of 6 + ``channels`` floats composited."""
    width = 6 + channels
    nbytes = 4 * (rows * width + tiles * PIXELS * 2 + tiles + tiles * PIXELS * (channels + 1))
    if backward:
        return nbytes + 4 * (tiles * PIXELS * (channels + 1) + rows * width)
    return nbytes


def composite_ops(rows: int, channels: int, backward: bool) -> int:
    return rows * PIXELS * (bwd_ops_per_pair(channels) if backward else fwd_ops_per_pair(channels))


def composite_bound_ms(rows: int, tiles: int, channels: int, backward: bool) -> float:
    """Least milliseconds for the K2 (K3 with ``backward``) calls whose
    summed composited rows and tiles are given."""
    by_bytes = composite_bytes(rows, tiles, channels, backward) / HBM_BYTES_PER_S
    by_ops = composite_ops(rows, channels, backward) / F32_FLOPS
    return 1e3 * max(by_bytes, by_ops)
