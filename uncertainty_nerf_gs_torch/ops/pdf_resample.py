"""Inverse-CDF resampling of bin edges (the PDF sampler's core).

Replaces ``uncertainty_nerf_gs_tpu/ops/pdf_pallas.py::resample_edges_tpu``
(Pallas kernel ``_resample_kernel``). On a CUDA tensor ``resample_edges``
launches the hand-written kernel ``csrc/pdf_resample.cu`` (one warp per
ray); on a CPU tensor it runs ``resample_edges_reference``, the plain version
of the same function, written after the XLA branch of the JAX ``sample_pdf``
(``sampling.py``, lines 175-196) with its sums in float64 and in the
kernel's order, so that both versions give the same bits on the same inputs
(a cdf step of an empty bin is about 0.01 / S of the total, and a last-bit
difference in the cdf, divided by it, moves an edge by about 1e-5). Neither is differentiable: the
nerfacto path never takes a gradient through the sampler.
"""

from __future__ import annotations

import ctypes

import torch

from uncertainty_nerf_gs_torch.ops import backend

KERNEL = "pdf_resample"
MAX_BINS = 4096  # a warp stages 2 (S + 1) floats: 32.8 KB, one ray a block


def lane_layout(num_bins: int) -> tuple[int, int]:
    """(bins a lane owns, bins a tile) in ``csrc/pdf_resample.cu``: a warp
    scans 32 runs of 8 consecutive bins (4 up to S = 128) at a time."""
    per = 8 if (num_bins - 1).bit_length() > 7 else 4
    return per, 32 * per


def _k1_cdf(weights: torch.Tensor, histogram_padding: float, eps: float) -> torch.Tensor:
    """[0, clip(inclusive_cumsum(pdf), 0, 1)] (R, S + 1) in ``weights``'
    dtype, every sum taken in float64 and in the kernel's association, so
    that both versions round alike: each lane adds its bins in turn and a
    butterfly over the 32 lanes gives the total; each tile's scan adds a
    lane's run in turn, scans the 32 run totals Kogge-Stone style and
    carries from tile to tile; each cdf entry is rounded to float32 once.
    Float64 adds and divides round the same on the CPU, in PyTorch on the
    card and in the kernel (no fma), so the cdf is the kernel's bit for bit,
    and it is the correctly rounded cdf up to float64's own error: the
    JAX package's float32 scan differs from it by its own rounding only.
    The kernel takes the padding and eps as float32, so they are rounded
    to float32 here too."""
    num_rays, num_bins = weights.shape
    hp = float(torch.tensor(histogram_padding, dtype=torch.float32))
    eps = float(torch.tensor(eps, dtype=torch.float32))
    per, tile = lane_layout(num_bins)
    tiles = -(-num_bins // tile)
    dev = weights.device
    w = torch.zeros(num_rays, tiles * tile, dtype=torch.float64, device=dev)
    w[:, :num_bins] = weights
    w = w.reshape(num_rays, tiles, 32, per)
    valid = (torch.arange(tiles * tile, device=dev) < num_bins).reshape(tiles, 32, per)
    lane = torch.arange(32, device=dev)

    local = w.new_zeros(num_rays, 32)
    for t in range(tiles):
        for k in range(per):
            local = local + torch.where(valid[t, :, k], w[:, t, :, k] + hp, 0.0)
    for off in (16, 8, 4, 2, 1):
        local = local + local[:, lane ^ off]
    w_sum = local[:, :1]
    padding = torch.clamp(eps - w_sum, min=0.0)
    pad_bin = padding / padding.new_tensor(float(num_bins))  # a true divide, as the kernel's
    denom = w_sum + padding

    pdf = torch.where(valid, ((w + hp) + pad_bin[:, :, None, None]) / denom[:, :, None, None], 0.0)
    carry = w.new_zeros(num_rays, 1)
    cdf = []
    for t in range(tiles):
        run = w.new_zeros(num_rays, 32)
        for k in range(per):
            run = run + pdf[:, t, :, k]
        incl = run
        for off in (1, 2, 4, 8, 16):
            shifted = torch.cat([incl.new_zeros(num_rays, off), incl[:, :-off]], dim=1)
            incl = torch.where(lane >= off, incl + shifted, incl)
        acc = carry + torch.cat([incl.new_zeros(num_rays, 1), incl[:, :-1]], dim=1)
        carry = carry + incl[:, 31:]
        entries = []
        for k in range(per):
            acc = acc + pdf[:, t, :, k]
            entries.append(acc)
        cdf.append(torch.stack(entries, dim=-1).reshape(num_rays, tile))
    cdf = torch.clamp(torch.cat(cdf, dim=1)[:, :num_bins], 0.0, 1.0).to(weights.dtype)
    return torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)


@torch.no_grad()
def resample_edges_reference(
    weights: torch.Tensor,
    s_edges: torch.Tensor,
    u: torch.Tensor,
    histogram_padding: float = 0.01,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Plain PyTorch version: (R, S) weights + (R, S+1) sorted edges + (R, N)
    sorted queries in [0, 1) -> (R, N) new edges. The JAX package's
    function; its sums in the kernel's order (``_k1_cdf``)."""
    num_bins = weights.shape[1]
    cdf = _k1_cdf(weights, histogram_padding, eps)
    idx = torch.sum(cdf[:, :, None] <= u[:, None, :], dim=1) - 1
    idx = torch.clamp(idx, 0, num_bins - 1)
    c0 = torch.gather(cdf, -1, idx)
    c1 = torch.gather(cdf, -1, idx + 1)
    e0 = torch.gather(s_edges, -1, idx)
    e1 = torch.gather(s_edges, -1, idx + 1)
    frac = torch.where(
        c1 > c0, (u - c0) / torch.clamp(c1 - c0, min=1e-12), torch.zeros_like(u)
    )
    return e0 + frac * (e1 - e0)


def _row_stride(name: str, t: torch.Tensor) -> int:
    """Floats between the rows the kernel reads: the row width for a
    contiguous tensor, 0 for one contiguous row expanded along dim 0."""
    width = t.shape[1]
    if t.is_contiguous():
        return width
    if t.stride(0) == 0 and (width == 1 or t.stride(1) == 1):
        return 0
    raise ValueError(
        f"{name} must be contiguous or one contiguous row expanded along dim 0, "
        f"got strides {t.stride()} for shape {tuple(t.shape)}"
    )


def _check(weights, s_edges, u) -> tuple[int, int]:
    """Raises on what the kernel does not take; returns the row strides of
    s_edges and u."""
    for name, t in (("weights", weights), ("s_edges", s_edges), ("u", u)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if t.device != weights.device:
            raise ValueError(f"{name} is on {t.device}, weights on {weights.device}")
    r, s = weights.shape
    if not 1 <= s <= MAX_BINS:
        raise ValueError(f"bins per ray must be in [1, {MAX_BINS}], got {s}")
    if tuple(s_edges.shape) != (r, s + 1):
        raise ValueError(f"s_edges must be {(r, s + 1)}, got {tuple(s_edges.shape)}")
    if u.shape[0] != r or u.shape[1] < 1:
        raise ValueError(f"u must be ({r}, N>=1), got {tuple(u.shape)}")
    if not weights.is_contiguous():
        raise ValueError("weights must be contiguous")
    return _row_stride("s_edges", s_edges), _row_stride("u", u)


def _entry(name: str, argtypes: list):
    """A C entry point of the kernel library, built and loaded at first use."""
    fn = getattr(backend.load_library(KERNEL), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_RESAMPLE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                  ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
_FLOOR_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def resample_edges(
    weights: torch.Tensor,
    s_edges: torch.Tensor,
    u: torch.Tensor,
    histogram_padding: float = 0.01,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Checked entry point: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (or inside ``backend.plain_versions()``).
    ``weights`` is contiguous; ``s_edges`` and ``u`` are contiguous or one
    row expanded along dim 0, which the kernel reads in place. Raises on
    what the kernel does not take."""
    edges_stride, u_stride = _check(weights, s_edges, u)
    if not backend.use_kernel(weights):
        return resample_edges_reference(
            weights, s_edges, u, histogram_padding, eps
        )
    r, s = weights.shape
    n = u.shape[1]
    out = torch.empty((r, n), dtype=torch.float32, device=weights.device)
    if r == 0:
        return out
    fn = _entry("pdf_resample_f32", _RESAMPLE_ARGS)
    with torch.cuda.device(weights.device):
        err = fn(
            weights.data_ptr(), s_edges.data_ptr(), edges_stride, u.data_ptr(), u_stride,
            out.data_ptr(), r, s, n, histogram_padding, eps,
            backend.current_stream_handle(weights.device),
        )
    if err != 0:
        raise RuntimeError(f"pdf_resample launch failed: CUDA error {err}")
    backend.count_launch(KERNEL)
    return out


def launch_floor(num_rays: int, num_bins: int, device: torch.device) -> None:
    """Launches an empty kernel with ``resample_edges``' grid, block and
    shared memory for (num_rays, num_bins): the launch's own cost, timed
    beside K1. Not a launch of K1, so it is not counted."""
    fn = _entry("pdf_resample_floor_f32", _FLOOR_ARGS)
    with torch.cuda.device(device):
        err = fn(num_rays, num_bins, backend.current_stream_handle(device))
    if err != 0:
        raise RuntimeError(f"pdf_resample_floor launch failed: CUDA error {err}")
