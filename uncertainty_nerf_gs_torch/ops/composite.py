"""Tile compositing of packed Gaussians: forward and analytic backward.

Replaces ``uncertainty_nerf_gs_tpu/ops/rasterize_pallas.py::composite_tiles``,
a ``jax.custom_vjp`` over two Pallas TPU kernels: ``_fwd_call`` (body
``_fwd_kernel``) and ``_bwd_call`` (body ``_bwd_kernel``). On CUDA tensors
``composite_fwd`` and ``composite_bwd`` launch the hand-written kernels of
``csrc/composite_tiles.cu``; on CPU tensors they run the plain versions
below. ``composite_tiles`` ties them together as a
``torch.autograd.Function``.

Packed row layout (D = 6 + C): [mu_x, mu_y, conic_a, conic_b, conic_c,
opacity, payload_0..C-1]; rows past a tile's ``counts`` are dead (opacity 0).
Per pixel, front to back: ``alpha = min(0.999, op * exp(-sigma))``, zeroed
where sigma < 0 or alpha < 1/255; ``w = alpha * T`` with T the exclusive
transmittance; the tile image is ``sum w * payload`` and the alpha
``sum w``. The kernels work through a tile's rows in batches of 128 and stop
once the tile's largest T is at most 1e-8, as the Pallas kernels do, so the
backward is exact for what the forward computed. The backward takes the
forward's outputs: the per-pixel total of ``w * dL/dw`` that its suffix
needs is ``img . g_img + alpha * g_alpha``, so it does not composite the
tile a second time to find it.
"""

from __future__ import annotations

import ctypes

import torch

from uncertainty_nerf_gs_torch.ops import backend

TILE = 16
ALPHA_CLAMP = 0.999
ALPHA_MIN = 1.0 / 255.0
PIXELS = TILE * TILE  # pixels per tile
K_CHUNK = 128  # rows per batch: the Pallas kernels' _K_CHUNK
EXIT_EPS = 1e-8  # saturation exit on the tile's largest transmittance
MAX_CHANNELS = 16  # payload channels the kernels take (registers per thread)

KERNEL = "composite_tiles"
FWD = "composite_fwd"
BWD = "composite_bwd"


def _alphas(packed: torch.Tensor, pix: torch.Tensor, counts: torch.Tensor):
    """(T, K, P) dx, dy, sigma, raw = op * exp(-sigma) and the gated alpha;
    rows at or past ``counts`` get alpha 0. The kernels evaluate sigma and
    raw in this order, each operation rounded on its own, so that on the
    card they take the same gate decisions as this function."""
    k = packed.shape[1]
    mu_x, mu_y, ca, cb, cc, op = (packed[:, :, i, None] for i in range(6))
    dx = pix[:, None, :, 0] - mu_x
    dy = pix[:, None, :, 1] - mu_y
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    raw = op * torch.exp(-sigma)
    alpha = torch.clamp(raw, max=ALPHA_CLAMP)
    row_live = torch.arange(k, device=packed.device)[None, :] < counts[:, None]
    keep = (sigma >= 0.0) & (alpha >= ALPHA_MIN) & row_live[..., None]
    return dx, dy, sigma, raw, torch.where(keep, alpha, torch.zeros_like(alpha))


def _exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.ones_like(x[:, :1]), torch.cumprod(x, dim=1)[:, :-1]], dim=1)


def composite_tiles_reference(
    packed: torch.Tensor, pix: torch.Tensor, counts: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain forward, vectorised over tiles, every live row composited (no
    saturation exit), like the JAX package's "xla" path. Differentiable by
    autograd. Returns ((T, P, C) images, (T, P) alphas)."""
    _, _, _, _, alpha = _alphas(packed, pix, counts)
    w = alpha * _exclusive_cumprod(1.0 - alpha)
    img = torch.einsum("tkp,tkc->tpc", w, packed[:, :, 6:])
    return img, w.sum(dim=1)


def _executed(trans: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """(T, K) bool: the rows the kernels process. A 128-row batch runs while
    rows remain below the tile's count and the tile's largest transmittance
    at the batch's start is above EXIT_EPS; after the first batch that does
    not run, none does."""
    k = trans.shape[1]
    starts = torch.arange(0, k, K_CHUNK, device=trans.device)
    runs = (counts[:, None] > starts[None, :]) & (trans[:, starts, :].amax(dim=-1) > EXIT_EPS)
    runs = torch.cumprod(runs.to(torch.int32), dim=1).bool()
    rows = runs.repeat_interleave(K_CHUNK, dim=1)[:, :k]
    return rows & (torch.arange(k, device=trans.device)[None, :] < counts[:, None])


@torch.no_grad()
def executed_rows(packed: torch.Tensor, pix: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """(T,) int64: how many rows of each tile K2 and K3 composite for these
    inputs (the live rows, cut at the saturation exit)."""
    _, _, _, _, alpha = _alphas(packed, pix, counts)
    trans = _exclusive_cumprod(torch.clamp(1.0 - alpha, min=1.0 - ALPHA_CLAMP))
    return _executed(trans, counts).sum(dim=1)


@torch.no_grad()
def composite_tiles_vjp_reference(
    packed: torch.Tensor,
    pix: torch.Tensor,
    counts: torch.Tensor,
    img: torch.Tensor,
    alpha: torch.Tensor,
    g_img: torch.Tensor,
    g_alpha: torch.Tensor,
) -> torch.Tensor:
    """Plain analytic backward: ``_bwd_kernel``'s formulas over the rows the
    kernels process, given the forward's outputs ``img`` (T, P, C) and
    ``alpha`` (T, P). With g_w = payload . g_img + g_alpha and total =
    img . g_img + alpha * g_alpha (the sum of w * g_w over the composited
    rows), the suffix S_k = total - prefix_k of w * g_w gives dL/dalpha_k =
    T_k g_w,k - S_k / (1 - alpha_k), gated by sigma >= 0 and
    1/255 <= raw < 0.999 and carried to the means, the conic, the opacity
    and ``w * g_img``. Returns (T, K, 6 + C)."""
    total = (img * g_img).sum(dim=-1) + alpha * g_alpha  # (T, P)
    dx, dy, sigma, raw, a = _alphas(packed, pix, counts)
    one_minus = torch.clamp(1.0 - a, min=1.0 - ALPHA_CLAMP)
    trans = _exclusive_cumprod(one_minus)
    rows = _executed(trans, counts)[..., None]  # (T, K, 1)
    w = torch.where(rows, a * trans, torch.zeros_like(a))
    g_w = torch.einsum("tkc,tpc->tkp", packed[:, :, 6:], g_img) + g_alpha[:, None, :]
    wg = w * g_w
    suffix = total[:, None, :] - torch.cumsum(wg, dim=1)
    g_a = trans * g_w - suffix / one_minus
    live = rows & (sigma >= 0.0) & (raw >= ALPHA_MIN) & (raw < ALPHA_CLAMP)
    g_a = torch.where(live, g_a, torch.zeros_like(g_a))
    ca, cb, cc = (packed[:, :, i, None] for i in (2, 3, 4))
    g_sigma = -g_a * raw
    cols = [
        (g_sigma * -(ca * dx + cb * dy)).sum(-1),
        (g_sigma * -(cc * dy + cb * dx)).sum(-1),
        0.5 * (g_sigma * dx * dx).sum(-1),
        (g_sigma * dx * dy).sum(-1),
        0.5 * (g_sigma * dy * dy).sum(-1),
        (g_a * torch.exp(-sigma)).sum(-1),
    ]
    g_pv = torch.einsum("tkp,tpc->tkc", w, g_img)
    return torch.cat([torch.stack(cols, dim=-1), g_pv], dim=-1)


def _check(packed, pix, counts, img=None, alpha=None, g_img=None, g_alpha=None) -> None:
    """Raises on what the kernels do not take: the forward's inputs, and the
    backward's forward outputs and output gradients when given."""
    named = [("packed", packed, torch.float32), ("pix", pix, torch.float32),
             ("counts", counts, torch.int32)]
    if img is not None:
        named += [(name, x, torch.float32) for name, x in
                  (("img", img), ("alpha", alpha), ("g_img", g_img), ("g_alpha", g_alpha))]
    for name, x, dtype in named:
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != packed.device:
            raise ValueError(f"{name} is on {x.device}, packed on {packed.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if packed.dim() != 3 or packed.shape[1] < 1:
        raise ValueError(f"packed must be (T, K>=1, 6+C), got {tuple(packed.shape)}")
    tiles, _, d = packed.shape
    if not 1 <= d - 6 <= MAX_CHANNELS:
        raise ValueError(f"payload channels must be in [1, {MAX_CHANNELS}], got {d - 6}")
    want = {"pix": (tiles, PIXELS, 2), "counts": (tiles,)}
    if img is not None:
        want.update(img=(tiles, PIXELS, d - 6), alpha=(tiles, PIXELS),
                    g_img=(tiles, PIXELS, d - 6), g_alpha=(tiles, PIXELS))
    for name, x, _ in named:
        if name in want and tuple(x.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(x.shape)}")


def _entry(name: str, num_pointers: int):
    """A C entry point of the kernel library, built and loaded at first use."""
    fn = getattr(backend.load_library(KERNEL), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * num_pointers + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def composite_fwd(
    packed: torch.Tensor, pix: torch.Tensor, counts: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2, checked: the CUDA kernel for CUDA tensors, the plain forward for
    CPU tensors. Returns ((T, P, C) images, (T, P) alphas)."""
    _check(packed, pix, counts)
    if not backend.use_kernel(packed):
        return composite_tiles_reference(packed, pix, counts)
    return _launch_fwd(packed, pix, counts)


def _launch_fwd(packed, pix, counts):
    t, k, d = packed.shape
    img = torch.empty((t, PIXELS, d - 6), dtype=torch.float32, device=packed.device)
    alpha = torch.empty((t, PIXELS), dtype=torch.float32, device=packed.device)
    if t == 0:
        return img, alpha
    fn = _entry("composite_fwd_f32", 5)
    with torch.cuda.device(packed.device):
        err = fn(packed.data_ptr(), pix.data_ptr(), counts.data_ptr(), img.data_ptr(),
                 alpha.data_ptr(), t, k, d - 6, backend.current_stream_handle(packed.device))
    if err != 0:
        raise RuntimeError(f"{FWD} launch failed: CUDA error {err}")
    backend.count_launch(FWD)
    return img, alpha


def composite_bwd(
    packed: torch.Tensor,
    pix: torch.Tensor,
    counts: torch.Tensor,
    img: torch.Tensor,
    alpha: torch.Tensor,
    g_img: torch.Tensor,
    g_alpha: torch.Tensor,
) -> torch.Tensor:
    """K3, checked: the CUDA kernel for CUDA tensors, the plain backward for
    CPU tensors. ``img`` and ``alpha`` are the forward's outputs for these
    inputs. Returns g_packed (T, K, 6 + C); rows the forward did not
    composite get 0."""
    _check(packed, pix, counts, img, alpha, g_img, g_alpha)
    if not backend.use_kernel(packed):
        return composite_tiles_vjp_reference(packed, pix, counts, img, alpha, g_img, g_alpha)
    return _launch_bwd(packed, pix, counts, img, alpha, g_img, g_alpha)


def _launch_bwd(packed, pix, counts, img, alpha, g_img, g_alpha):
    t, k, d = packed.shape
    g_packed = torch.empty_like(packed)
    if t == 0:
        return g_packed
    fn = _entry("composite_bwd_f32", 8)
    with torch.cuda.device(packed.device):
        err = fn(packed.data_ptr(), pix.data_ptr(), counts.data_ptr(), img.data_ptr(),
                 alpha.data_ptr(), g_img.data_ptr(), g_alpha.data_ptr(), g_packed.data_ptr(),
                 t, k, d - 6, backend.current_stream_handle(packed.device))
    if err != 0:
        raise RuntimeError(f"{BWD} launch failed: CUDA error {err}")
    backend.count_launch(BWD)
    return g_packed


class CompositeTiles(torch.autograd.Function):
    """K2 forward, K3 backward. The forward records whether it launched K2
    (``backend.use_kernel``), and the backward takes the same path: K3 after
    K2, the plain backward after the plain forward, even when autograd runs
    it after a ``backend.plain_versions()`` block has closed."""

    @staticmethod
    def forward(ctx, packed, pix, counts):
        _check(packed, pix, counts)
        ctx.kernel = backend.use_kernel(packed)
        if ctx.kernel:
            img, alpha = _launch_fwd(packed, pix, counts)
        else:
            img, alpha = composite_tiles_reference(packed, pix, counts)
        # the backward reads its per-pixel total from the outputs
        ctx.save_for_backward(packed, pix, counts, img, alpha)
        return img, alpha

    @staticmethod
    def backward(ctx, g_img, g_alpha):
        packed, pix, counts, img, alpha = ctx.saved_tensors
        g_img = torch.zeros((*pix.shape[:2], packed.shape[2] - 6), dtype=packed.dtype,
                            device=packed.device) if g_img is None else g_img.contiguous()
        g_alpha = torch.zeros(pix.shape[:2], dtype=packed.dtype,
                              device=packed.device) if g_alpha is None else g_alpha.contiguous()
        _check(packed, pix, counts, img, alpha, g_img, g_alpha)
        if ctx.kernel:
            g_packed = _launch_bwd(packed, pix, counts, img, alpha, g_img, g_alpha)
        else:
            g_packed = composite_tiles_vjp_reference(packed, pix, counts, img, alpha, g_img,
                                                     g_alpha)
        return g_packed, None, None


def composite_tiles(
    packed: torch.Tensor, pix: torch.Tensor, counts: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Composite packed per-tile Gaussians, differentiable in ``packed``.

    packed (T, K, 6+C) float32 depth-sorted rows; pix (T, P, 2) float32
    pixel centers; counts (T,) int32 live rows per tile. Returns
    ((T, P, C) tile images, (T, P) tile alphas)."""
    return CompositeTiles.apply(packed, pix, counts)
