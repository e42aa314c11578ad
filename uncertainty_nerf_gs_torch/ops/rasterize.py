"""Tile rasterizer for 3D Gaussian splatting.

Counterpart of ``uncertainty_nerf_gs_tpu/ops/rasterize.py``, with the same
static-shape design:

  1. one global, stable depth ``argsort`` over the fixed-capacity buffer;
  2. a two-level cull: per tile ROW the depth-ordered Gaussians whose
     footprint overlaps it vertically (at most ``row_capacity``), then per
     16x16 tile the first ``capacity`` of those that overlap it
     horizontally, compacted by a cumsum and a scatter (``select_and_pack``,
     the JAX package's gather variant);
  3. the per-tile rows gathered into one contiguous (T, K, 6 + C) buffer and
     composited by ``ops/composite.py::composite_tiles``: the hand-written
     CUDA kernels K2 (forward) and K3 (backward) on the card, their plain
     versions on the CPU. Gradients reach the Gaussians through the gather.

Hits beyond either budget are dropped far to near and reported
(``max_overflow``). The JAX package's other compositing strategies ("xla",
"matmul") are TPU designs; the port refuses them rather than swap one in.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from uncertainty_nerf_gs_torch.ops.composite import (  # noqa: F401 (re-exported)
    ALPHA_CLAMP,
    ALPHA_MIN,
    TILE,
    composite_tiles,
)
from uncertainty_nerf_gs_torch.ops.gaussians import Projection

BACKENDS = ("auto", "pallas")  # both composite with K2 / K3
PACK_VIAS = ("gather", "matmul")  # identical outputs; the port gathers for both


class RasterOutputs(NamedTuple):
    image: torch.Tensor  # (H, W, C) composited payload (no background)
    alpha: torch.Tensor  # (H, W) accumulated opacity
    max_overflow: torch.Tensor  # () int32: worst per-tile hit count beyond capacity


class TileCounts(NamedTuple):
    """Exact per-tile and per-tile-row intersection counts."""

    tile: torch.Tensor  # (num_ty, num_tx) int32
    row: torch.Tensor  # (num_ty,) int32


class SelectPack(NamedTuple):
    """Per-tile selection and pack: packed (T, K, 6+C) depth-sorted rows,
    pix (T, P, 2) pixel centers, counts (T,) int32 live rows, overflows (T,)
    dropped hits per tile, num_tiles = T (tiles are not padded)."""

    packed: torch.Tensor
    pix: torch.Tensor
    counts: torch.Tensor
    overflows: torch.Tensor
    num_tiles: int


def _num_tiles(size: int) -> int:
    return -(-size // TILE)


def tile_hit_counts(proj: Projection, width: int, height: int) -> TileCounts:
    """Exact per-tile / per-tile-row intersecting-Gaussian counts, with the
    selection's bbox predicate (ties inclusive), from a 2-D difference array
    and a double cumsum. The difference array's corners are counted with
    ``torch.bincount`` (integer counts, the same on every run); an indexed
    accumulate serialises on the card where many Gaussians share a corner."""
    num_tx, num_ty = _num_tiles(width), _num_tiles(height)
    r = proj.radii

    def axis_range(v: torch.Tensor, num: int) -> tuple[torch.Tensor, torch.Tensor]:
        # tile t hits iff t*T <= v + r and (t+1)*T >= v - r; clamping to
        # [-1, num] before the integer cast keeps every test below the same
        def to_index(x):
            return torch.clamp(x, -1.0, float(num)).to(torch.int64)

        return (to_index(torch.ceil((v - r) / TILE - 1.0)),
                to_index(torch.floor((v + r) / TILE)))

    x_lo, x_hi = axis_range(proj.means2d[:, 0], num_tx)
    y_lo, y_hi = axis_range(proj.means2d[:, 1], num_ty)
    in_y = proj.valid & (y_hi >= 0) & (y_lo <= num_ty - 1)
    live = in_y & (x_hi >= 0) & (x_lo <= num_tx - 1)
    x0 = torch.clamp(x_lo, 0, num_tx - 1)
    x1 = torch.clamp(x_hi, 0, num_tx - 1)
    y0 = torch.clamp(y_lo, 0, num_ty - 1)
    y1 = torch.clamp(y_hi, 0, num_ty - 1)

    def count(index: torch.Tensor, keep: torch.Tensor, size: int) -> torch.Tensor:
        # the entries not kept go to an extra bin, cut off
        return torch.bincount(torch.where(keep, index, size), minlength=size + 1)[:size]

    stride = num_tx + 1
    size = (num_ty + 1) * stride
    diff = (count(y0 * stride + x0, live, size) - count(y0 * stride + x1 + 1, live, size)
            - count((y1 + 1) * stride + x0, live, size) + count((y1 + 1) * stride + x1 + 1, live, size))
    tile = torch.cumsum(torch.cumsum(diff.reshape(num_ty + 1, stride), dim=0), dim=1)[:num_ty, :num_tx]
    # the row stage tests only the y overlap
    rdiff = count(y0, in_y, num_ty + 1) - count(y1 + 1, in_y, num_ty + 1)
    row = torch.cumsum(rdiff, dim=0)[:num_ty]
    return TileCounts(tile=tile.to(torch.int32), row=row.to(torch.int32))


def _compact(hit: torch.Tensor, values: torch.Tensor, cap: int, fill: int):
    """Per row of ``hit`` (R, M): the ``values`` at its first ``cap`` hits in
    order, ``fill`` after them -> (R, cap); and (R,) hits beyond ``cap``.
    Hits past ``cap`` go to an extra column that is cut off (JAX's
    ``mode="drop"``)."""
    pos = torch.cumsum(hit, dim=1) - 1
    total = pos[:, -1] + 1
    slot = torch.where(hit & (pos < cap), pos, torch.full_like(pos, cap))
    buf = torch.full((hit.shape[0], cap + 1), fill, dtype=torch.int64, device=hit.device)
    buf.scatter_(1, slot, values.expand(hit.shape))
    return buf[:, :cap], torch.clamp(total - cap, min=0)


def _selection(
    proj: Projection,
    opacities: torch.Tensor,
    payload: torch.Tensor,
    width: int,
    height: int,
    capacity: int,
    row_capacity: int | None,
) -> dict:
    """Depth sort, two-level cull and per-tile first-``capacity``
    compaction. Returns the sorted, pad-extended rows (index n is the pad
    row: means -1e6, opacity 0) and the (T, capacity) row indices."""
    n = proj.means2d.shape[0]
    dev = proj.means2d.device
    num_tx, num_ty = _num_tiles(width), _num_tiles(height)
    num_tiles = num_tx * num_ty

    # 1. global front-to-back order; stable, like jnp.argsort
    sort_key = torch.where(proj.valid, proj.depths, torch.full_like(proj.depths, float("inf")))
    order = torch.argsort(sort_key, stable=True)
    means2d = proj.means2d[order]
    radii = proj.radii[order]
    valid = proj.valid[order]

    def pad(x: torch.Tensor, value: float) -> torch.Tensor:
        return torch.cat([x, torch.full((1,) + x.shape[1:], value, dtype=x.dtype, device=dev)])

    means2d_p = pad(means2d, -1e6)
    packed_src = torch.cat(
        [means2d_p, pad(proj.conics[order], 0.0), pad(opacities[order], 0.0)[:, None],
         pad(payload[order], 0.0)],
        dim=1,
    )  # (n + 1, 6 + C)

    # 2a. per tile ROW: depth-ordered candidates overlapping it vertically
    row_cap = int(min(row_capacity or max(4 * capacity, 1024), n))
    y0 = (torch.arange(num_ty, device=dev) * TILE).to(torch.float32)[:, None]
    hit = valid[None] & (means2d[None, :, 1] + radii[None] >= y0) & (
        means2d[None, :, 1] - radii[None] <= y0 + TILE
    )
    gauss_idx = torch.arange(n, device=dev)
    row_idx, row_overflow = _compact(hit, gauss_idx, row_cap, n)  # (num_ty, row_cap)
    row_x = means2d_p.detach()[row_idx, 0]
    row_radii = pad(radii, 0.0)[row_idx]
    row_live = row_idx < n

    # 2b. per tile: the first `capacity` row candidates overlapping it
    tid = torch.arange(num_tiles, device=dev)
    ry = tid // num_tx
    x0 = (tid % num_tx * TILE).to(torch.float32)[:, None]
    hit = row_live[ry] & (row_x[ry] + row_radii[ry] >= x0) & (row_x[ry] - row_radii[ry] <= x0 + TILE)
    idx_all, tile_overflow = _compact(hit, row_idx[ry], capacity, n)  # (T, capacity)
    return dict(
        n=n, num_tx=num_tx, num_ty=num_ty, num_tiles=num_tiles, packed_src=packed_src,
        idx_all=idx_all, overflows=tile_overflow + row_overflow[ry],
    )


def _tile_pixels(num_tx: int, num_ty: int, device) -> torch.Tensor:
    """(T, P, 2) pixel centers (x, y) of every tile, row-major in the tile."""
    py, px = torch.meshgrid(
        torch.arange(TILE, dtype=torch.float32, device=device),
        torch.arange(TILE, dtype=torch.float32, device=device),
        indexing="ij",
    )
    offsets = torch.stack([px.reshape(-1), py.reshape(-1)], dim=-1) + 0.5  # (P, 2)
    tid = torch.arange(num_tx * num_ty, device=device)
    origin = torch.stack([tid % num_tx * TILE, tid // num_tx * TILE], dim=-1).to(torch.float32)
    return offsets[None] + origin[:, None, :]


def select_and_pack(
    proj: Projection,
    opacities: torch.Tensor,
    payload: torch.Tensor,
    width: int,
    height: int,
    capacity: int = 512,
    row_capacity: int | None = None,
    pack_via: str = "gather",
) -> SelectPack:
    """The per-tile packed rows the compositor consumes. ``pack_via`` is
    accepted for the JAX package's signature: both of its values give the
    same rows, and the port gathers for both."""
    if pack_via not in PACK_VIAS:
        raise ValueError(f"pack_via must be one of {PACK_VIAS}, got {pack_via!r}")
    sel = _selection(proj, opacities, payload, width, height, capacity, row_capacity)
    idx_all = sel["idx_all"]
    return SelectPack(
        # (T, K, 6 + C) row gather. As an embedding lookup its backward sums
        # each Gaussian's rows by a sort and skips the pad row, which fills
        # every slot past a tile's count: as an indexed gather, its backward
        # serialised those ~2e5 duplicate pad indices (59 of a step's 67 ms
        # of device time at the splat benchmark shape on an H100)
        packed=F.embedding(idx_all, sel["packed_src"], padding_idx=sel["n"]),
        pix=_tile_pixels(sel["num_tx"], sel["num_ty"], idx_all.device),
        counts=(idx_all < sel["n"]).sum(dim=1).to(torch.int32),
        overflows=sel["overflows"],
        num_tiles=sel["num_tiles"],
    )


def rasterize_gaussians(
    proj: Projection,
    opacities: torch.Tensor,
    payload: torch.Tensor,
    width: int,
    height: int,
    capacity: int = 512,
    backend: str = "auto",
    row_capacity: int | None = None,
    pack_via: str = "gather",
) -> RasterOutputs:
    """Composite (N,) projected Gaussians carrying an (N, C) payload.

    opacities: (N,) post-sigmoid opacity (callers fold in the projection's
    ``compensation``). ``backend`` "auto" and "pallas" both composite with
    K2 / K3, as "auto" does on the TPU; "xla" and "matmul" raise.
    """
    if backend not in BACKENDS:
        raise ValueError(
            f"rasterize backend {backend!r} is a TPU compositing strategy the port "
            f"does not have; use one of {BACKENDS}"
        )
    sp = select_and_pack(proj, opacities, payload, width, height, capacity,
                         row_capacity=row_capacity, pack_via=pack_via)
    imgs, alphas = composite_tiles(sp.packed, sp.pix, sp.counts)
    num_tx, num_ty = _num_tiles(width), _num_tiles(height)
    c = payload.shape[-1]
    image = (
        imgs.reshape(num_ty, num_tx, TILE, TILE, c)
        .permute(0, 2, 1, 3, 4)
        .reshape(num_ty * TILE, num_tx * TILE, c)[:height, :width]
    )
    alpha = (
        alphas.reshape(num_ty, num_tx, TILE, TILE)
        .permute(0, 2, 1, 3)
        .reshape(num_ty * TILE, num_tx * TILE)[:height, :width]
    )
    return RasterOutputs(
        image=image, alpha=alpha, max_overflow=sp.overflows.max().to(torch.int32)
    )


def rasterize_reference(
    proj: Projection,
    opacities: torch.Tensor,
    payload: torch.Tensor,
    width: int,
    height: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Slow O(N*H*W) oracle: per-pixel blend over every Gaussian in depth
    order, no tiling, no capacity. Returns ((H, W, C) image, (H, W) alpha)."""
    order = torch.argsort(
        torch.where(proj.valid, proj.depths, torch.full_like(proj.depths, float("inf"))),
        stable=True,
    )
    mu = proj.means2d[order]
    co = proj.conics[order]
    op = torch.where(proj.valid, opacities, torch.zeros_like(opacities))[order]
    pv = payload[order]
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=mu.device) + 0.5,
        torch.arange(width, dtype=torch.float32, device=mu.device) + 0.5,
        indexing="ij",
    )
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)  # (HW, 2)
    dx = pix[None, :, 0] - mu[:, None, 0]
    dy = pix[None, :, 1] - mu[:, None, 1]
    sigma = 0.5 * (co[:, None, 0] * dx**2 + co[:, None, 2] * dy**2) + co[:, None, 1] * dx * dy
    alpha = torch.clamp(op[:, None] * torch.exp(-sigma), max=ALPHA_CLAMP)
    alpha = torch.where((sigma >= 0.0) & (alpha >= ALPHA_MIN), alpha, torch.zeros_like(alpha))
    trans = torch.cat([torch.ones_like(alpha[:1]), torch.cumprod(1.0 - alpha, dim=0)[:-1]], dim=0)
    w = alpha * trans
    img = torch.einsum("kp,kc->pc", w, pv).reshape(height, width, -1)
    return img, w.sum(dim=0).reshape(height, width)
