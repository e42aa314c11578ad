"""Directional and positional encodings: spherical harmonics and the
cell-major multi-resolution hash grid.

Counterpart of ``uncertainty_nerf_gs_tpu/ops/encodings.py`` for the cell
layout, the default ``grid_layout``. ``CellHashEncoding.cells`` has the JAX
package's shape (L, n_rows, 128): cpr = 128 // (8F) cells per row, cell c at
lanes [(c % cpr) * 8F, ...), corner order c = 4x + 2y + z with F innermost.
Read row-major, that memory is (L, n_rows * cpr, 8, F), so the lookup
gathers one (8, F) block per sample and level and needs no one-hot selects.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

# ---------------------------------------------------------------------------
# Spherical harmonics (degree <= 4, i.e. up to 16 components).
# ---------------------------------------------------------------------------


def sh_encoding(directions: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """Real SH basis values of (..., 3) unit directions: (..., levels**2)."""
    if not 1 <= levels <= 4:
        raise ValueError(f"SH levels must be in [1,4], got {levels}")
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z

    comps = [torch.full_like(x, 0.28209479177387814)]  # l=0
    if levels > 1:
        comps += [
            0.4886025119029199 * y,
            0.4886025119029199 * z,
            0.4886025119029199 * x,
        ]
    if levels > 2:
        comps += [
            1.0925484305920792 * xy,
            1.0925484305920792 * yz,
            0.9461746957575601 * zz - 0.31539156525252005,
            1.0925484305920792 * xz,
            0.5462742152960396 * (xx - yy),
        ]
    if levels > 3:
        comps += [
            0.5900435899266435 * y * (3.0 * xx - yy),
            2.890611442640554 * xy * z,
            0.4570457994644658 * y * (5.0 * zz - 1.0),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.4570457994644658 * x * (5.0 * zz - 1.0),
            1.445305721320277 * z * (xx - yy),
            0.5900435899266435 * x * (xx - 3.0 * yy),
        ]
    return torch.stack(comps, dim=-1)


# ---------------------------------------------------------------------------
# Multi-resolution hash grid, cell layout.
# ---------------------------------------------------------------------------

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def _hash_corner_indices(corners: torch.Tensor, table_size: int) -> torch.Tensor:
    """Spatial hash of non-negative integer grid coords (..., 3) to table
    slots, in the JAX package's wrapping uint32 arithmetic: each product is
    taken in int64 and masked to 32 bits, then XORed, then reduced."""
    c = corners.to(torch.int64)
    h = (c[..., 0] * _PRIMES[0]) & _U32
    h = h ^ ((c[..., 1] * _PRIMES[1]) & _U32)
    h = h ^ ((c[..., 2] * _PRIMES[2]) & _U32)
    return h % table_size


def cell_indices(
    positions: torch.Tensor, res: int, table_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cell index + trilinear corner weights for (n, 3) positions in [0, 1].

    Returns (idx (n,) int64, weights (n, 8)); corner order c = 4x + 2y + z.
    Dense indexing where the level's res**3 cells fit the table, the spatial
    hash of the cell's base corner otherwise.
    """
    scaled = positions * res
    base = torch.floor(torch.clamp(scaled, 0, res * (1 - 1e-7))).to(torch.int64)
    base = torch.clamp(base, max=res - 1)
    frac = scaled - base.to(scaled.dtype)
    if res**3 <= table_size:
        idx = base[..., 0] + res * (base[..., 1] + res * base[..., 2])
    else:
        idx = _hash_corner_indices(base, table_size)
    wx = torch.stack([1.0 - frac[..., 0], frac[..., 0]], -1)  # (n, 2)
    wy = torch.stack([1.0 - frac[..., 1], frac[..., 1]], -1)
    wz = torch.stack([1.0 - frac[..., 2], frac[..., 2]], -1)
    w = (
        wx[..., :, None, None] * wy[..., None, :, None] * wz[..., None, None, :]
    ).reshape(positions.shape[:-1] + (8,))
    return idx, w


def cell_lookup(
    cells: torch.Tensor,
    positions: torch.Tensor,
    resolutions,
    table_size: int,
    features_per_level: int = 2,
) -> torch.Tensor:
    """Cell-major lookup: cells (L, n_rows, 128), positions (n, 3) in [0, 1]
    -> (n, L * F) features, level-major."""
    levels = cells.shape[0]
    feats = features_per_level
    blocks = cells.reshape(levels, -1, 8, feats)  # (L, n_rows * cpr, 8, F)
    outs = []
    for lvl, res in enumerate(np.asarray(resolutions)):
        idx, w = cell_indices(positions, int(res), table_size)
        corner = blocks[lvl].index_select(0, idx)  # (n, 8, F): ONE gather
        outs.append(torch.sum(corner * w[..., None], dim=1))
    return torch.cat(outs, dim=-1)


def hash_grid_resolutions(num_levels: int, min_res: int, max_res: int) -> np.ndarray:
    """Per-level resolutions N_l = floor(N_min * b^l) with tcnn's growth
    factor, on the host: they select dense or hashed indexing per level."""
    if num_levels > 1:
        growth = math.exp((math.log(max_res) - math.log(min_res)) / (num_levels - 1))
    else:
        growth = 1.0
    return np.array(
        [int(math.floor(min_res * growth**lvl)) for lvl in range(num_levels)],
        dtype=np.int32,
    )


class CellHashEncoding(nn.Module):
    """Cell-major multi-resolution hash grid (one gather per sample-level).

    Owns ``cells`` of shape (num_levels, n_rows, 128), as the JAX package
    stores it, initialised uniform in [-init_scale, init_scale).
    """

    def __init__(
        self,
        num_levels: int = 16,
        min_res: int = 16,
        max_res: int = 2048,
        log2_hashmap_size: int = 19,
        features_per_level: int = 2,
        init_scale: float = 1e-4,
        *,
        device: torch.device | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if 128 % (8 * features_per_level):
            raise ValueError("8 * features_per_level must divide 128")
        self.features_per_level = features_per_level
        self.table_size = 2**log2_hashmap_size
        cpr = 128 // (8 * features_per_level)
        n_rows = (self.table_size + cpr - 1) // cpr
        self.resolutions = hash_grid_resolutions(num_levels, min_res, max_res)
        cells = torch.empty((num_levels, n_rows, 128), device=device)
        self.cells = nn.Parameter(
            cells.uniform_(-init_scale, init_scale, generator=generator)
        )

    @property
    def output_dim(self) -> int:
        return len(self.resolutions) * self.features_per_level

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        flat = positions.reshape(-1, 3)
        out = cell_lookup(
            self.cells, flat, self.resolutions, self.table_size,
            self.features_per_level,
        )
        return out.reshape(*positions.shape[:-1], self.output_dim)
