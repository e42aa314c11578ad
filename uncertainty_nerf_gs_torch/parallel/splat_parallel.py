"""Splat rendering over a mesh: tile-row bands, one a rank.

Counterpart of ``uncertainty_nerf_gs_tpu/parallel/splat_parallel.py``. A
full image splits into horizontal bands of whole 16-pixel tile rows, one a
rank along a mesh axis (``parallel/mesh.py``, "data" by default). The
Gaussians are replicated: each rank passes the whole projection, shifts its
screen-space y by its band's offset and rasterizes its band through
``ops/rasterize.py::rasterize_gaussians`` (K2 on the card). Tiles are
independent, so the bands need no traffic until they are all-gathered into
the image; the largest overflow is all-reduced.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from uncertainty_nerf_gs_torch.ops.gaussians import Projection
from uncertainty_nerf_gs_torch.ops.rasterize import TILE, rasterize_gaussians
from uncertainty_nerf_gs_torch.parallel.mesh import all_gather_rows, coordinate


def _band_height(height: int, num_devices: int) -> int:
    rows = (height + TILE - 1) // TILE
    rows_per_dev = (rows + num_devices - 1) // num_devices
    return rows_per_dev * TILE


def rasterize_gaussians_sharded(
    proj: Projection,
    opacities: torch.Tensor,
    payload: torch.Tensor,
    width: int,
    height: int,
    mesh,
    axis: str = "data",
    **raster_kwargs,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rasterize with the tile rows split over ``mesh[axis]``; every rank
    passes the same Gaussians. Returns (image (height, W, C), alpha (height,
    W), max_overflow), the same on every rank."""
    index, size = coordinate(mesh, axis)
    band_h = _band_height(height, size)
    y0 = float(index * band_h)
    local = proj._replace(means2d=proj.means2d - torch.stack(
        [torch.zeros_like(proj.means2d[:, 0]), torch.full_like(proj.means2d[:, 1], y0)], dim=-1))
    out = rasterize_gaussians(local, opacities, payload, width, band_h, **raster_kwargs)
    image, alpha = all_gather_rows((out.image, out.alpha), mesh, axis)
    overflow = out.max_overflow.clone()
    dist.all_reduce(overflow, op=dist.ReduceOp.MAX, group=mesh.get_group(axis))
    return image[:height], alpha[:height], overflow
