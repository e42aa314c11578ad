"""Render functions of the uncertainty evaluation.

Counterpart of the render side of ``uncertainty_nerf_gs_tpu/scripts/
eval_uncertainty.py``: ``_nerfacto_full_image_renderer`` renders a camera's
full image in fixed-size ray chunks through any chunk function, and
``build_ensemble_chunk_fn`` builds the deep ensemble's chunk function, fused
(one shared proposal chain and one packed lookup a field, K6 on the card) or
per member (each member's own forward). They take in-memory members
(``interop.stack_params``) and cameras; loading runs from checkpoints and the
CLI's ``main`` wait for ``engine/checkpointing.py`` (ROADMAP, queue 1,
item 6).
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from uncertainty_nerf_gs_torch.cameras.cameras import Cameras, generate_rays, pixel_grid
from uncertainty_nerf_gs_torch.models.ensemble import ensemble_render
from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig, NerfactoModel
from uncertainty_nerf_gs_torch.ops.backend import resolve_device
from uncertainty_nerf_gs_torch.parallel.ensemble_fused import (
    build_fused_ensemble_render,
    pack_ensemble_tables,
)


def _nerfacto_full_image_renderer(
    config: NerfactoConfig,
    render_chunk_fn: Callable,
    eval_cameras: Cameras,
    device: str | torch.device | None = None,
) -> Callable[[int], dict[str, torch.Tensor]]:
    """``render(i)`` -> camera i's outputs as (H, W, ...) tensors on the
    device, from ``render_chunk_fn(ray_bundle)`` over chunks of
    ``config.eval_num_rays_per_chunk`` rays; the last chunk is padded with
    pixel (0, 0) and cut off after. The training-only keys are dropped."""
    device = resolve_device(device)
    cameras = eval_cameras.to(device)

    def render(i: int) -> dict[str, torch.Tensor]:
        h, w = cameras.height, cameras.width
        chunk = config.eval_num_rays_per_chunk
        px, py = pixel_grid(h, w, device)
        total = h * w
        pad = (-total) % chunk
        zeros = torch.zeros(pad, dtype=torch.float32, device=device)
        px, py = torch.cat([px, zeros]), torch.cat([py, zeros])
        idx = torch.full((total + pad,), i, dtype=torch.int64, device=device)
        outs: dict[str, list[torch.Tensor]] = {}
        for s in range(0, total + pad, chunk):
            rb = generate_rays(cameras, idx[s:s + chunk], px[s:s + chunk], py[s:s + chunk])
            for k, v in render_chunk_fn(rb).items():
                if k.startswith(("weights", "sdist")) or k == "density_mean":
                    continue
                outs.setdefault(k, []).append(v)
        return {k: torch.cat(v, 0)[:total].reshape((h, w) + v[0].shape[1:]) for k, v in outs.items()}

    return render


def build_ensemble_chunk_fn(
    model: NerfactoModel,
    stacked_params: Mapping[str, torch.Tensor],
    main_stride_scale: float = 0.0,
    table_dtype: str = "f32",
    table_fold: int = 1,
    ensemble_mode: str = "fused",
    table_split: bool = False,
) -> Callable:
    """The nerfacto-family ensemble's chunk renderer ``rb -> combined
    outputs``: ``ensemble_mode="fused"`` packs the members' tables once and
    renders through ``build_fused_ensemble_render``; ``"per_member"``
    renders each member's own forward (``ensemble_render``). Only float32
    tables are ported (``table_dtype="f32"``; the JAX package's default is
    bf16)."""
    stacked = {k: v for k, v in stacked_params.items() if k != "camera_opt"}
    if ensemble_mode == "fused":
        if table_dtype != "f32":
            raise NotImplementedError(f"table_dtype={table_dtype!r} is not ported yet "
                                      "(ROADMAP, queue 1, item 7)")
        packed = pack_ensemble_tables(model, stacked, table_fold=table_fold, table_split=table_split)
        fused = build_fused_ensemble_render(model, main_stride_scale=main_stride_scale)

        def chunk_fn(rb):
            return fused(stacked, packed, rb)
    elif ensemble_mode == "per_member":

        def chunk_fn(rb):
            return ensemble_render(model, stacked, rb)
    else:
        raise ValueError(f"unknown ensemble_mode {ensemble_mode!r}")
    return chunk_fn
