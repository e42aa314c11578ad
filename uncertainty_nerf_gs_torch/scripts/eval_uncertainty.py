"""Render functions of the uncertainty evaluation.

Counterpart of the render side of ``uncertainty_nerf_gs_tpu/scripts/
eval_uncertainty.py``: ``_nerfacto_full_image_renderer`` renders a camera's
full image in fixed-size ray chunks through any chunk function, and
``build_ensemble_chunk_fn`` builds the deep ensemble's chunk function, fused
(one shared proposal chain and one packed lookup a field, K6 on the card) or
per member (each member's own forward). The splat family renders whole
frames: ``build_splat_render_fn`` (one trained model, the splat branch of
the JAX ``build_render_fn``) and ``build_ensemble_splat_render_cam`` (its
members stacked), on the config's fixed eval background, with
``_apply_raster_capacity`` to set or probe the rasterizer's budgets for the
eval cameras. They take in-memory members (``interop.stack_params``) or
trainers and cameras; loading runs from checkpoints and the CLI's ``main``
wait for ``engine/checkpointing.py`` (ROADMAP, queue 1, item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

import torch

from uncertainty_nerf_gs_torch.cameras.cameras import Cameras, generate_rays, pixel_grid
from uncertainty_nerf_gs_torch.interop import stack_params
from uncertainty_nerf_gs_torch.models import splatfacto as sf
from uncertainty_nerf_gs_torch.models.ensemble import ensemble_render, ensemble_render_splat
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


def build_splat_render_fn(trainer, eval_cameras: Cameras) -> Callable[[int], dict[str, torch.Tensor]]:
    """``render(i)`` -> the splat trainer's render of eval camera i at the
    full SH degree on the config's fixed background, as (H, W, ...)
    tensors on the trainer's device; the per-Gaussian keys are dropped."""
    cameras = eval_cameras.to(trainer.device)

    @torch.no_grad()
    def render(i: int) -> dict[str, torch.Tensor]:
        cfg = trainer.config
        out = sf.render_splat(
            trainer.params, trainer.splat_state.alive, cameras.camera_to_worlds[i],
            float(cameras.fx[i]), float(cameras.fy[i]), float(cameras.cx[i]), float(cameras.cy[i]),
            cameras.width, cameras.height, cfg, sh_deg=cfg.sh_degree,
            background=sf.fixed_background(cfg, trainer.device),
        )
        return {k: v for k, v in out.items() if k not in ("radii", "visible")}

    return render


def _apply_raster_capacity(trainers: Sequence, cameras: Cameras, setting) -> None:
    """Set the splat trainers' eval rasterize budgets in place. ``setting``:
    None keeps the run's config; an int sets ``rasterize_capacity`` (the
    row budget back to its default); ``"auto"`` probes the exact tile and
    row maxima on ``cameras`` (``tune_rasterize_capacity``), so that the
    eval renders do not overflow, taking the largest over the members,
    which share one config when stacked."""
    if setting is None:
        return
    if setting == "auto":
        cap = row = 0
        for t in trainers:
            tuned = sf.tune_rasterize_capacity(t.config, t.params, t.splat_state.alive,
                                               cameras.to(t.device))
            cap = max(cap, tuned.rasterize_capacity)
            row = max(row, tuned.rasterize_row_capacity or 0)
        new = dict(rasterize_capacity=cap, rasterize_row_capacity=row)
    else:
        new = dict(rasterize_capacity=int(setting), rasterize_row_capacity=None)
    for t in trainers:
        t.config = dataclasses.replace(t.config, **new)
    print(f"[eval raster-capacity] capacity={trainers[0].config.rasterize_capacity}"
          f" row_capacity={trainers[0].config.rasterize_row_capacity}")


def build_ensemble_splat_render_cam(trainers: Sequence, width: int, height: int) -> Callable:
    """The splat deep ensemble, by pose: ``render_cam(c2w, fx, fy, cx, cy)``
    -> the combined outputs (``ensemble_render_splat``) of the trainers'
    members, stacked once on the first trainer's device, at its config on
    its fixed background."""
    stacked = stack_params([{k: v.detach() for k, v in t.params.items()} for t in trainers])
    stacked_alive = torch.stack([t.splat_state.alive for t in trainers])
    cfg0 = trainers[0].config
    background = sf.fixed_background(cfg0, stacked_alive.device)

    @torch.no_grad()
    def render_cam(c2w, fx, fy, cx, cy) -> dict[str, torch.Tensor]:
        return ensemble_render_splat(stacked, stacked_alive, c2w, fx, fy, cx, cy, width, height, cfg0,
                                     background=background)

    return render_cam
