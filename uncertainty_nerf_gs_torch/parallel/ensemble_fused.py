"""Fused ensemble render: one shared proposal chain and one packed lookup a
field for all M members.

Counterpart of ``uncertainty_nerf_gs_tpu/parallel/ensemble_fused.py``. Two
facts make the members share their hash-grid reads:

1. with one proposal chain for all members (driven by the member-mean
   proposal density), every member samples the same positions, so the cell
   indices are the same for every member;
2. the cell layout keeps a cell's whole trilinear payload in one row, so the
   members' cells can sit side by side: ``pack_ensemble_tables`` stores each
   level as (T, 8, M, F), one row of 8 corners x M members x F features a
   cell, and one packed lookup (K6 on the card, ``ops/encodings.py::
   packed_cell_lookup``) serves the whole ensemble.

A chunk: the shared proposal hierarchy (each proposal's M densities from one
packed lookup, or one a level with ``proposal_anchor_stride``, averaged over
the members, then one K1 resample), the main field as one packed lookup and
the members' MLPs (plain ``nn.Linear`` matmuls, member by member through
``models/ensemble.py::member_apply``), the compositing tail per member, and
``combine_ensemble_outputs``. This deviates from the reference's loop of
member renders (``ensemble_pipeline.py:155-157``, ``models/ensemble.py::
ensemble_render`` here) only in that the members see the shared proposal
samples instead of their own.

Not ported yet (ROADMAP, queue 1, item 7): bf16 and int8 tables
(``table_dtype``), ``table_fold > 1``, ``table_split``, the ``hybrid`` grid
layout, and the ``mesh`` argument (multi-GPU, item 10).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch

from uncertainty_nerf_gs_torch.fields.nerfacto_field import _normalize_positions
from uncertainty_nerf_gs_torch.models.ensemble import (
    combine_ensemble_outputs,
    member_apply,
    member_params,
    stack_outputs,
)
from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig, NerfactoModel
from uncertainty_nerf_gs_torch.ops import raymarch
from uncertainty_nerf_gs_torch.ops.encodings import (
    hash_grid_resolutions,
    pack_member_cell_tables,
    packed_cell_lookup,
    packed_cell_lookup_strided,
)
from uncertainty_nerf_gs_torch.ops.sampling import RayBundle, sample_pdf, sample_uniform

# The proposal fields build their grids at F = 2 whatever the main field's
# features_per_level (the model does not forward it), so the packs do too.
_PROP_FEATS = 2
_NOT_PORTED = "is not ported yet (ROADMAP, queue 1, item 7)"


def _prop_grid_spec(cfg: NerfactoConfig, i: int) -> tuple[np.ndarray, int]:
    args = cfg.proposal_net_args[i]
    res = hash_grid_resolutions(args.get("num_levels", 5), 16, args.get("max_res", 128))
    return res, 2 ** args.get("log2_hashmap_size", 17)


def _check_layout(cfg: NerfactoConfig) -> None:
    if cfg.grid_layout != "cell":
        raise NotImplementedError(f"the fused ensemble with grid_layout={cfg.grid_layout!r} {_NOT_PORTED}")
    for i, args in enumerate(cfg.proposal_net_args):
        if args.get("field_type", cfg.proposal_field_type) != "hash":
            raise NotImplementedError(f"the fused ensemble with an mlp proposal_{i} {_NOT_PORTED}")


def pack_ensemble_tables(
    model: NerfactoModel,
    stacked_params: Mapping[str, torch.Tensor],
    table_dtype: Any = None,
    table_fold: int = 1,
    table_split: bool = False,
) -> dict[str, torch.Tensor]:
    """One-time repack of the members' stacked grid tables into fused eval
    rows: ``{"field": (L, T, 8, M, F), "proposal_i": (L_i, T_i, 8, M, 2)}``,
    float32, on the tables' device."""
    if table_dtype not in (None, torch.float32, "f32"):
        raise NotImplementedError(f"table_dtype={table_dtype!r} {_NOT_PORTED}")
    if table_fold != 1:
        raise NotImplementedError(f"table_fold={table_fold} {_NOT_PORTED}")
    if table_split:
        raise NotImplementedError(f"table_split {_NOT_PORTED}")
    cfg = model.config
    _check_layout(cfg)
    out = {"field": pack_member_cell_tables(
        stacked_params["field.encoding.cells"], 2**cfg.log2_hashmap_size, cfg.features_per_level)}
    for i in range(len(cfg.proposal_net_args)):
        _, table = _prop_grid_spec(cfg, i)
        out[f"proposal_{i}"] = pack_member_cell_tables(
            stacked_params[f"proposal_{i}.encoding.cells"], table, _PROP_FEATS)
    return out


def _submodule_params(params: Mapping[str, torch.Tensor], prefix: str) -> dict[str, torch.Tensor]:
    """A member's parameters of one submodule, without its grid (the fused
    path reads the packed tables instead)."""
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix) and not k.endswith("encoding.cells")}


def build_fused_ensemble_render(
    model: NerfactoModel,
    parity_mode: bool = True,
    proposal_anchor_stride: bool = True,
    main_stride_scale: float = 0.0,
) -> Callable:
    """Returns ``render(stacked_params, packed_tables, ray_bundle)`` -> the
    combined outputs of a ray chunk, without gradients. ``packed_tables``
    come from ``pack_ensemble_tables`` (once per ensemble, not per chunk).

    ``proposal_anchor_stride``: evaluate the proposal grids' coarse levels
    at strided anchors along the ray and lerp between them
    (``packed_cell_lookup_strided``: one packed lookup a level); the main
    field is exact unless ``main_stride_scale`` > 0 strides its coarse
    levels too."""
    cfg = model.config
    _check_layout(cfg)
    feats = cfg.features_per_level
    main_res = hash_grid_resolutions(cfg.num_levels, cfg.base_res, cfg.max_res)
    main_table = 2**cfg.log2_hashmap_size
    num_prop = len(cfg.proposal_net_args)
    next_counts = list(cfg.num_proposal_samples[1:num_prop]) + [cfg.num_nerf_samples]

    def lookup(table, norm, t_mid, res, size, m, f, stride_scale):
        if stride_scale > 0.0:
            return packed_cell_lookup_strided(table, norm, t_mid, res, size, m, f,
                                              stride_scale=stride_scale)
        out = packed_cell_lookup(table, norm.reshape(-1, 3), res, size, m, f)
        return out.reshape(m, *norm.shape[:-1], -1)

    @torch.no_grad()
    def render(stacked_params, packed, ray_bundle: RayBundle) -> dict[str, torch.Tensor]:
        m = next(iter(stacked_params.values())).shape[0]
        members = [member_params(stacked_params, j) for j in range(m)]
        # every ray clamped to the config's near and far planes, as the
        # model's own forward does
        rb = model._with_planes(ray_bundle)

        # the shared proposal hierarchy
        rs = sample_uniform(rb, cfg.num_proposal_samples[0])
        for i, n_next in enumerate(next_counts):
            norm, sel = _normalize_positions(rs.positions, cfg.use_scene_contraction, cfg.aabb)
            res, size = _prop_grid_spec(cfg, i)
            f = lookup(packed[f"proposal_{i}"], norm, rs.midpoints, res, size, m, _PROP_FEATS,
                       1.0 if proposal_anchor_stride else 0.0)
            prefix = f"proposal_{i}."
            d = torch.stack([
                member_apply(getattr(model, f"proposal_{i}"), _submodule_params(members[j], prefix),
                             lambda mdl, x, s: mdl.density_from_feats(x, s), f[j], sel)
                for j in range(m)
            ])
            w = raymarch.render_weights(torch.mean(d, dim=0), rs.deltas)
            rs = sample_pdf(rb, rs.spacing_edges, w, n_next)

        # the main field: one packed lookup, then the members' MLPs
        norm, sel = _normalize_positions(rs.positions, cfg.use_scene_contraction, cfg.aabb)
        f = lookup(packed["field"], norm, rs.midpoints, main_res, main_table, m, feats,
                   main_stride_scale)
        steps, deltas = rs.midpoints, rs.deltas
        tails = []
        for j in range(m):
            fo = member_apply(
                model.field, _submodule_params(members[j], "field."),
                lambda mdl, x, s: mdl.forward_from_feats(
                    x, s, rb.directions, rb.camera_indices, use_average_appearance=True),
                f[j], sel,
            )
            density = cfg.average_init_density * fo.density
            weights = raymarch.render_weights(density, deltas)
            background = model._background(fo.rgb, None)
            depth = raymarch.render_median_depth(weights, steps)
            depth_var = raymarch.depth_variance(weights, steps, depth)
            out = {
                "rgb": raymarch.render_rgb(weights, fo.rgb, background),
                "accumulation": raymarch.render_accumulation(weights),
                "depth": depth,
                "expected_depth": raymarch.render_expected_depth(weights, steps),
                "depth_var": depth_var,
                "depth_std": torch.sqrt(depth_var),
            }
            if fo.uncertainty is not None:
                betas = torch.nan_to_num(fo.uncertainty, nan=0.0)
                rgb_var = raymarch.render_uncertainty(betas, weights**2)
                out["rgb_var"] = rgb_var
                out["rgb_std"] = torch.sqrt(rgb_var)
            tails.append(out)
        return combine_ensemble_outputs(stack_outputs(tails), parity_mode=parity_mode)

    return render
