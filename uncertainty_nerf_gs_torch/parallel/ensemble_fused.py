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
   packed_cell_lookup``) serves the whole ensemble. The hybrid layout's
   dense levels are each member's corner grid expanded to cell rows first,
   one member at a time (``_pack_encoding``), and its tables are per-level
   lists (T_l = res^3 at a dense level).

A chunk: the shared proposal hierarchy (each proposal's M densities from one
packed lookup, or one a level with ``proposal_anchor_stride``, averaged over
the members, then one K1 resample; an mlp proposal runs whole, member by
member), the main field as one packed lookup and
the members' MLPs (plain ``nn.Linear`` matmuls, member by member through
``models/ensemble.py::member_apply``), the compositing tail per member, and
``combine_ensemble_outputs``. This deviates from the reference's loop of
member renders (``ensemble_pipeline.py:155-157``, ``models/ensemble.py::
ensemble_render`` here) only in that the members see the shared proposal
samples instead of their own.

The tables' options are the JAX package's: ``table_dtype`` float32, bf16
(the JAX CLI's default) or int8 (``quantize_cell_tables_int8``, per-level
scales), and the exact relayouts ``table_fold`` and ``table_split``, views of
the same rows here (``ops/encodings.py``). With a ``mesh``
(``parallel/mesh.py``), the rays split over the whole mesh (both dims as one
axis), the tables and parameters are replicated, and the outputs are
all-gathered: each rank passes its rows (``shard_batch(rb, mesh, ("data",
"member"))``) and receives the whole chunk's outputs.
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
    dense_corner_to_cell_rows,
    fold_packed_tables,
    hash_grid_resolutions,
    hybrid_is_dense,
    pack_member_cell_tables,
    packed_cell_lookup,
    packed_cell_lookup_strided,
    quantize_cell_tables_int8,
    split_packed_tables,
)
from uncertainty_nerf_gs_torch.ops.sampling import RayBundle, sample_pdf, sample_uniform
from uncertainty_nerf_gs_torch.parallel.mesh import MESH_DIMS, all_gather_rows
from uncertainty_nerf_gs_torch.utils.tracing import span

# The proposal fields build their grids at F = 2 whatever the main field's
# features_per_level (the model does not forward it), so the packs do too.
_PROP_FEATS = 2
_DTYPES = {None: None, "f32": None, "bf16": torch.bfloat16, "int8": torch.int8}


def _prop_grid_spec(cfg: NerfactoConfig, i: int) -> tuple[np.ndarray, int]:
    args = cfg.proposal_net_args[i]
    res = hash_grid_resolutions(args.get("num_levels", 5), 16, args.get("max_res", 128))
    return res, 2 ** args.get("log2_hashmap_size", 17)


def _is_mlp_proposal(cfg: NerfactoConfig, i: int) -> bool:
    return cfg.proposal_net_args[i].get("field_type", cfg.proposal_field_type) == "mlp"


def _grid_sizes(resolutions, table_size: int, layout: str) -> list[int]:
    """Per-level cell counts: res^3 at the hybrid layout's dense levels,
    table_size elsewhere (``HybridHashEncoding.level_sizes``)."""
    if layout != "hybrid":
        return [table_size] * len(resolutions)
    return [int(r) ** 3 if hybrid_is_dense(int(r), table_size) else table_size for r in resolutions]


def _pack_encoding(stacked_params, prefix: str, resolutions, table_size: int, feats: int, layout: str,
                   table_dtype):
    """One encoding's stacked member parameters -> packed eval rows. The
    cell layout: ``cells`` (M, L, rows, 128) -> (L, T, 8, M, F). The hybrid
    layout: each dense level's corner grids expanded one member at a time
    (a full-width dense level's float32 cell rows are 0.46 GB a member),
    packed beside the hashed levels: a per-level list. bf16 converts the
    packed float32 rows; int8 quantizes them level by level (the dict form,
    ``quantize_cell_tables_int8``)."""
    quantize = table_dtype == torch.int8
    dtype = None if quantize else table_dtype
    if layout == "cell":
        packed = pack_member_cell_tables(stacked_params[prefix + "cells"], table_size, feats, dtype=dtype)
        return quantize_cell_tables_int8(packed) if quantize else packed
    per_level, hi = [], 0
    for lvl, res in enumerate(int(r) for r in np.asarray(resolutions)):
        if hybrid_is_dense(res, table_size):
            grids = stacked_params[f"{prefix}corners_{lvl}"]
            rows = torch.stack([dense_corner_to_cell_rows(g, res, feats) for g in grids])  # (M, rows, 128)
            per_level.append(pack_member_cell_tables(rows[:, None], res**3, feats, dtype=dtype)[0])
            del rows
        else:
            per_level.append(pack_member_cell_tables(stacked_params[prefix + "cells"][:, hi:hi + 1], table_size,
                                                     feats, dtype=dtype)[0])
            hi += 1
    return quantize_cell_tables_int8(per_level) if quantize else per_level


def pack_ensemble_tables(
    model: NerfactoModel,
    stacked_params: Mapping[str, torch.Tensor],
    table_dtype: Any = None,
    table_fold: int = 1,
    table_split: bool = False,
) -> dict[str, Any]:
    """One-time repack of the members' stacked grid tables into fused eval
    rows: ``{"field": ..., "proposal_i": ... or None (an mlp proposal)}``,
    each (L, T, 8, M, F) (the cell layout), a per-level list of (T_l, 8, M,
    F) (hybrid) or the ``{"tables", "scales"}`` dict form (int8, folded or
    split tables), on the tables' device. ``table_dtype``: None or "f32",
    "bf16" or "int8". ``table_fold`` > 1 and
    ``table_split``: the JAX package's exact relayouts, views of the same
    rows here."""
    if table_dtype not in _DTYPES:
        raise ValueError(f"table_dtype must be one of f32, bf16, int8; got {table_dtype!r}")
    dtype = _DTYPES[table_dtype]
    cfg = model.config
    layout = cfg.grid_layout
    if layout not in ("cell", "hybrid"):
        raise ValueError(f"the fused ensemble needs cell rows: grid_layout 'cell' or 'hybrid', got {layout!r}")
    res = hash_grid_resolutions(cfg.num_levels, cfg.base_res, cfg.max_res)
    out = {"field": _pack_encoding(stacked_params, "field.encoding.", res, 2**cfg.log2_hashmap_size,
                                   cfg.features_per_level, layout, dtype)}
    levels = {"field": len(res)}
    feats = {"field": cfg.features_per_level}
    for i in range(len(cfg.proposal_net_args)):
        key = f"proposal_{i}"
        if _is_mlp_proposal(cfg, i):
            out[key] = None  # gather-free
            continue
        res_i, table = _prop_grid_spec(cfg, i)
        out[key] = _pack_encoding(stacked_params, f"{key}.encoding.", res_i, table, _PROP_FEATS, layout, dtype)
        levels[key], feats[key] = len(res_i), _PROP_FEATS
    m = next(iter(stacked_params.values())).shape[0]
    if table_fold > 1:
        for k, n_lvl in levels.items():
            out[k] = fold_packed_tables(out[k], table_fold, n_lvl)
    if table_split:
        for k, n_lvl in levels.items():
            out[k] = split_packed_tables(out[k], n_lvl, real_lanes=8 * m * feats[k])
    return out


def _submodule_params(params: Mapping[str, torch.Tensor], prefix: str) -> dict[str, torch.Tensor]:
    """A member's parameters of one submodule, without its grid (the fused
    path reads the packed tables instead)."""
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix) and not k.startswith(prefix + "encoding.")}


def build_fused_ensemble_render(
    model: NerfactoModel,
    mesh=None,
    parity_mode: bool = True,
    proposal_anchor_stride: bool = True,
    main_stride_scale: float = 0.0,
) -> Callable:
    """Returns ``render(stacked_params, packed_tables, ray_bundle)`` -> the
    combined outputs of a ray chunk, without gradients. ``packed_tables``
    come from ``pack_ensemble_tables`` (once per ensemble, not per chunk).
    ``mesh``: this rank's rays in (split over the whole mesh), the tables
    and parameters replicated, the whole chunk's outputs out.

    ``proposal_anchor_stride``: evaluate the proposal grids' coarse levels
    at strided anchors along the ray and lerp between them
    (``packed_cell_lookup_strided``: one packed lookup a level); the main
    field is exact unless ``main_stride_scale`` > 0 strides its coarse
    levels too."""
    cfg = model.config
    feats = cfg.features_per_level
    main_res = hash_grid_resolutions(cfg.num_levels, cfg.base_res, cfg.max_res)
    main_sizes = _grid_sizes(main_res, 2**cfg.log2_hashmap_size, cfg.grid_layout)
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
        with span("ungs.ensemble.proposals"):
            rs = sample_uniform(rb, cfg.num_proposal_samples[0])
            for i, n_next in enumerate(next_counts):
                prefix, field = f"proposal_{i}.", getattr(model, f"proposal_{i}")
                if packed[f"proposal_{i}"] is None:  # an mlp proposal: the whole field, member by member
                    d = torch.stack([
                        member_apply(field, _submodule_params(members[j], prefix), lambda mdl, p: mdl(p),
                                     rs.positions)
                        for j in range(m)
                    ])
                else:
                    norm, sel = _normalize_positions(rs.positions, cfg.use_scene_contraction, cfg.aabb)
                    res, table = _prop_grid_spec(cfg, i)
                    f = lookup(packed[f"proposal_{i}"], norm, rs.midpoints, res,
                               _grid_sizes(res, table, cfg.grid_layout), m, _PROP_FEATS,
                               1.0 if proposal_anchor_stride else 0.0)
                    d = torch.stack([
                        member_apply(field, _submodule_params(members[j], prefix),
                                     lambda mdl, x, s: mdl.density_from_feats(x, s), f[j], sel)
                        for j in range(m)
                    ])
                w = raymarch.render_weights(torch.mean(d, dim=0), rs.deltas)
                rs = sample_pdf(rb, rs.spacing_edges, w, n_next)

        # the main field: one packed lookup, then the members' MLPs
        with span("ungs.ensemble.lookup"):
            norm, sel = _normalize_positions(rs.positions, cfg.use_scene_contraction, cfg.aabb)
            f = lookup(packed["field"], norm, rs.midpoints, main_res, main_sizes, m, feats,
                       main_stride_scale)
        steps, deltas = rs.midpoints, rs.deltas
        tails = []
        with span("ungs.ensemble.members"):
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
        with span("ungs.ensemble.combine"):
            out = combine_ensemble_outputs(stack_outputs(tails), parity_mode=parity_mode)
        return out if mesh is None else all_gather_rows(out, mesh, MESH_DIMS)

    return render
