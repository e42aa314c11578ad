"""Plain PyTorch deep-ensemble render of M nerfacto members, as the fused
eval path defines it.

The members share one proposal chain: each proposal level's density is the
member mean, its grid evaluated at anchors along the ray (every K-th sample,
K = clip(S // (2 res), 1, 8) per level) and lerped between them in the
sample midpoints. The members' grid tables are read in bf16: the cells are
rounded to bf16 here, from the same float32 weights, and each lookup rounds
its weights, products and sum to bf16 as a bf16 gather-and-lerp does. Each
member then runs its own field MLPs (average appearance) and compositing;
the outputs are averaged over the members, and rgb, depth and expected depth
get the members' unbiased standard deviation (channel-averaged for rgb) and
its square.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from portbench.reference import nerfacto as ref


def pack_tables(stacked_cells: torch.Tensor, table_size: int, features: int) -> torch.Tensor:
    """(M, L, rows, 128) float32 -> (L, T, 8, M, F) bf16: a cell's 8 corners
    x M members x F features side by side."""
    m, levels, rows, _ = stacked_cells.shape
    cells = stacked_cells.reshape(m, levels, rows * 128 // (8 * features), 8, features)[:, :, :table_size]
    return cells.permute(1, 2, 3, 0, 4).contiguous().to(torch.bfloat16)


def _weigh(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n, 8, M, F) bf16 rows, (n, 8) weights -> (n, M, F): weights and
    products rounded to bf16, the corner sum rounded to bf16."""
    wb = w.to(torch.bfloat16).to(torch.float32)
    prod = (rows.to(torch.float32) * wb[:, :, None, None]).to(torch.bfloat16).to(torch.float32)
    return ref.corner_sum(prod).to(torch.bfloat16).to(torch.float32)


def packed_lookup(packed: torch.Tensor, positions: torch.Tensor, resolutions, table_size: int) -> torch.Tensor:
    """(L, T, 8, M, F) rows, (n, 3) positions -> (M, n, L F)."""
    m, feats = packed.shape[3:]
    outs = []
    for lvl, res in enumerate(resolutions):
        idx, w = ref.cell_indices(positions, int(res), table_size)
        outs.append(_weigh(packed[lvl][idx], w))
    out = torch.stack(outs, dim=2)
    return out.permute(1, 0, 2, 3).reshape(m, positions.shape[0], len(resolutions) * feats)


def anchor_stride(num_samples: int, res: int, max_stride: int = 8) -> int:
    return int(np.clip(num_samples // (2 * int(res)), 1, max_stride))


def packed_lookup_strided(packed: torch.Tensor, norm: torch.Tensor, t_mid: torch.Tensor, resolutions,
                          table_size: int) -> torch.Tensor:
    """Level l looked up at anchors 0, K, 2K, ... (the last clamped to S - 1)
    and lerped in ``t_mid`` between the bracketing anchors: norm (R, S, 3),
    t_mid (R, S) -> (M, R, S, L F)."""
    m, feats = packed.shape[3:]
    r, s, _ = norm.shape
    out = torch.empty((m, r, s, len(resolutions) * feats), dtype=torch.float32, device=norm.device)
    for lvl, res in enumerate(resolutions):
        k = anchor_stride(s, res)
        dst = out[..., lvl * feats:(lvl + 1) * feats]
        level = packed[lvl:lvl + 1]
        if k == 1:
            dst.copy_(packed_lookup(level, norm.reshape(-1, 3), [res], table_size).reshape(m, r, s, feats))
            continue
        pad = (-(s - 1)) % k or k
        na = (s - 1 + pad) // k + 1
        idx = torch.from_numpy(np.minimum(np.arange(na) * k, s - 1)).to(norm.device)
        f_a = packed_lookup(level, norm[:, idx].reshape(-1, 3), [res], table_size).reshape(m, r, na, feats)
        t_a = t_mid[:, idx]
        left = torch.repeat_interleave(f_a[:, :, :-1], k, dim=2)[:, :, :s]
        right = torch.repeat_interleave(f_a[:, :, 1:], k, dim=2)[:, :, :s]
        t_left = torch.repeat_interleave(t_a[:, :-1], k, dim=1)[:, :s]
        t_right = torch.repeat_interleave(t_a[:, 1:], k, dim=1)[:, :s]
        w = torch.clamp((t_mid - t_left) / torch.clamp(t_right - t_left, min=1e-12), 0.0, 1.0)[None, :, :, None]
        torch.add(left * (1.0 - w), right * w, out=dst)
    return out


def pack_ensemble(stacked: Mapping[str, torch.Tensor], cfg) -> dict[str, torch.Tensor]:
    """Each field's bf16 packed rows from the members' float32 cells."""
    out = {"field": pack_tables(stacked["field.encoding.cells"], 2 ** cfg["log2_hashmap_size"],
                                cfg["features_per_level"])}
    for i, args in enumerate(cfg["proposal_net_args"]):
        out[f"proposal_{i}"] = pack_tables(stacked[f"proposal_{i}.encoding.cells"], 2 ** args["log2_hashmap_size"], 2)
    return out


@torch.no_grad()
def render_chunk(stacked: Mapping[str, torch.Tensor], packed: Mapping[str, torch.Tensor], cfg,
                 origins: torch.Tensor, dirs: torch.Tensor) -> dict[str, torch.Tensor]:
    """The ensemble's combined outputs for R rays."""
    m = stacked["field.encoding.cells"].shape[0]
    members = [{k: v[j] for k, v in stacked.items()} for j in range(m)]
    num_rays, device = origins.shape[0], origins.device
    near = torch.full((num_rays,), cfg["near_plane"], device=device)
    far = torch.full((num_rays,), cfg["far_plane"], device=device)
    counts = list(cfg["num_proposal_samples"][1:]) + [cfg["num_nerf_samples"]]
    s = ref.Samples(origins, dirs, near, far, ref.uniform_edges(num_rays, cfg["num_proposal_samples"][0], None, device))
    for i, n_next in enumerate(counts):
        args = cfg["proposal_net_args"][i]
        res = ref.grid_resolutions(args["num_levels"], 16, args["max_res"])
        f = packed_lookup_strided(packed[f"proposal_{i}"], ref.contract(s.positions), s.mids, res,
                                  2 ** args["log2_hashmap_size"])
        d = torch.stack([ref.trunc_exp(ref.mlp(members[j], f"proposal_{i}.mlp.", f[j], 2, False)[..., 0])
                         for j in range(m)])
        w = ref.render_weights(torch.mean(d, dim=0), s.deltas)
        s = ref.Samples(origins, dirs, near, far, ref.pdf_edges(s.s_edges, w, n_next, None))
    res = ref.grid_resolutions(cfg["num_levels"], cfg["base_res"], cfg["max_res"])
    norm = ref.contract(s.positions)
    f = packed_lookup(packed["field"], norm.reshape(-1, 3), res, 2 ** cfg["log2_hashmap_size"])
    f = f.reshape(m, *norm.shape[:-1], -1)
    outs = []
    for j in range(m):
        density, rgb, betas = ref.field_heads(members[j], cfg, f[j], dirs, None, average_appearance=True)
        weights = ref.render_weights(cfg["average_init_density"] * density, s.deltas)
        outs.append(ref.composite(weights, rgb, s.mids, betas))
    stacked_out = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    combined = {k: torch.mean(v, dim=0) for k, v in stacked_out.items()}
    for k in ("rgb", "depth", "expected_depth"):
        std = torch.std(stacked_out[k], dim=0, unbiased=True)
        combined[k + "_std"] = torch.mean(std, dim=-1) if std.dim() > 1 and std.shape[-1] == 3 else std
        combined[k + "_var"] = combined[k + "_std"] ** 2
    return combined
