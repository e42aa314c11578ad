"""Matrix-product FLOPs of a nerfacto forward, counted from the
configuration's shapes: 2 per multiply-add of every linear layer, at every
sample each field is queried at. A training step is three forwards' worth
(forward, and the backward's two products a layer)."""

from __future__ import annotations

from typing import Any, Mapping


def _layers(in_dim: int, width: int, out_dim: int, count: int) -> int:
    """Multiply-adds of ``count`` linear layers in -> width ... -> out."""
    dims = [in_dim] + [width] * (count - 1) + [out_dim]
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def forward_flops_per_ray(model: Mapping[str, Any], members: int = 1) -> float:
    """One ray's forward: the proposals' MLPs at their samples, the main
    field's base MLP, heads and colour MLP at its samples; times the members
    (each runs its own MLPs on shared samples)."""
    samples = list(model["num_proposal_samples"]) + [model["num_nerf_samples"]]
    macs = 0
    for i, args in enumerate(model["proposal_net_args"]):
        macs += samples[i] * _layers(args["num_levels"] * 2, args["hidden_dim"], 1, 2)
    width, color_width = model["hidden_dim"], model["hidden_dim_color"]
    grid = model["num_levels"] * model["features_per_level"]
    heads = width * (1 + model["geo_feat_dim"] + model["uncertainty_channels"])
    color_in = model["geo_feat_dim"] + 16 + (model["appearance_embed_dim"] if model["use_appearance_embedding"] else 0)
    color_layers = max(model["num_layers_color"] - 1, 1)
    per_sample = (_layers(grid, width, width, max(model["num_layers"] - 1, 1)) + heads
                  + _layers(color_in, color_width, color_width, color_layers) + color_width * 3)
    macs += samples[-1] * per_sample
    return 2.0 * macs * members
