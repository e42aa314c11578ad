"""A tiny copy of each cell, for the CPU tests: the configurations' keys at
small widths, and the traffic at a few rays, views and pixels."""

from __future__ import annotations

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

SMALL_MODEL = {
    "num_images": 4, "num_proposal_samples": [16, 8], "num_nerf_samples": 8, "num_levels": 4, "base_res": 4,
    "max_res": 32, "log2_hashmap_size": 9, "hidden_dim": 16, "hidden_dim_color": 16, "geo_feat_dim": 7,
    "appearance_embed_dim": 4, "eval_num_rays_per_chunk": 48,
    "proposal_net_args": [{"num_levels": 2, "max_res": 16, "log2_hashmap_size": 7, "hidden_dim": 8},
                          {"num_levels": 2, "max_res": 32, "log2_hashmap_size": 7, "hidden_dim": 8}],
}


# the cells: (configuration, traffic)
CELLS = {"nerfacto-train": ("active-nerfacto", "train-steps-4096"),
         "ensemble5-eval": ("nerfacto-ensemble5", "eval-images-800"),
         "nerfacto-eval": ("active-nerfacto", "eval-images-800")}


def cell(name: str, members: int = 2) -> dict:
    """The tiny counterpart of cell ``name``."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    config_name, traffic_name = CELLS[name]
    config = json.loads((HERE / "configs" / f"{config_name}.json").read_text())
    config["model"].update(copy.deepcopy(SMALL_MODEL))
    if "members" in config:
        config["members"] = members
    traffic = json.loads((HERE / "traffic" / f"{traffic_name}.json").read_text())
    small = {"height": 8, "width": 10}
    if traffic["driver"] == "nerfacto_train":
        traffic.update(rays_per_step=32, steps_per_launch=4, warmup_launches=1, trace_launches=1)
        traffic["scene"].update(small, views=4, gt_samples=32)
    else:
        traffic.update(small, poses=5, check_chunks=2)

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return {"name": name, "chips": 1, "config": config, "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}
