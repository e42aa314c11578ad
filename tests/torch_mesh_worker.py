"""The rank side of tests/test_torch_parallel.py: one process of a gloo
process group on the CPU, which runs the port's mesh forms on a payload the
test wrote and saves what it got. It imports no JAX.

``run(rank, world, init_file, layout, payload_path, out_path)`` joins the
group through ``init_method="file://<init_file>"``, builds the
``(num_data, num_member)`` mesh, runs each task the payload names and
``torch.save``s {task: result} to ``out_path``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras
from uncertainty_nerf_gs_torch.engine.optimizers import OptimizerGroupConfig
from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig, NerfactoModel
from uncertainty_nerf_gs_torch.ops.gaussians import Projection
from uncertainty_nerf_gs_torch.ops.sampling import RayBundle
from uncertainty_nerf_gs_torch.parallel import ensemble_fused, ensemble_parallel, mesh as tmesh
from uncertainty_nerf_gs_torch.parallel.splat_parallel import rasterize_gaussians_sharded


def _model(payload):
    return NerfactoModel(NerfactoConfig(**payload["config"]), device="cpu")


def _train(mesh, payload) -> dict:
    """One ensemble step on this rank's members and rows, with the members'
    draws for the whole batch: the (M,) losses, this rank's members'
    parameters and first moments."""
    model = _model(payload)
    step = ensemble_parallel.build_ensemble_train_step(
        model, model.config, hemisphere_cameras(*payload["cameras"], seed=1),
        {k: OptimizerGroupConfig(**v) for k, v in payload["groups"].items()}, mesh=mesh, device="cpu")
    state = step.init(tmesh.shard_members(payload["stacked"], mesh), step=payload["step"])
    losses = step(state, tmesh.shard_batch(payload["batch"], mesh), draws=payload["draws"])
    return {"members": state.members, "losses": losses, "params": state.params,
            "mu": state.moments["exp_avg"]}


def _render(mesh, payload) -> dict:
    render = ensemble_parallel.build_ensemble_render(_model(payload), mesh=mesh, parity_mode=False)
    return render(tmesh.shard_members(payload["stacked"], mesh), tmesh.shard_batch(RayBundle(*payload["rays"]), mesh))


def _fused(mesh, payload) -> dict:
    model = _model(payload)
    stacked = tmesh.replicate(payload["stacked"], mesh)
    packed = tmesh.replicate(ensemble_fused.pack_ensemble_tables(model, stacked), mesh)
    render = ensemble_fused.build_fused_ensemble_render(model, mesh=mesh)
    return render(stacked, packed, tmesh.shard_batch(RayBundle(*payload["rays"]), mesh, ("data", "member")))


def _splat(mesh, payload) -> dict:
    s = payload["splat"]
    image, alpha, overflow = rasterize_gaussians_sharded(
        Projection(*s["proj"]), s["opacities"], s["payload"], s["width"], s["height"], mesh, capacity=128)
    return {"image": image, "alpha": alpha, "max_overflow": overflow}


def _refuse(mesh, payload) -> str:
    """``shard_batch`` of a batch that does not split into equal shards."""
    try:
        tmesh.shard_batch({"x": torch.zeros(tmesh.coordinate(mesh, "data")[1] + 1, 3)}, mesh)
    except ValueError as e:
        return str(e)
    return ""


TASKS = {"train": _train, "render": _render, "fused": _fused, "splat": _splat, "refuse": _refuse}


def run(rank: int, world: int, init_file: str, layout: tuple[int, int], payload_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world, rank=rank)
    try:
        payload = torch.load(payload_path, weights_only=False)
        mesh = tmesh.make_mesh(*layout, device_type="cpu")
        results = {task: TASKS[task](mesh, payload) for task in payload["tasks"]}
        torch.save(results, out_path)
    finally:
        dist.destroy_process_group()
