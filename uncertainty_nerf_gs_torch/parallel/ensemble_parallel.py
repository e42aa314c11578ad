"""Ensemble training and rendering: M members trained in one step, rendered
one after another, on one device or over a ("data", "member") mesh.

Counterpart of ``uncertainty_nerf_gs_tpu/parallel/ensemble_parallel.py``.
The members are one dict of (M, ...) tensors under the model's state-dict
names (``interop.stack_params``' layout), and ``models/ensemble.py::
member_apply`` runs one member through the model with its slices in place
of the model's own parameters.

``init_ensemble_params`` draws M independently seeded members.

``build_ensemble_train_step`` returns an ``EnsembleTrainStep``. Its
``init`` makes an ``EnsembleTrainState`` around the stacked parameters,
which it updates in place. A step gives every member the same batch and
its own draws, from a ``torch.Generator`` a member (or the JAX package's,
given as ``draws``), and runs each member's training forward,
``nerfacto_loss`` and backward in turn. ``torch.func.vmap`` cannot batch
the hash-grid kernels (``ops/encodings.py::CellLookup`` launches through
ctypes and has no vmap rule), so the members go in sequence, and the
autograd graph of one member is freed before the next is built. Each
member's leaves are views of the stacked storage detached from it: a
member's gradient is its own tensor, and its Adam update writes the stacked
layout in place (a view of a stacked leaf would send every member's
gradient through ``select_backward``, which zero-fills the whole (M, ...)
tensor a member). One ``ScheduledAdam`` holds a param group per member and
label, each with its own counts, and its moments are (M, ...) tensors too.
So member m's step is the lone single-member step of
``engine/trainer.py::NerfactoTrainer`` on the same batch and draws, bit for
bit. Like the JAX step, it has no camera optimizer, no dropout and no
face-consistency loss. It returns the (M,) per-member total losses on the
device. ``EnsembleTrainStep.launch`` runs K steps with one host read of a
(K, M) buffer: on the card the M member steps are captured once into a
``torch.cuda.CUDAGraph`` (after ``trainer.WARMUP_STEPS`` eager steps, every
member's generator registered, the step counter on the device) and
replayed, each replay's batch copied into the graph's input buffers first.

``build_ensemble_render`` renders a chunk member by member with
``models/ensemble.py::member_outputs`` (each member's own eval forward at
the average appearance), then ``combine_ensemble_outputs``.

With a mesh (``parallel/mesh.py``) each rank holds its members
(``shard_members``) and its rays (``shard_batch``). The train step
averages each member's gradients and losses over "data": every term of
``nerfacto_loss`` is a mean over rays and the shards are equal, so this is
the whole batch's mean. A rank's draws are its rows of its members' draws
for the whole batch, so a step over any mesh is the one-rank step up to the
order of the sums. The render gathers the members' outputs over "member"
before combining them (the epistemic variance needs all of them), then the
rays over "data": its output is replicated. Under a mesh ``launch`` runs its
steps eagerly: no collective is captured into a graph.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.distributed as dist

from uncertainty_nerf_gs_torch.cameras.cameras import Cameras, generate_rays
from uncertainty_nerf_gs_torch.engine.optimizers import (
    OptimizerGroupConfig,
    ScheduledAdam,
    apply_updates,
    param_groups,
)
from uncertainty_nerf_gs_torch.engine.trainer import WARMUP_STEPS
from uncertainty_nerf_gs_torch.models.ensemble import (
    combine_ensemble_outputs,
    member_apply,
    member_outputs,
)
from uncertainty_nerf_gs_torch.models.nerfacto import (
    NerfactoConfig,
    NerfactoModel,
    nerfacto_loss,
    proposal_anneal_factor,
)
from uncertainty_nerf_gs_torch.ops import backend
from uncertainty_nerf_gs_torch.ops.backend import resolve_device
from uncertainty_nerf_gs_torch.parallel.mesh import all_gather_rows, coordinate, shard_batch

BATCH_KEYS = ("camera_indices", "pixel_x", "pixel_y", "image")


def init_ensemble_params(
    config: NerfactoConfig, num_members: int, base_seed: int = 0, device: str | torch.device | None = None
) -> dict[str, torch.Tensor]:
    """M members, member m's weights those of ``NerfactoModel(config,
    generator=...)`` seeded ``base_seed + m``, stacked on a leading axis
    under the state dict's names, in the flax tree's order (sorted by name,
    as ``interop.ensemble_params_from_jax`` gives them). ``device`` None is
    the card."""
    device = resolve_device(device)
    stacked: dict[str, torch.Tensor] = {}
    for m in range(num_members):
        generator = torch.Generator(device=device).manual_seed(base_seed + m)
        state = NerfactoModel(config, device=device, generator=generator).state_dict()
        if not stacked:
            stacked = {k: state[k].new_empty((num_members, *state[k].shape)) for k in sorted(state)}
        for k, v in state.items():
            stacked[k][m].copy_(v)
    return stacked


class EnsembleTrainState:
    """What an ensemble step updates: ``params``, a copy of the stacked
    members this rank holds (all M without a mesh), written in place;
    ``members``, their indices in the ensemble; ``leaves``, each member's
    leaves by name (views of ``params`` detached from it); ``optimizer``, a
    ``ScheduledAdam`` with a param group per member and label (the group's
    ``member`` its index in ``members``); ``moments``, the (M, ...)
    ``exp_avg`` and ``exp_avg_sq`` its groups hold views of;
    ``generators``, a member's draws each; ``step`` on the host and
    ``step_t`` on the device."""

    def __init__(self, stacked_params: Mapping[str, torch.Tensor], members: list[int],
                 groups: Mapping[str, OptimizerGroupConfig] | None, seed: int, step: int, device: torch.device):
        self.device = device
        self.params = {k: v.detach().to(device, copy=True) for k, v in stacked_params.items()}
        self.members = members
        self.leaves = [{k: v[j].detach().requires_grad_(True) for k, v in self.params.items()}
                       for j in range(len(members))]
        self.moments = {key: {k: torch.zeros_like(v) for k, v in self.params.items()}
                        for key in ("exp_avg", "exp_avg_sq")}
        per_member = []
        given = {}
        for j, leaves in enumerate(self.leaves):
            for group in param_groups(leaves, groups):
                per_member.append(dict(group, member=j))
            for k, leaf in leaves.items():
                given[leaf] = {key: self.moments[key][k][j] for key in self.moments}
        self.optimizer = ScheduledAdam(per_member, moments=given)
        self.generators = [torch.Generator(device=device).manual_seed(seed + m) for m in members]
        self.step = step
        self.step_t = torch.full((), step, dtype=torch.int64, device=device)
        self.graphs: dict[int, tuple] = {}  # rays a batch -> (graph, static batch, losses, launches)

    def state_dict(self) -> dict[str, Any]:
        """``params`` and the optimizer state in the stacked layout of
        ``interop.opt_state_from_jax`` (per label a list of counts, one a
        member; (M, ...) moments), ``step`` and the generators' states."""
        groups: dict[str, dict[str, list[int]]] = {}
        for group in self.optimizer.param_groups:
            counts = groups.setdefault(group["name"], {"adam_count": [], "schedule_count": []})
            counts["adam_count"].append(int(group["adam_count"]))
            counts["schedule_count"].append(int(group["count"]))
        return {
            "params": {k: v.detach() for k, v in self.params.items()},
            "opt_state": {"groups": groups, **{key: {k: v.detach() for k, v in m.items()}
                                               for key, m in self.moments.items()}},
            "step": self.step,
            "generators": [g.get_state() for g in self.generators],
        }

    def load_state_dict(self, ckpt: Mapping[str, Any]) -> None:
        """Copy ``state_dict()``'s layout (``opt_state`` may come from
        ``interop.opt_state_from_jax`` of ``jax.vmap(tx.init)``'s state, or
        be left out: the Adam state is then left as it is) into this state,
        in place. A captured step is dropped."""
        with torch.no_grad():
            for k, v in ckpt["params"].items():
                self.params[k].copy_(torch.as_tensor(v))
            opt = ckpt.get("opt_state")
            if opt is not None:
                for key, moments in self.moments.items():
                    for k, v in opt[key].items():
                        moments[k].copy_(torch.as_tensor(v))
                for group in self.optimizer.param_groups:
                    counts = opt["groups"][group["name"]]
                    for name, out in (("adam_count", "adam_count"), ("schedule_count", "count")):
                        value = counts[name]
                        group[out].fill_(int(value if np.ndim(value) == 0 else value[group["member"]]))
        self.step = int(ckpt.get("step", self.step))
        self.step_t.fill_(self.step)
        if ckpt.get("generators") is not None:
            for g, s in zip(self.generators, ckpt["generators"]):
                g.set_state(s)
        self.graphs.clear()


class EnsembleTrainStep:
    """``build_ensemble_train_step``'s result: ``init`` a state, call it for
    a step, ``launch`` K steps. See the module docstring."""

    def __init__(self, model: NerfactoModel, config: NerfactoConfig, cameras: Cameras,
                 optimizer_groups: Mapping[str, OptimizerGroupConfig] | None, mesh, device: torch.device):
        self.model = model
        self.config = config
        self.device = device
        self.cameras = cameras.to(device)
        self.optimizer_groups = optimizer_groups
        self.mesh = mesh

    def init(self, stacked_params: Mapping[str, torch.Tensor], seed: int = 1, step: int = 0) -> EnsembleTrainState:
        """A state over ``stacked_params`` (this rank's members under a mesh,
        ``parallel/mesh.py::shard_members``), Adam's moments and counts at
        zero; member m's generator seeded ``seed + m``."""
        local = next(iter(stacked_params.values())).shape[0]
        first = 0 if self.mesh is None else coordinate(self.mesh, "member")[0] * local
        return EnsembleTrainState(stacked_params, list(range(first, first + local)), self.optimizer_groups,
                                  seed, step, self.device)

    def num_members(self, state: EnsembleTrainState) -> int:
        return len(state.members) * (1 if self.mesh is None else coordinate(self.mesh, "member")[1])

    def _device_step(self, state: EnsembleTrainState, batch: Mapping[str, torch.Tensor],
                     draws: list[dict] | None = None) -> torch.Tensor:
        """One step of every member with no host read; (M,) total losses."""
        size = 1 if self.mesh is None else coordinate(self.mesh, "data")[1]
        num_rays = batch["image"].shape[0] * size  # the whole batch's
        state.optimizer.zero_grad(set_to_none=True)
        anneal = proposal_anneal_factor(state.step_t, self.config)
        rb = generate_rays(self.cameras, batch["camera_indices"], batch["pixel_x"], batch["pixel_y"])
        totals = []
        for j, m in enumerate(state.members):
            d = self.model.draw(num_rays, state.generators[j]) if draws is None else draws[m]
            if self.mesh is not None:
                d = shard_batch(d, self.mesh)  # this rank's rows
            outputs = member_apply(self.model, state.leaves[j],
                                   lambda mdl, rb, d: mdl(rb, train=True, proposal_anneal=anneal, draws=d), rb, d)
            total, _ = nerfacto_loss(outputs, batch, self.config)
            total.backward()
            totals.append(total.detach())
            del outputs, total
        losses = torch.stack(totals)
        if self.mesh is not None:
            group = self.mesh.get_group("data")
            for leaves in state.leaves:
                for leaf in leaves.values():
                    if leaf.grad is not None:
                        dist.all_reduce(leaf.grad, op=dist.ReduceOp.SUM, group=group)
                        leaf.grad.div_(size)
            dist.all_reduce(losses, op=dist.ReduceOp.SUM, group=group)
            losses = all_gather_rows(losses.div_(size), self.mesh, "member")
        apply_updates(state.optimizer)
        state.step_t += 1
        return losses

    def __call__(self, state: EnsembleTrainState, batch: Mapping[str, torch.Tensor],
                 draws: list[dict] | None = None) -> torch.Tensor:
        """One step, eagerly: every member on ``batch`` (this rank's rows
        under a mesh), with its generator's draws or ``draws[m]``
        (``NerfactoModel.draw``'s layout, the whole batch's rows). Returns
        the (M,) total losses on the device."""
        losses = self._device_step(state, batch, draws)
        state.step += 1
        return losses

    def _capture(self, state: EnsembleTrainState, batch: Mapping[str, torch.Tensor]) -> tuple:
        """The step captured into a CUDA graph on copies of ``batch``, every
        member's generator registered; the capture records without running,
        and its launch counts become the replays'."""
        graph = torch.cuda.CUDAGraph()
        for g in state.generators:
            graph.register_generator_state(g)
        static = {k: batch[k].clone() for k in BATCH_KEYS}
        before = dict(backend.launch_counts)
        state.optimizer.zero_grad(set_to_none=True)
        with torch.cuda.graph(graph):
            losses = self._device_step(state, static)
        launches = {k: backend.launch_counts[k] - n for k, n in before.items()}
        backend.launch_counts.update(before)
        return graph, static, losses, launches

    def launch(self, state: EnsembleTrainState, batches: Mapping[str, torch.Tensor]) -> np.ndarray:
        """K steps with one host read: ``batches`` holds K batches on a
        leading axis ((K, R) indices and pixels, (K, R, 3) images). Returns
        the (K, M) losses."""
        k, num_rays = batches["image"].shape[:2]
        rows = []
        if self.device.type != "cuda" or self.mesh is not None:
            for i in range(k):
                rows.append(self._device_step(state, {key: batches[key][i] for key in BATCH_KEYS}))
            state.step += k
            return torch.stack(rows).cpu().numpy()
        done = 0
        captured = state.graphs.get(num_rays)
        if captured is None:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                while done < min(WARMUP_STEPS, k):
                    rows.append(self._device_step(state, {key: batches[key][done] for key in BATCH_KEYS}))
                    done += 1
            torch.cuda.current_stream(self.device).wait_stream(side)
            if done < k:
                first = {key: batches[key][done] for key in BATCH_KEYS}
                captured = state.graphs[num_rays] = self._capture(state, first)
        buffer = torch.empty((k, self.num_members(state)), device=self.device)
        for i, row in enumerate(rows):
            buffer[i].copy_(row)
        if done < k:
            graph, static, losses, launches = captured
            for i in range(done, k):
                for key in BATCH_KEYS:
                    static[key].copy_(batches[key][i])
                graph.replay()
                buffer[i].copy_(losses)
            backend.count_replays(launches, k - done)
        state.step += k
        return buffer.cpu().numpy()


def build_ensemble_train_step(
    model: NerfactoModel,
    config: NerfactoConfig,
    cameras: Cameras,
    optimizer_groups: Mapping[str, OptimizerGroupConfig] | None = None,
    mesh=None,
    device: str | torch.device | None = None,
) -> EnsembleTrainStep:
    """One step that trains every member of an ensemble of ``model``
    (``config`` its config, ``cameras`` the scene's), each under its own
    Adam on ``optimizer_groups``' schedules (``DEFAULT_GROUPS`` if None).
    ``mesh``: a ``parallel/mesh.py::make_mesh`` mesh, members over
    "member" and rays over "data". ``device`` None is the card, and raises
    when there is none."""
    return EnsembleTrainStep(model, config, cameras, optimizer_groups, mesh, resolve_device(device))


def build_ensemble_render(model: NerfactoModel, mesh=None, parity_mode: bool = True) -> Callable:
    """Returns ``render(stacked_params, ray_bundle)`` -> the combined outputs
    of a ray chunk, without gradients: each member's eval forward in turn,
    then ``combine_ensemble_outputs(parity_mode=...)``. With a mesh, this
    rank's members and rays in, the whole chunk's outputs out."""

    @torch.no_grad()
    def render(stacked_params: Mapping[str, torch.Tensor], ray_bundle) -> dict[str, torch.Tensor]:
        stacked = member_outputs(model, stacked_params, ray_bundle)
        if mesh is not None:
            stacked = all_gather_rows(stacked, mesh, "member")
        out = combine_ensemble_outputs(stacked, parity_mode=parity_mode)
        return out if mesh is None else all_gather_rows(out, mesh, "data")

    return render
