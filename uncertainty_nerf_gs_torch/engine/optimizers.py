"""Per-group optimizers with exponential-decay schedules.

Counterpart of ``uncertainty_nerf_gs_tpu/engine/optimizers.py``. There one
``optax.multi_transform`` holds an Adam (AdamW where a group asks for weight
decay) per group, each with its schedule inside. Here ``make_optimizer``
builds one ``torch.optim.Adam`` with a param group per label, and
``apply_updates`` sets each group's lr from its schedule at the group's
count of updates made so far (optax's count) before ``step()``, then counts
the update. A group with ``weight_decay > 0`` decays decoupled, as AdamW.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Mapping

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerGroupConfig:
    lr: float = 1e-2
    eps: float = 1e-15
    lr_final: float = 1e-4
    max_steps: int = 200_000
    weight_decay: float = 0.0
    warmup_steps: int = 0


DEFAULT_GROUPS: dict[str, OptimizerGroupConfig] = {
    # a short linear warmup lets the density and proposal geometry form
    # before Adam (eps 1e-15) turns the colour path's near-zero early
    # gradients into full-lr steps (the JAX package's note)
    "proposal_networks": OptimizerGroupConfig(
        lr=1e-2, lr_final=1e-4, max_steps=200_000, warmup_steps=200
    ),
    "fields": OptimizerGroupConfig(
        lr=1e-2, lr_final=1e-4, max_steps=200_000, warmup_steps=200
    ),
    "camera_opt": OptimizerGroupConfig(lr=1e-3, lr_final=1e-4, max_steps=5_000),
}


def exp_decay_schedule(cfg: OptimizerGroupConfig) -> Callable[[int], float]:
    """lr(t) = lr * (lr_final / lr)^(t / max_steps), held at lr for t <= 0
    and bounded by lr_final, after an optional linear warmup from 0 over
    ``warmup_steps`` (optax's ``exponential_decay`` joined to a
    ``linear_schedule``)."""
    rate = cfg.lr_final / cfg.lr
    bound = max if rate < 1.0 else min

    def decay(step: int) -> float:
        if step <= 0 or cfg.max_steps <= 0 or rate == 0.0:  # optax: constant
            return cfg.lr
        return bound(cfg.lr * rate ** (step / cfg.max_steps), cfg.lr_final)

    if cfg.warmup_steps <= 0:
        return decay

    def schedule(step: int) -> float:
        if step < cfg.warmup_steps:
            return cfg.lr * step / cfg.warmup_steps
        return decay(step - cfg.warmup_steps)

    return schedule


def label_params(params: Mapping[str, torch.Tensor]) -> dict[str, str]:
    """Parameter name -> optimizer group: names under ``proposal_*`` ->
    proposal_networks, ``camera_opt`` -> camera_opt, the rest (the field) ->
    fields. A dotted name's first part is the flax tree's top-level key."""

    def label_for(name: str) -> str:
        top = name.split(".")[0]
        if top.startswith("proposal"):
            return "proposal_networks"
        if top == "camera_opt":
            return "camera_opt"
        return "fields"

    return {name: label_for(name) for name in params}


def make_optimizer(
    params: Mapping[str, torch.Tensor],
    groups: Mapping[str, OptimizerGroupConfig] | None = None,
) -> torch.optim.Adam:
    """One Adam over ``params`` (name -> leaf tensor), a param group per
    label in use, in order of first appearance. Each group carries its
    ``name``, its ``config`` and its ``count`` of updates; a label without a
    config gets ``OptimizerGroupConfig()``."""
    groups = dict(groups or DEFAULT_GROUPS)
    members: dict[str, list[torch.Tensor]] = {}
    for name, label in label_params(params).items():
        members.setdefault(label, []).append(params[name])
    if any(groups.get(label, OptimizerGroupConfig()).weight_decay for label in members) and (
        "decoupled_weight_decay" not in inspect.signature(torch.optim.Adam).parameters
    ):
        raise NotImplementedError("AdamW groups need torch.optim.Adam(decoupled_weight_decay=)")
    param_groups = []
    for label, tensors in members.items():
        cfg = groups.get(label, OptimizerGroupConfig())
        group = dict(params=tensors, name=label, config=cfg, count=0,
                     lr=exp_decay_schedule(cfg)(0), eps=cfg.eps)
        if cfg.weight_decay:
            group.update(weight_decay=cfg.weight_decay, decoupled_weight_decay=True)
        param_groups.append(group)
    return torch.optim.Adam(param_groups)


def apply_updates(optimizer: torch.optim.Adam) -> None:
    """One update of every group: lr from the group's schedule at its count,
    Adam's step, then the count advances."""
    for group in optimizer.param_groups:
        group["lr"] = exp_decay_schedule(group["config"])(group["count"])
    optimizer.step()
    for group in optimizer.param_groups:
        group["count"] += 1
