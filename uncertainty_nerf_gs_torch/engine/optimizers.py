"""Per-group optimizers with exponential-decay schedules.

Counterpart of ``uncertainty_nerf_gs_tpu/engine/optimizers.py``. There one
``optax.multi_transform`` holds an Adam (AdamW where a group asks for weight
decay) per group, each with its schedule inside. Here ``make_optimizer``
builds one ``ScheduledAdam`` with a param group per label. Each group keeps
its counts as tensors on the parameters' device, and ``step()`` computes the
group's lr from its schedule at its count of updates made so far (optax's
count) and Adam's bias corrections there, in float32, with no host read: a
training step that holds it can be captured into a CUDA graph and replayed.
The update is optax's, ``lr * m_hat / (sqrt(v_hat) + eps)`` with a
decoupled weight decay where the group has one, in eight foreach passes
over the parameters: the scalars fold into the denominator, as
``torch.optim.Adam(capturable=True)`` folds them. ``exp_decay_schedule`` is the same schedule on the host,
for the splat trainer's per-attribute ``torch.optim.Adam``
(``engine/splat_trainer.py::_apply_updates``).
"""

from __future__ import annotations

import dataclasses
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


def device_schedule(cfg: OptimizerGroupConfig, count: torch.Tensor) -> torch.Tensor:
    """``exp_decay_schedule(cfg)`` at a count held on the device: a float32
    0-dim tensor on ``count``'s device, computed there in optax's float32
    arithmetic."""
    t = count.to(torch.float32)
    rate = cfg.lr_final / cfg.lr

    def decay(t):
        if cfg.max_steps <= 0 or rate == 0.0:  # optax: constant
            return torch.full_like(t, cfg.lr)
        d = cfg.lr * rate ** (t / cfg.max_steps)
        d = torch.clamp(d, min=cfg.lr_final) if rate < 1.0 else torch.clamp(d, max=cfg.lr_final)
        return torch.where(t <= 0, torch.full_like(t, cfg.lr), d)

    if cfg.warmup_steps <= 0:
        return decay(t)
    return torch.where(t < cfg.warmup_steps, cfg.lr * t / cfg.warmup_steps, decay(t - cfg.warmup_steps))


class ScheduledAdam(torch.optim.Optimizer):
    """Adam with a param group per label, each with its own schedule (its
    ``config``) and with its ``count`` (the schedule's) and ``adam_count``
    (the bias corrections') as int64 0-dim tensors on the parameters'
    device. ``state[p]`` holds ``exp_avg`` and ``exp_avg_sq``, zeros from
    the start. A parameter without a gradient is skipped, as
    ``torch.optim.Adam`` skips it."""

    b1, b2 = 0.9, 0.999

    def __init__(self, param_groups: list[dict], moments: Mapping[torch.Tensor, dict] | None = None):
        """``moments``: a parameter's ``{"exp_avg", "exp_avg_sq"}``, zero
        tensors the caller lays out (the ensemble's stacked moments); zeros
        of the parameter's shape where not given."""
        super().__init__(param_groups, {})
        for group in self.param_groups:
            device = group["params"][0].device
            group["count"] = torch.zeros((), dtype=torch.int64, device=device)
            group["adam_count"] = torch.zeros((), dtype=torch.int64, device=device)
            for p in group["params"]:
                given = None if moments is None else moments.get(p)
                self.state[p] = given if given is not None else {
                    "exp_avg": torch.zeros_like(p.detach()), "exp_avg_sq": torch.zeros_like(p.detach())}

    @torch.no_grad()
    def step(self, closure=None):
        b1, b2 = self.b1, self.b2
        for group in self.param_groups:
            cfg = group["config"]
            params = [p for p in group["params"] if p.grad is not None]
            lr = device_schedule(cfg, group["count"])
            group["count"] += 1
            group["adam_count"] += 1
            if not params:
                continue
            grads = [p.grad for p in params]
            mu = [self.state[p]["exp_avg"] for p in params]
            nu = [self.state[p]["exp_avg_sq"] for p in params]
            torch._foreach_lerp_(mu, grads, 1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            if cfg.weight_decay:  # decoupled, as optax's adamw
                torch._foreach_mul_(params, 1.0 - lr * cfg.weight_decay)
            t = group["adam_count"].to(torch.float32)
            # p -= (lr / bc1) * mu / (sqrt(nu) / sqrt(bc2) + eps), with the
            # scalars folded into the denominator: no host read anywhere
            denom = torch._foreach_sqrt(nu)
            torch._foreach_div_(denom, torch.sqrt(1.0 - b2**t))
            torch._foreach_add_(denom, cfg.eps)
            torch._foreach_div_(denom, lr / (1.0 - b1**t))
            torch._foreach_addcdiv_(params, mu, denom, value=-1.0)


def param_groups(
    params: Mapping[str, torch.Tensor],
    groups: Mapping[str, OptimizerGroupConfig] | None = None,
) -> list[dict]:
    """``ScheduledAdam``'s param groups over ``params`` (name -> leaf
    tensor): one a label in use, in order of first appearance, each with its
    ``name`` and its ``config``; a label without a config gets
    ``OptimizerGroupConfig()``."""
    groups = dict(groups or DEFAULT_GROUPS)
    members: dict[str, list[torch.Tensor]] = {}
    for name, label in label_params(params).items():
        members.setdefault(label, []).append(params[name])
    return [dict(params=tensors, name=label, config=groups.get(label, OptimizerGroupConfig()))
            for label, tensors in members.items()]


def make_optimizer(
    params: Mapping[str, torch.Tensor],
    groups: Mapping[str, OptimizerGroupConfig] | None = None,
) -> ScheduledAdam:
    """One ``ScheduledAdam`` over ``params`` with ``param_groups``' groups,
    each carrying its counts."""
    return ScheduledAdam(param_groups(params, groups))


def apply_updates(optimizer: ScheduledAdam) -> None:
    """One update of every group at its scheduled lr; the counts advance."""
    optimizer.step()
