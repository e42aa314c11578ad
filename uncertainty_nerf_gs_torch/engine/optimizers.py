"""Per-group learning-rate schedules.

Counterpart of ``OptimizerGroupConfig`` and ``exp_decay_schedule`` in
``uncertainty_nerf_gs_tpu/engine/optimizers.py``. There a schedule is an
optax schedule inside the optimizer; here it is a function of the step that
the trainer reads before each ``torch.optim.Adam`` step, setting the
group's lr. Both evaluate the schedule at the count of updates made so far.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class OptimizerGroupConfig:
    lr: float = 1e-2
    eps: float = 1e-15
    lr_final: float = 1e-4
    max_steps: int = 200_000
    weight_decay: float = 0.0
    warmup_steps: int = 0


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
