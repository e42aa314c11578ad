"""The comparison that decides ``correct``, and its limits.

Training: for each checked step the gap of the program's total loss from the
reference's, relative to the reference's; for each leaf (parameter tensor)
the gap between the norms of the program's and the reference's first
gradient, and of their change over the checked steps, relative to the
reference's norm of that leaf or of the median leaf, whichever is larger;
the worst leaf counts. Leaves whose reference gradient is below a thousandth
of the median leaf's move under Adam by round-off alone and are left out of
the change. Eval: for each output channel the mean absolute gap over the
compared rows, relative to the reference's mean magnitude there; the worst
channel counts.

Each limit lies between the largest reading of sound runs and the smallest
reading of the control (the reference a precision lower in the program's
place) or of a planted fault; PERF.md gives the readings. A driver may
bring ``LIMITS`` of its own for readings of its own names
(``harness.limits``); it may not repeat one of these.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch

LIMITS = {
    "first_loss_gap": 1e-6,
    "grad_gap": 3e-5,
    "update_gap": 5e-2,
    "image_gap": 5e-4,
}


def _median(values) -> float:
    values = sorted(values)
    n = len(values)
    return 0.5 * (values[(n - 1) // 2] + values[n // 2])


def leaf_gap(prog: Mapping[str, float], ref: Mapping[str, float], leaves=None) -> float:
    """max over leaves |prog - ref| / max(ref, median ref)."""
    leaves = list(ref) if leaves is None else list(leaves)
    floor = _median([ref[k] for k in ref])
    worst = 0.0
    for k in leaves:
        if k not in prog:
            return math.inf
        gap = abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def moving_leaves(ref_grad: Mapping[str, float]) -> list[str]:
    floor = 1e-3 * _median(list(ref_grad.values()))
    return [k for k, v in ref_grad.items() if v >= floor]


def train_readings(prog: Mapping, ref: Mapping) -> dict[str, float]:
    """``prog`` and ``ref``: {"losses": [...], "grad": {leaf: norm},
    "change": {leaf: norm}} of one checked stretch."""
    if len(prog["losses"]) != len(ref["losses"]):
        return {"loss_gap": math.inf, "first_loss_gap": math.inf, "grad_gap": math.inf, "update_gap": math.inf}
    steps = [(abs(p - r) / max(abs(r), 1e-12) if math.isfinite(p) else math.inf)
             for p, r in zip(prog["losses"], ref["losses"])]
    return {"loss_gap": max(steps), "first_loss_gap": steps[0], "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
            "update_gap": leaf_gap(prog["change"], ref["change"], moving_leaves(ref["grad"]))}


def worst_leaves(prog: Mapping, ref: Mapping) -> dict[str, str]:
    """The leaf that sets each of ``train_readings``' leaf gaps."""
    out = {}
    for key, leaves in (("grad", list(ref["grad"])), ("change", moving_leaves(ref["grad"]))):
        floor = _median(list(ref[key].values()))
        out[key] = max(leaves, key=lambda k: abs(prog[key].get(k, math.inf) - ref[key][k]) / max(ref[key][k], floor,
                                                                                                    1e-30))
    return out


@torch.no_grad()
def eval_sums(prog: Mapping[str, torch.Tensor], ref: Mapping[str, torch.Tensor]) -> dict[str, list[float]]:
    """Per channel [sum |prog - ref|, sum |ref|] over the rows given; a
    channel the program lacks or gives in another shape counts as all wrong."""
    out = {}
    for k, r in ref.items():
        r = r.detach().double().cpu()
        p = prog.get(k)
        if p is None or tuple(p.shape) != tuple(r.shape):
            out[k] = [math.inf, float(r.abs().sum())]
            continue
        diff = (torch.as_tensor(p).double() - r).abs()
        out[k] = [float(torch.nan_to_num(diff, nan=math.inf).sum()), float(r.abs().sum())]
    return out


def eval_readings(sums: Mapping[str, list[float]]) -> dict[str, float]:
    gap = max((d / max(m, 1e-30) for d, m in sums.values()), default=math.inf)
    return {"image_gap": gap}


def judge(readings: Mapping[str, float], limits: Mapping[str, float] = LIMITS
          ) -> tuple[bool, dict[str, dict[str, float]]]:
    """(correct, {number: {value, limit}}) over the readings that have a limit."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in readings.items() if k in limits}
    ok = bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
