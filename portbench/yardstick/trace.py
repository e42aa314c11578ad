"""One profiled stretch of work, read from ``torch.profiler``'s trace.

``profile(fn, workdir)`` runs ``fn`` under the profiler (CPU and CUDA
activity) inside a marked span, exports the trace, and keeps what the
per-layer readers need: every device operation (kernel, copy or memset)
with its start and length, the host's kernel and graph launches, the span's
length from its start on the host to its last device operation's end, the
union of device activity inside it, and each idle stretch of the device
labelled by the innermost host operation running when it began, and the
host's time in each CUDA runtime call. From the same events it reads the
program's own ``ungs.`` spans (``spans.read_spans``), and, given the
program's counters, the counts that moved across ``fn``. The harness adds
the driver's quantities from the same run's window (``window``).

``device_busy(fn)`` records the device's operations alone, for a whole
window: its busy seconds.
"""

from __future__ import annotations

import bisect
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

from portbench.yardstick import events as ev
from portbench.yardstick.events import SPAN
from portbench.yardstick.spans import Spans, read_spans

_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_LAUNCH = re.compile(r"LaunchKernel|GraphLaunch")


@dataclass
class Trace:
    kind: str  # "train" or "eval"
    units: int  # steps or images profiled
    kernels: list[tuple[str, float, float]]  # (name, start us, length us)
    busy_s: float
    window_s: float
    launches: int
    idle_by_host_op: dict[str, float]
    runtime_ms: dict[str, float] = field(default_factory=dict)  # host ms in each CUDA runtime call
    flops_per_unit: float = 0.0
    peak_flops: float = 0.0
    bound_ms_per_unit: dict[str, float] = field(default_factory=dict)
    spans: Spans = field(default_factory=Spans)  # the program's ``ungs.`` spans in the stretch
    counts: dict[str, int] = field(default_factory=dict)  # the program's counters that moved across it
    window: dict[str, float] = field(default_factory=dict)  # the same run's window: the driver's quantities

    def device_ms(self, pattern: str) -> float:
        """Device milliseconds of the operations whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return 1e-3 * sum(d for n, _, d in self.kernels if rx.search(n))

    def breakdown(self, top: int = 10) -> dict[str, list]:
        by_name: dict[str, float] = {}
        for name, _, dur in self.kernels:
            name = _short(name)
            by_name[name] = by_name.get(name, 0.0) + 1e-6 * dur
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host_op.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:200], s] for n, s in ops], "idle_gaps": [[n[:200], s] for n, s in gaps]}


def _short(name: str) -> str:
    """A kernel's name without namespaces, ``void`` and its argument list."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "std::", "at::cuda::"):
        name = name.replace(noise, "")
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            return name[:i]
    return name


def read_trace(events: list[dict], kind: str, units: int) -> Trace:
    """A Trace from a chrome trace's complete events."""
    start, end, ops = ev.stretch(events)
    device = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0))) for e in ops]
    busy = ev.busy(ops)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"]) for e in events
                  if e.get("cat") in _HOST_CATS and e.get("name") != SPAN and start <= float(e["ts"]) <= end)
    runtime = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver") and start <= float(e["ts"]) <= end]
    launches = sum(1 for e in runtime if _LAUNCH.search(e.get("name", "")))
    runtime_ms: dict[str, float] = {}
    for e in runtime:
        runtime_ms[e["name"]] = runtime_ms.get(e["name"], 0.0) + 1e-3 * float(e.get("dur", 0.0))
    starts = [h[0] for h in host]
    idle: dict[str, float] = {}
    for cursor, a in ev.gaps(busy, start, end):
        i = bisect.bisect_right(starts, cursor) - 1
        label = "(no host operation)"
        for j in range(i, max(i - 2000, -1), -1):
            if host[j][1] >= cursor:
                label = host[j][2]
                break
        idle[label] = idle.get(label, 0.0) + 1e-6 * (a - cursor)
    return Trace(kind=kind, units=units, kernels=device, busy_s=1e-6 * sum(b - a for a, b in busy),
                 window_s=1e-6 * (end - start), launches=launches, idle_by_host_op=idle, runtime_ms=runtime_ms)


def moved(before: dict[str, int], after: dict[str, int]) -> dict[str, int]:
    """The counters that differ between two readings, and by how much."""
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


def profile(fn: Callable[[], None], workdir: Path, kind: str, units: int,
            counters: Callable[[], dict[str, int]] | None = None) -> Trace:
    """``fn`` once under the profiler; its trace read and deleted. ``counters``
    returns the program's cumulative counts; those that moved across ``fn``
    go to the Trace's ``counts``."""
    before = counters() if counters else {}
    events = _events(fn, workdir)
    t = read_trace(events, kind, units)
    t.spans = read_spans(events)
    if counters:
        t.counts = moved(before, counters())
    return t


def device_busy(fn: Callable[[], None]) -> tuple[float, int]:
    """``fn`` once under the profiler's CUDA activity alone (no host
    operators, so the host pays far less than under ``profile``): the
    seconds in which a device operation (kernel, copy or memset) ran, the
    union of their intervals, and how many ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(100)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    ops = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and ev.SENTINEL not in e.name()]
    return 1e-9 * sum(b - a for a, b in ev.union(ops)), len(ops)


def _events(fn: Callable[[], None], workdir: Path) -> list[dict]:
    """The complete events of ``fn`` run once under the profiler in the marked span."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(100)
        torch.cuda.synchronize()
        with record_function(SPAN):
            fn()
            torch.cuda.synchronize()
    workdir.mkdir(parents=True, exist_ok=True)
    path = workdir / "profile.json"
    prof.export_chrome_trace(str(path))
    try:
        return [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    finally:
        path.unlink(missing_ok=True)
