"""One profiled stretch of work, read from ``torch.profiler``'s trace.

``profile(fn, workdir)`` runs ``fn`` under the profiler (CPU and CUDA
activity) inside a marked span, exports the trace, and keeps what the
per-layer readers need: every device operation (kernel, copy or memset)
with its start and length, the host's kernel and graph launches, the span's
length from its start on the host to its last device operation's end, the
union of device activity inside it, and each idle stretch of the device
labelled by the innermost host operation running when it began, and the
host's time in each CUDA runtime call.
"""

from __future__ import annotations

import bisect
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

SPAN = "portbench.profiled"
_SENTINEL = "spin_kernel"  # a short kernel first: the profiler may drop its first device kernel
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
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


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read_trace(events: list[dict], kind: str, units: int) -> Trace:
    """A Trace from a chrome trace's complete events."""
    spans = [e for e in events if e.get("name") == SPAN and e.get("cat") == "user_annotation"]
    if not spans:
        raise RuntimeError("the profiled span is missing from the trace")
    start = float(spans[0]["ts"])
    span_end = start + float(spans[0]["dur"])
    device = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0))) for e in events
              if e.get("cat") in _DEVICE_CATS and _SENTINEL not in e.get("name", "") and float(e["ts"]) >= start]
    end = max([span_end] + [t + d for _, t, d in device])
    busy = _union([(t, t + d) for _, t, d in device])
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"]) for e in events
                  if e.get("cat") in _HOST_CATS and e.get("name") != SPAN and start <= float(e["ts"]) <= end)
    runtime = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver") and start <= float(e["ts"]) <= end]
    launches = sum(1 for e in runtime if _LAUNCH.search(e.get("name", "")))
    runtime_ms: dict[str, float] = {}
    for e in runtime:
        runtime_ms[e["name"]] = runtime_ms.get(e["name"], 0.0) + 1e-3 * float(e.get("dur", 0.0))
    starts = [h[0] for h in host]
    idle: dict[str, float] = {}
    cursor = start
    for a, b in busy + [(end, end)]:
        if a > cursor:
            i = bisect.bisect_right(starts, cursor) - 1
            label = "(no host operation)"
            for j in range(i, max(i - 2000, -1), -1):
                if host[j][1] >= cursor:
                    label = host[j][2]
                    break
            idle[label] = idle.get(label, 0.0) + 1e-6 * (a - cursor)
        cursor = max(cursor, b)
    return Trace(kind=kind, units=units, kernels=device, busy_s=1e-6 * sum(b - a for a, b in busy),
                 window_s=1e-6 * (end - start), launches=launches, idle_by_host_op=idle, runtime_ms=runtime_ms)


def profile(fn: Callable[[], None], workdir: Path, kind: str, units: int) -> Trace:
    """``fn`` once under the profiler; its trace read and deleted."""
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
        events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    finally:
        path.unlink(missing_ok=True)
    return read_trace(events, kind, units)
