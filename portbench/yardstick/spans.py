"""The program's own spans in a profiled stretch.

The port marks its layer boundaries with profiler ranges whose names start
with ``ungs.`` (``uncertainty_nerf_gs_torch/utils/tracing.py``); the
profiler writes them as ``user_annotation`` events beside the device's
operations, on the same clock. ``read_spans`` reads them from the same
chrome-trace events and over the same window as ``trace.read_trace`` (the
marked span to its last device operation), with the same idle gaps:

* ``count[name]``, ``host_s[name]``: how many spans of each name, and
  their summed host durations;
* ``idle_s[name]``: the idle seconds of the gaps whose start lies inside at
  least one span of that name. A gap counts for every enclosing span, and a
  gap outside every ``ungs.`` span goes under ``"(outside)"``;
* ``device_s[name]``: the device seconds of the operations whose launching
  runtime call began inside a span of that name, matched by the
  ``correlation`` id that the operation and its call both carry. A replayed
  graph's kernels match its ``cudaGraphLaunch``.

A trace of a program without spans gives empty counts, and ``"(outside)"``
holds the whole idle time.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from portbench.yardstick.trace import _DEVICE_CATS, _SENTINEL, SPAN, _union

PREFIX = "ungs."
OUTSIDE = "(outside)"


@dataclass
class Spans:
    count: dict[str, int] = field(default_factory=dict)
    host_s: dict[str, float] = field(default_factory=dict)
    idle_s: dict[str, float] = field(default_factory=dict)
    device_s: dict[str, float] = field(default_factory=dict)


class _Cover:
    """The union of one name's spans, for point queries."""

    def __init__(self, intervals: list[tuple[float, float]]):
        self.parts = _union(intervals)
        self.starts = [a for a, _ in self.parts]

    def holds(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.parts[i][1]


def read_spans(events: list[dict]) -> Spans:
    """The ``ungs.`` spans of a chrome trace's complete events."""
    marked = [e for e in events if e.get("name") == SPAN and e.get("cat") == "user_annotation"]
    if not marked:
        raise RuntimeError("the profiled span is missing from the trace")
    start = float(marked[0]["ts"])
    device = [e for e in events
              if e.get("cat") in _DEVICE_CATS and _SENTINEL not in e.get("name", "") and float(e["ts"]) >= start]
    end = max([start + float(marked[0]["dur"])] + [float(e["ts"]) + float(e.get("dur", 0.0)) for e in device])
    out = Spans()
    intervals: dict[str, list[tuple[float, float]]] = {}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name.startswith(PREFIX) and start <= float(e["ts"]) <= end:
            a = float(e["ts"])
            intervals.setdefault(name, []).append((a, a + float(e.get("dur", 0.0))))
            out.count[name] = out.count.get(name, 0) + 1
            out.host_s[name] = out.host_s.get(name, 0.0) + 1e-6 * float(e.get("dur", 0.0))
    covers = {name: _Cover(iv) for name, iv in intervals.items()}

    cursor = start
    for a, b in _union([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in device]) + [(end, end)]:
        if a > cursor:
            inside = [name for name, c in covers.items() if c.holds(cursor)] or [OUTSIDE]
            for name in inside:
                out.idle_s[name] = out.idle_s.get(name, 0.0) + 1e-6 * (a - cursor)
        cursor = max(cursor, b)

    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    for e in device:
        at = launched.get(e.get("args", {}).get("correlation"))
        if at is None:
            continue
        for name, c in covers.items():
            if c.holds(at):
                out.device_s[name] = out.device_s.get(name, 0.0) + 1e-6 * float(e.get("dur", 0.0))
    return out
