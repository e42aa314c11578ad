"""The profiled stretch in a chrome trace's complete events, as
``trace.read_trace`` and ``spans.read_spans`` both read it: from the start of
the marked span to the later of its end and its last device operation's end,
with the device operations inside it, their busy intervals and the idle gaps
between them."""

from __future__ import annotations

from typing import Iterator

SPAN = "portbench.profiled"
SENTINEL = "spin_kernel"  # a short kernel first: the profiler may drop its first device kernel
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def stretch(events: list[dict]) -> tuple[float, float, list[dict]]:
    """(start, end, device operations) of the marked span, in microseconds."""
    marked = [e for e in events if e.get("name") == SPAN and e.get("cat") == "user_annotation"]
    if not marked:
        raise RuntimeError("the profiled span is missing from the trace")
    start = float(marked[0]["ts"])
    device = [e for e in events
              if e.get("cat") in DEVICE_CATS and SENTINEL not in e.get("name", "") and float(e["ts"]) >= start]
    end = max([start + float(marked[0]["dur"])] + [float(e["ts"]) + float(e.get("dur", 0.0)) for e in device])
    return start, end, device


def busy(device: list[dict]) -> list[tuple[float, float]]:
    """The union of the operations' intervals."""
    return union([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in device])


def gaps(busy: list[tuple[float, float]], start: float, end: float) -> Iterator[tuple[float, float]]:
    """The idle stretches between ``start``, the busy intervals and ``end``."""
    cursor = start
    for a, b in busy + [(end, end)]:
        if a > cursor:
            yield cursor, a
        cursor = max(cursor, b)
