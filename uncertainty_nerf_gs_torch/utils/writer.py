"""Scalar writer, throughput counter and profiler hook.

Counterpart of ``uncertainty_nerf_gs_tpu/utils/writer.py``:

  * :class:`ScalarWriter` — append-only JSONL of {step, name, value, wall}
    records (the same ``events.jsonl`` lines as the JAX package's) and an
    in-memory history.
  * :func:`profile_trace` — context manager around ``torch.profiler`` that
    writes a Chrome trace into ``log_dir``; a no-op when disabled or when
    the profiler cannot start.
  * :class:`Throughput` — rays/sec and fps of one timed render.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path


class ScalarWriter:
    """Append-only JSONL scalar logger."""

    def __init__(self, log_path: Path | str | None = None):
        self.log_path = Path(log_path) if log_path else None
        self.history: dict[str, list[tuple[int, float]]] = defaultdict(list)
        self._t0 = time.perf_counter()
        if self.log_path:
            self.log_path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.log_path, "a")
        else:
            self._fh = None

    def write(self, step: int, scalars: dict[str, float]) -> None:
        wall = time.perf_counter() - self._t0
        for name, value in scalars.items():
            self.history[name].append((step, float(value)))
            if self._fh:
                self._fh.write(
                    json.dumps({"step": step, "name": name, "value": float(value),
                                "wall": round(wall, 3)}) + "\n"
                )
        if self._fh:
            self._fh.flush()

    def latest(self, name: str) -> float | None:
        h = self.history.get(name)
        return h[-1][1] if h else None

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


@contextlib.contextmanager
def profile_trace(log_dir: Path | str, enabled: bool = True):
    """Trace the block with ``torch.profiler`` (host and, on a card, device
    activity) and write ``trace.json`` (Chrome trace format) into
    ``log_dir``."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception:
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            log_dir = Path(log_dir)
            log_dir.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(log_dir / "trace.json"))


class Throughput:
    """rays/sec + fps counter (reference per-image timing semantics)."""

    def __init__(self):
        self._start: float | None = None

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self, num_rays: int, height: int, width: int) -> dict[str, float]:
        dt = time.perf_counter() - (self._start or time.perf_counter())
        dt = max(dt, 1e-9)
        return {
            "num_rays_per_sec": num_rays / dt,
            "fps": num_rays / dt / (height * width),
        }
