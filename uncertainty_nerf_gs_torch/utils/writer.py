"""Scalar writer.

Counterpart of ``uncertainty_nerf_gs_tpu/utils/writer.py``'s
:class:`ScalarWriter`: append-only JSONL of {step, name, value, wall}
records (the same ``events.jsonl`` lines as the JAX package's) and an
in-memory history. The port's profiler hook is ``utils/tracing.py``'s
``profile``.
"""

from __future__ import annotations

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
