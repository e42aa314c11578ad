"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's cards. Prints
as its last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit;
the same numbers are the last lines of standard error. Exits with 2 and no
result without the cards, and with 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402


def _finite(x):
    """JSON has no infinity: a number that is not finite is written as a string."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def loaded_forbidden(forbidden) -> list[str]:
    """Top-level names of loaded modules that are in ``forbidden``, compared
    whole: ``uncertainty_nerf_gs_torch`` is not ``uncertainty_nerf_gs_tpu``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(forbidden))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    harness.mark(T_START, "torch imported")
    harness.set_cache_dirs()
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s), found {found}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    torch.zeros(1, device="cuda")
    harness.mark(T_START, "card initialised")
    with tempfile.TemporaryDirectory(prefix="portbench-") as work:
        result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                                  T_START, Path(work))
    bad = loaded_forbidden(harness.FORBIDDEN)
    if bad:
        print(f"portbench: modules loaded that the port must not load: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"diagnostics: {json.dumps(_finite(result.pop('diagnostics')))}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
