"""Readings that set the limits of ``yardstick/compare.py``: each cell's
control (and, for training, a planted fault) at the cell's own size, on
several seeds. Each driver's ``calibrate`` says what it reads.

    python3 -m portbench.calibrate --workload <cell> --seeds <n> [<n> ...]
    python3 -m portbench.calibrate --config <name> --traffic <name> --seeds <n> ...

The second form takes a configuration and a traffic mix by their file
names, whether or not a cell of ``BENCHMARK.json`` pairs them. Prints one
JSON line a seed and reading, with ``correct`` where the reading has
numbers that the run's limits (``compare.LIMITS`` and the driver's own,
``harness.limits``) judge: a control has to read false. The benchmark's
runs never run this; the numbers go to PERF.md beside the limits set from
them.
"""

from __future__ import annotations

import argparse
import json

import torch

from portbench import harness
from portbench.yardstick import compare


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--config")
    ap.add_argument("--traffic")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if bool(args.workload) == bool(args.config and args.traffic):
        ap.error("give --workload, or --config and --traffic")
    harness.set_cache_dirs()
    if args.workload:
        cell = harness.load_cell(args.workload)
    else:
        cell = harness.make_cell(f"{args.config}.{args.traffic}", args.config, args.traffic)
    device = torch.device("cuda", 0)
    drv = harness.driver(cell["traffic"]["driver"])
    bar = harness.limits(drv)
    for seed in args.seeds:
        for line in drv.calibrate(cell, seed, device):
            ok, checks = compare.judge(line, bar)
            judged = {"correct": ok} if checks else {}
            print(json.dumps({"workload": cell["name"], "seed": seed, **line, **judged}), flush=True)
        harness.free()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
