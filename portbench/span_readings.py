"""The program's spans in a cell's traced stretch, and what tracing costs.

    python3 -m portbench.span_readings --workload <cell> --seed <n> [--seconds <s>]
    python3 -m portbench.span_readings --cost --seed <n> [--turns <k>]

The first runs the cell as ``--trace 1`` does and prints one JSON line: its
per-layer metrics (the readers under ``metrics/``, the span metrics among
them), the device's busy and idle time a unit, the counters that moved
across the profiled stretch, and ``yardstick/spans.py``'s readings of it
(each ``ungs.`` span's count, and its host, idle and device milliseconds a
unit).

``--cost`` times an empty span with no profile active and under a
running profiler; then it builds each cell's renderer or trainer at full
size and profiles its traced stretch (3 images, 2 launches) as the
benchmark does, with the program's spans on and with them replaced by the
null context, in turns (on, off, off, on), ``--turns`` times: the wall
time a unit, the device's idle share, and the host time the spans' own
enter and exit took.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

from portbench import harness, scene
from portbench.yardstick import compare, trace

SPAN_MODULES = ("uncertainty_nerf_gs_torch.scripts.eval_uncertainty", "uncertainty_nerf_gs_torch.models.nerfacto",
                "uncertainty_nerf_gs_torch.parallel.ensemble_fused", "uncertainty_nerf_gs_torch.engine.trainer",
                "uncertainty_nerf_gs_torch.ops.backend")


def readings(workload: str, seed: int, seconds: float) -> dict:
    cell = harness.load_cell(workload)
    drv = harness.driver(cell["traffic"]["driver"])
    with tempfile.TemporaryDirectory(prefix="span-readings-") as work:
        out = drv.drive(cell, seed, seconds, True, torch.device("cuda", 0), time.perf_counter(), Path(work))
    t = out["trace"]
    units, s = t.units, t.spans
    per_unit = {k: {n: 1e3 * v / units for n, v in d.items()}
                for k, d in (("host_ms", s.host_s), ("idle_ms", s.idle_s), ("device_ms", s.device_s))}
    return {"workload": workload, "seed": seed, "correct": compare.judge(out["readings"], harness.limits(drv))[0],
            "units": units, "metrics": {k: v["value"] for k, v in harness.per_layer(cell, t).items()},
            "busy_ms": 1e3 * t.busy_s / units, "idle_ms": 1e3 * (t.window_s - t.busy_s) / units,
            "counts": t.counts, "span_count": s.count, **per_unit, "card": harness.smi("name,power.limit")}


@contextlib.contextmanager
def spans_off():
    """The program's ``span`` replaced by the null context in each module
    that calls it."""
    import importlib

    modules = [importlib.import_module(m) for m in SPAN_MODULES]
    kept = [m.span for m in modules]
    for m in modules:
        m.span = lambda name, **counters: contextlib.nullcontext()
    try:
        yield
    finally:
        for m, s in zip(modules, kept):
            m.span = s


@contextlib.contextmanager
def span_clock():
    """Adds the host seconds spent entering and leaving each span to the
    yielded list's one entry."""
    from uncertainty_nerf_gs_torch.utils import tracing

    spent = [0.0]
    enter, leave = tracing._Span.__enter__, tracing._Span.__exit__

    def timed_enter(self):
        t0 = time.perf_counter()
        enter(self)
        spent[0] += time.perf_counter() - t0

    def timed_exit(self, *exc):
        t0 = time.perf_counter()
        out = leave(self, *exc)
        spent[0] += time.perf_counter() - t0
        return out

    tracing._Span.__enter__, tracing._Span.__exit__ = timed_enter, timed_exit
    try:
        yield spent
    finally:
        tracing._Span.__enter__, tracing._Span.__exit__ = enter, leave


def span_us(n: int = 100_000) -> dict[str, float]:
    """Microseconds an empty span takes, with no profile active and under a
    running profiler."""
    from torch.profiler import ProfilerActivity, profile

    from uncertainty_nerf_gs_torch.utils.tracing import span

    def loop(k):
        t0 = time.perf_counter()
        for _ in range(k):
            with span("ungs.cost"):
                pass
        return 1e6 * (time.perf_counter() - t0) / k

    off = loop(n)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = loop(n // 10)
    return {"off": off, "on": on}


def _turns(fn, units: int, kind: str, turns: int, workdir: Path) -> dict:
    """``fn`` profiled as the benchmark's traced stretch is, with the spans on
    and off in turns (on, off, off, on): each profile's wall milliseconds a
    unit, the device's idle share, and with the spans on the host
    milliseconds a unit spent in their enter and exit."""
    runs: dict[str, list] = {"on": [], "off": []}

    def one(side):
        with contextlib.ExitStack() as stack:
            spent = stack.enter_context(span_clock())
            if side == "off":
                stack.enter_context(spans_off())
            t = trace.profile(fn, workdir, kind, units)
        runs[side].append((1e3 * t.window_s / units, 100.0 * (1.0 - t.busy_s / t.window_s), 1e3 * spent[0] / units))

    for _ in range(turns):
        for side in ("on", "off", "off", "on"):
            one(side)
    med = {side: [statistics.median(r[i] for r in rs) for i in range(3)] for side, rs in runs.items()}
    return {"runs": runs, "wall_ms_median": {k: v[0] for k, v in med.items()},
            "idle_share_median": {k: v[1] for k, v in med.items()}, "span_host_ms_median": med["on"][2]}


def cost(seed: int, turns: int) -> dict:
    from portbench.drivers import nerfacto_eval, nerfacto_train
    from uncertainty_nerf_gs_torch.engine.optimizers import OptimizerGroupConfig
    from uncertainty_nerf_gs_torch.engine.trainer import NerfactoTrainer

    device = torch.device("cuda", 0)
    out = {"seed": seed, "card": harness.smi("name,power.limit"), "span_us": span_us()}
    work = Path(tempfile.mkdtemp(prefix="span-cost-"))

    for name in ("nerfacto-eval", "ensemble5-eval"):
        cell = harness.load_cell(name)
        cfg, tr = cell["config"], cell["traffic"]
        cams = scene.cameras(tr, tr["poses"], scene.seed_of(seed, 1), device)
        render, _ = nerfacto_eval._renderer(cfg, harness.program_config(cfg["model"]),
                                            harness.program_cameras(cams), seed, device)

        def images():
            for i in range(tr["trace_images"]):
                {k: v.cpu().numpy() for k, v in render(i).items()}

        images()
        out[name] = _turns(images, tr["trace_images"], "eval", turns, work)
        del render
        harness.free()

    cell = harness.load_cell("nerfacto-train")
    cfg, tr = cell["config"], cell["traffic"]
    sc = nerfacto_train.training_views(tr, seed, device)
    groups = {k: OptimizerGroupConfig(**v) for k, v in cfg["optimizer"].items()}
    trainer = NerfactoTrainer(harness.program_config(cfg["model"]), harness.program_cameras(sc),
                              images=sc["images"].cpu().numpy(), use_camera_optimizer=cfg["camera_optimizer"],
                              optimizer_groups=groups, device=device)
    shapes = {k: tuple(v.shape) for k, v in trainer.params().items()}
    w0, gen_state = nerfacto_train.seeded_start(cell, shapes, seed, device)
    trainer.restore({"params": w0, "generator": gen_state})
    per_launch, rays = tr["steps_per_launch"], tr["rays_per_step"]
    units = tr["trace_launches"] * per_launch

    def launches():
        trainer.train(units, rays, steps_per_launch=per_launch)

    launches()
    out["nerfacto-train"] = _turns(launches, units, "train", turns, work)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--cost", action="store_true")
    ap.add_argument("--turns", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_readings: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    harness.set_cache_dirs()
    torch.set_num_threads(2)
    out = cost(args.seed, args.turns) if args.cost else readings(args.workload, args.seed, args.seconds)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
