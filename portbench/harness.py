"""Runs one cell of the benchmark: set-up, the measured window, the traced
stretch, the comparison with the reference.

A cell is a configuration (``portbench/configs/<name>.json``) under a
traffic mix (``portbench/traffic/<name>.json``), both found by the names in
``BENCHMARK.json``. The mix names its driver, ``portbench/drivers/<name>.py``:
the loop the window drives and the comparison of what it produced with the
reference. A per-layer metric is a reader ``portbench/metrics/<name>.py``.
So a cell, a configuration, a traffic mix, a driver or a metric is added as
files of its own, and this file stays as it is.

A driver exposes ``KIND`` (what the traced stretch's units are: "train"
steps or "eval" images) and ``drive(cell, seed, seconds, trace_on, device,
t_start, workdir)``, which returns ``attempted``, ``failed``, ``peak`` (the
device's peak bytes, read when the window closed), ``metrics`` (quantity ->
(value, unit)), ``readings`` (the numbers ``yardstick/compare.py`` judges),
``diagnostics`` and, traced, ``trace``; and ``calibrate(cell, seed,
device)``, the readings of the cell's control that the limits are set from.
A driver whose readings have names of their own gives their limits in a
``LIMITS`` dict beside ``compare.LIMITS`` (``limits`` below); a reading
that no limit covers is listed under ``unjudged`` in the diagnostics.
An end-to-end metric ``<quantity>.<variant>`` reports the driver's
``<quantity>``: cells of one driver whose spreads differ get bounds of
their own.

The program under test is ``uncertainty_nerf_gs_torch``, imported only
inside the drivers and the recorders below. Weights, poses and images come
from ``--seed`` through ``portbench/weights.py`` and ``portbench/scene.py``;
the reference under ``portbench/reference`` gets the same, made again,
after the program has been freed.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Callable

import numpy as np
import torch

from portbench.yardstick import bounds, compare, trace

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "uncertainty_nerf_gs_tpu")


def mark(t_start: float, phase: str) -> None:
    """Seconds since the run began, on standard error: where set-up goes."""
    print(f"[portbench] {time.perf_counter() - t_start:8.3f} s  {phase}", file=sys.stderr, flush=True)


# -- cells ---------------------------------------------------------------------


def load_cell(name: str, root: Path = ROOT) -> dict[str, Any]:
    """The cell ``name`` of ``BENCHMARK.json``: its configuration and traffic
    read from their files, and its end-to-end and per-layer metric entries."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[name]
    return make_cell(name, cell["config"], cell["traffic"], cell["chips"], bench, root)


def make_cell(name: str, config: str, traffic: str, chips: int = 1, bench: dict | None = None,
              root: Path = ROOT) -> dict[str, Any]:
    """A cell from the names of its configuration and traffic mix; its
    metrics are those of ``bench`` that list it (none without ``bench``)."""
    bench = bench or {"configs": [], "end_to_end": [], "per_layer": []}
    files = {c["name"]: root / c["file"] for c in bench["configs"]}

    def mine(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return {
        "name": name,
        "chips": chips,
        "config": json.loads(files.get(config, HERE / "configs" / f"{config}.json").read_text()),
        "traffic": json.loads((HERE / "traffic" / f"{traffic}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
    }


def driver(name: str) -> ModuleType:
    """``portbench/drivers/<name>.py``, the loop a traffic mix names."""
    if not name.isidentifier():
        raise ValueError(f"a driver's name is a Python identifier, not {name!r}")
    return importlib.import_module(f"portbench.drivers.{name}")


def limits(drv: ModuleType) -> dict[str, float]:
    """``compare.LIMITS`` with the driver's own ``LIMITS``, which may not
    repeat an accepted name: no driver loosens an accepted limit."""
    own = getattr(drv, "LIMITS", {})
    clash = sorted(set(own) & set(compare.LIMITS))
    if clash:
        raise ValueError(f"{drv.__name__} repeats the accepted limits {clash}")
    return {**compare.LIMITS, **own}


def reader(metric: str) -> Callable[[trace.Trace], float | None]:
    """``portbench/metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    """Each tensor's norm, in float64."""
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def chunk_rays(cams: dict, pose: int, chunk: int, index: int, device):
    """Pixel coordinates of chunk ``index`` of a full image, padded with
    pixel (0, 0) to ``chunk`` rays, as the program's renderers chunk it."""
    h, w = cams["height"], cams["width"]
    start = index * chunk
    pix = torch.arange(start, start + chunk, device=device)
    valid = pix < h * w
    pix = torch.where(valid, pix, torch.zeros_like(pix))
    px, py = (pix % w).to(torch.float32), (pix // w).to(torch.float32)
    cam = torch.full((chunk,), pose, dtype=torch.int64, device=device)
    return cam, px, py, int(valid.sum())


def program_config(model: dict[str, Any]):
    """The configuration's model block as the program's ``NerfactoConfig``."""
    from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig

    kw = dict(model)
    for key in ("num_proposal_samples", "density_dropout_layers", "rgb_dropout_layers"):
        kw[key] = tuple(kw[key])
    kw["proposal_net_args"] = tuple(dict(a) for a in kw["proposal_net_args"])
    if kw.get("aabb") is not None:
        kw["aabb"] = tuple(tuple(r) for r in kw["aabb"])
    return NerfactoConfig(**kw)


def program_cameras(cams: dict):
    from uncertainty_nerf_gs_torch.cameras.cameras import Cameras

    return Cameras(camera_to_worlds=cams["c2w"], fx=cams["focal"], fy=cams["focal"], cx=cams["cx"],
                   cy=cams["cy"], width=cams["width"], height=cams["height"])


def tf32(on: bool) -> None:
    """TF32 products on or off, for matrix products and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def free() -> None:
    """Drops what the caller has deleted and returns the cached blocks; the
    reference that runs next computes its float32 products in float32."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    tf32(False)


def smi(fields: str) -> str | None:
    """``nvidia-smi``'s reading of ``fields`` for the first card."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def launch_counts() -> dict[str, int]:
    """The program's own counts of its hand-written kernels' launches, a
    replayed graph's included."""
    from uncertainty_nerf_gs_torch.ops import backend

    return dict(backend.launch_counts)


def launches_since(before: dict[str, int]) -> dict[str, int]:
    """The launches of each hand-written kernel since ``before``: which of
    them the window ran, and how often."""
    return trace.moved(before, launch_counts())


def program_counts() -> dict[str, int]:
    """The program's work counters (``utils/tracing.py``'s ``counts()``),
    which move only while a profile is active; ``trace.profile`` keeps those
    that moved across its stretch."""
    from uncertainty_nerf_gs_torch.utils import tracing

    return tracing.counts()


# -- recording what the kernels read ---------------------------------------------


class Recorder:
    """Wraps a function of a program module for a while and hands each
    call's arguments to ``on_call`` before the call runs."""

    def __init__(self, module, name: str, on_call: Callable):
        self.module, self.name, self.on_call = module, name, on_call

    def __enter__(self):
        self.original = getattr(self.module, self.name)

        def wrapped(*args, **kwargs):
            self.on_call(*args, **kwargs)
            return self.original(*args, **kwargs)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.original)


def grid_bounds(run: Callable[[], None], backward: bool) -> float:
    """Summed K4 (K5 with ``backward``) bound of the cell lookups ``run``
    makes, from each call's positions."""
    from uncertainty_nerf_gs_torch.ops import encodings

    total = [0.0]

    def on_call(cells, positions, resolutions, table_size, features_per_level=2):
        res = [int(r) for r in np.asarray(resolutions)]
        unique = bounds.distinct_cells(positions.detach(), res, int(table_size))
        total[0] += bounds.grid_bound_ms(positions.shape[0], len(res), features_per_level, unique, backward)

    with torch.no_grad(), Recorder(encodings, "cell_lookup", on_call):
        run()
    return total[0]


def k6_bounds(run: Callable[[], None]) -> float:
    """Summed K6 bound of the packed lookups ``run`` makes."""
    from uncertainty_nerf_gs_torch.parallel import ensemble_fused

    total = [0.0]

    def rows(packed):
        t = packed["tables"] if isinstance(packed, dict) else packed
        return t if isinstance(t, torch.Tensor) else t[0]

    def dense(packed, positions, resolutions, table_size, num_members, features_per_level=2, **_):
        res = [int(r) for r in np.asarray(resolutions)]
        table = rows(packed)
        unique = bounds.distinct_cells(positions, res, int(table_size if np.isscalar(table_size) else table_size[0]))
        n = positions.shape[0]
        total[0] += bounds.k6_bound_ms(n, len(res), num_members, features_per_level, n * len(res), unique,
                                       table.element_size())

    def strided(packed, norm, t_mid, resolutions, table_size, num_members, features_per_level=2, max_stride=8,
                stride_scale=1.0):
        res = [int(r) for r in np.asarray(resolutions)]
        r, s, _ = norm.shape
        size = int(table_size if np.isscalar(table_size) else table_size[0])
        lookups = unique = strided_levels = 0
        for level in res:
            k = int(np.clip(int(stride_scale * s) // (2 * level), 1, max_stride))
            pos = norm.reshape(-1, 3)
            if k > 1:
                idx = torch.clamp(torch.arange((s - 1) // k + 2, device=norm.device) * k, max=s - 1)
                pos = norm[:, idx].reshape(-1, 3)
                strided_levels += 1
            lookups += pos.shape[0]
            unique += bounds.distinct_cells(pos, [level], size)
        total[0] += bounds.k6_bound_ms(r * s, len(res), num_members, features_per_level, lookups, unique,
                                       rows(packed).element_size(), strided_levels)

    with torch.no_grad(), Recorder(ensemble_fused, "packed_cell_lookup", dense), \
            Recorder(ensemble_fused, "packed_cell_lookup_strided", strided):
        run()
    return total[0]


# -- one run -------------------------------------------------------------------


def per_layer(cell: dict, t: trace.Trace) -> dict[str, dict[str, Any]]:
    """The cell's per-layer metrics that its readers find in ``t``."""
    metrics = {}
    for m in cell["per_layer"]:
        value = reader(m["name"])(t)
        if value is not None and np.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def run_cell(cell: dict, seed: int, seconds: float, trace_on: bool, device, t_start: float,
             workdir: Path) -> dict[str, Any]:
    """One run of ``cell``: the result line's fields, and ``checks``."""
    drv = driver(cell["traffic"]["driver"])
    bar = limits(drv)
    out = drv.drive(cell, seed, seconds, trace_on, device, t_start, workdir)
    correct, checks = compare.judge(out["readings"], bar)
    diagnostics = {"readings": out["readings"], "unjudged": sorted(k for k in out["readings"] if k not in bar),
                   **out.get("diagnostics", {})}
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell["chips"],
               "memory_peak_bytes": int(out["peak"]), "power_limit": smi("power.limit")}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    result: dict[str, Any] = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    if trace_on:
        t = out["trace"]
        t.window = {k: v for k, (v, _) in out["metrics"].items()}
        dev.update(busy_s=t.busy_s, window_s=t.window_s)
        result.update(metrics=per_layer(cell, t), device=dev, breakdown=t.breakdown())
    else:
        metrics = {}
        for m in cell["end_to_end"]:
            quantity = m["name"].split(".")[0]
            if quantity in out["metrics"]:
                metrics[m["name"]] = {"value": out["metrics"][quantity][0], "unit": m["unit"]}
        result.update(metrics=metrics, device=dev)
    result["diagnostics"] = diagnostics
    result["checks"] = checks
    return result


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed place inside the checkout (the
    port's own nvcc builds go to ``build/torch_kernels`` beside its package)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / "portbench" / sub)
