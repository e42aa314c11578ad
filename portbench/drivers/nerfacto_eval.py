"""Eval renders of a nerfacto-family model or ensemble: the test poses
rendered one after another at full resolution in chunks of the model's
``eval_num_rays_per_chunk`` rays, each image complete once all of its output
channels are on the host, in pinned buffers that every image reuses. One
model goes through the eval script's ``build_render_fn``; an ensemble
(``members`` in the configuration) through ``build_ensemble_chunk_fn`` with
the fused path and the packed tables the configuration names, under
``_nerfacto_full_image_renderer``.

Quantities: ``eval_image_ms``, the window's wall time over its images;
``eval_device_ms``, where the cell reports it, the device's busy time over
the window's images, from a record of the window's device operations alone
in the untraced runs; ``setup_s``.

After the window, ``check_chunks`` whole chunks drawn from the seed among the
window's images are compared, every output channel, with the reference on
the same seeded weights.

Traffic keys: ``poses``, ``height``, ``width``, ``camera_angle_x``,
``radius``, ``warmup_images``, ``trace_images``, ``check_chunks``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from portbench import harness, scene, weights
from portbench.harness import mark
from portbench.yardstick import compare, flops, peaks, trace

KIND = "eval"


def _renderer(cfg, model_cfg, pcams, seed: int, device) -> tuple[Callable, dict]:
    """The program's eval renderer ``i -> outputs on the device`` with the
    seeded weights, and the weights' shapes: one model as the eval script
    builds it for a run, an ensemble's members stacked as it builds them."""
    from uncertainty_nerf_gs_torch.configs.methods import get_method
    from uncertainty_nerf_gs_torch.engine.trainer import NerfactoTrainer
    from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoModel
    from uncertainty_nerf_gs_torch.scripts.eval_uncertainty import (
        _nerfacto_full_image_renderer,
        build_ensemble_chunk_fn,
        build_render_fn,
    )

    members = cfg.get("members", 1)
    if members == 1:
        trainer = NerfactoTrainer(model_cfg, pcams, use_camera_optimizer=cfg["camera_optimizer"], device=device)
        shapes = {k: tuple(v.shape) for k, v in trainer.params().items()}
        w = weights.draw(shapes, 1, cfg["table_scale"], scene.seed_of(seed, 2), device)
        trainer.restore({"params": {k: v[0] for k, v in w.items()}})
        return build_render_fn(trainer, get_method(cfg["method"]), pcams), shapes
    model = NerfactoModel(model_cfg, device=device)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    stacked = weights.draw(shapes, members, cfg["table_scale"], scene.seed_of(seed, 2), device)
    chunk_fn = build_ensemble_chunk_fn(model, stacked, main_stride_scale=cfg["main_stride_scale"],
                                       table_dtype=cfg["table_dtype"], table_fold=cfg["table_fold"],
                                       ensemble_mode=cfg["ensemble_mode"], table_split=cfg["table_split"])
    return _nerfacto_full_image_renderer(model_cfg, chunk_fn, pcams, device), shapes


def host_copier(device) -> Callable[[dict[str, torch.Tensor]], dict[str, np.ndarray]]:
    """``to_host(outputs)``: every output channel copied to the host and
    waited for, into buffers made at the first call (the warm-up's) and
    reused, pinned on the card. Copies into fresh pageable memory made the
    H100 host's images 5-10 % slower in stretches of about ten, a different
    share in each run."""
    buffers: dict[str, torch.Tensor] = {}

    def to_host(out: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
        for k, v in out.items():
            if k not in buffers:
                buffers[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=v.is_cuda)
            buffers[k].copy_(v, non_blocking=True)
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        return {k: buffers[k].numpy() for k in out}

    return to_host


def drive(cell, seed: int, seconds: float, trace_on: bool, device, t_start: float,
          workdir: Path) -> dict[str, Any]:
    cfg, tr = cell["config"], cell["traffic"]
    members = cfg.get("members", 1)
    model_cfg = harness.program_config(cfg["model"])
    chunk = model_cfg.eval_num_rays_per_chunk
    cams = scene.cameras(tr, tr["poses"], scene.seed_of(seed, 1), device)
    mark(t_start, "program imported, poses made")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    render, shapes = _renderer(cfg, model_cfg, harness.program_cameras(cams), seed, device)
    mark(t_start, "renderer built with the seeded weights")

    h, w_ = cams["height"], cams["width"]
    chunks = -(-(h * w_) // chunk)
    rng = np.random.default_rng(scene.seed_of(seed, 5))
    first_pose = int(rng.integers(tr["poses"]))
    kept_chunk = rng.integers(chunks, size=1 << 16)

    to_host = host_copier(device)

    def host(i: int) -> dict[str, np.ndarray]:
        return to_host(render((first_pose + i) % tr["poses"]))

    def image(i: int) -> tuple[int, int, dict[str, np.ndarray]]:
        """Image i of the run on the host, and the rows of its chunk that
        the comparison may take; the warm-up runs the same."""
        out = host(i)
        c = int(kept_chunk[i])
        rows = slice(c * chunk, min((c + 1) * chunk, h * w_))
        return (first_pose + i) % tr["poses"], c, {k: v.reshape((h * w_,) + v.shape[2:])[rows].copy()
                                                   for k, v in out.items()}

    # where the cell reports the device's time an image, an untraced run records the window's device operations
    busy_window = not trace_on and device.type == "cuda" and any(
        m["name"].split(".")[0] == "eval_device_ms" for m in cell["end_to_end"])
    warm_at = [time.perf_counter()]
    for i in range(tr["warmup_images"]):
        image(i)
        warm_at.append(time.perf_counter())
    if busy_window:
        trace.device_busy(lambda: None)  # the profiler's first start, in set-up
    mark(t_start, "warm-up images rendered")
    counted = harness.launch_counts()
    kept, done_at, t0 = [], [], []

    def window() -> None:
        t0.append(time.perf_counter())
        while True:
            kept.append(image(tr["warmup_images"] + len(kept)))
            done_at.append(time.perf_counter())
            if done_at[-1] - t0[0] >= seconds:
                break

    busy_s = device_ops = None
    if busy_window:
        busy_s, device_ops = trace.device_busy(window)
    else:
        window()
    t0 = t0[0]
    setup_s = t0 - t_start
    images = len(kept)
    window_s = done_at[-1] - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    counted = harness.launches_since(counted)
    mark(t_start, "window closed")
    metrics = {"eval_image_ms": (1e3 * window_s / images, "ms/image"), "setup_s": (setup_s, "s")}
    if busy_window:
        metrics["eval_device_ms"] = (1e3 * busy_s / images, "ms/image")
    result = {"attempted": images, "failed": 0, "peak": peak, "metrics": metrics,
              "diagnostics": {"image_ms": [round(1e3 * (b - a), 3) for a, b in zip([t0] + done_at, done_at)],
                              "warmup_ms": [round(1e3 * (b - a), 3) for a, b in zip(warm_at, warm_at[1:])],
                              "poses": [p for p, _, _ in kept], "kernel_launches": counted,
                              "device_ops": device_ops}}

    if trace_on:
        units = tr["trace_images"]
        base = tr["warmup_images"] + images
        t = trace.profile(lambda: [host(base + i) for i in range(units)], workdir, KIND, units,
                          counters=harness.program_counts)
        t.flops_per_unit = chunks * chunk * flops.forward_flops_per_ray(cfg["model"], members)
        t.peak_flops = peaks.matmul_peak(torch.backends.cuda.matmul.allow_tf32)
        poses = [(first_pose + base + i) % tr["poses"] for i in range(units)]
        if members == 1:
            t.bound_ms_per_unit["cell_lookup_fwd"] = harness.grid_bounds(lambda: [render(p) for p in poses],
                                                                         False) / units
        else:
            t.bound_ms_per_unit["packed_cell_lookup"] = harness.k6_bounds(lambda: [render(p) for p in poses]) / units
        result["trace"] = t

    del render, host
    harness.free()
    result["readings"] = compare.eval_readings(reference(cell, seed, cams, kept, shapes, device))
    mark(t_start, "reference compared")
    return result


@torch.no_grad()
def reference(cell, seed: int, cams: dict, kept: list, shapes: dict, device) -> dict[str, list[float]]:
    """The reference's outputs for the compared chunks, and the per-channel
    sums of the program's gaps from them."""
    from portbench.reference import ensemble as ref_ensemble
    from portbench.reference import nerfacto as ref

    cfg, tr = cell["config"], cell["traffic"]
    members = cfg.get("members", 1)
    chunk = cfg["model"]["eval_num_rays_per_chunk"]
    pick = np.random.default_rng(scene.seed_of(seed, 6)).permutation(len(kept))[:tr["check_chunks"]]
    w = weights.draw(shapes, members, cfg["table_scale"], scene.seed_of(seed, 2), device)
    if members == 1:
        params = {k: v[0] for k, v in w.items()}
    else:
        packed = ref_ensemble.pack_ensemble(w, cfg["model"])
    sums: dict[str, list[float]] = {}
    for i in pick:
        pose, c, prog = kept[int(i)]
        cam, px, py, valid = harness.chunk_rays(cams, pose, chunk, c, device)
        origins, dirs = ref.rays(cams["c2w"], cams["focal"], cams["cx"], cams["cy"], cam, px, py)
        if members == 1:
            out = ref.forward(params, cfg["model"], origins, dirs, cam)
            out.pop("density_mean")
        else:
            out = ref_ensemble.render_chunk(w, packed, cfg["model"], origins, dirs)
        part = compare.eval_sums({k: torch.from_numpy(v) for k, v in prog.items()},
                                 {k: v[:valid] for k, v in out.items()})
        for k, (d, m) in part.items():
            acc = sums.setdefault(k, [0.0, 0.0])
            acc[0] += d
            acc[1] += m
    return sums


def calibrate(cell, seed: int, device) -> list[dict]:
    """The control's readings. One model: the reference with TF32 products
    against the reference in float32, on ``check_chunks`` chunks drawn from
    the seed. An ensemble: the program with its int8 tables (its own path one
    precision below bf16), run and compared as a run is."""
    from portbench.drivers import nerfacto_train
    from portbench.reference import nerfacto as ref

    cfg, tr = cell["config"], cell["traffic"]
    if cfg.get("members", 1) > 1:
        cell = dict(cell, config=dict(cfg, table_dtype="int8"))
        out = drive(cell, seed, 2.0, False, device, time.perf_counter(), Path("."))
        return [{"reading": "control_int8_tables", **out["readings"]}]
    cams = scene.cameras(tr, tr["poses"], scene.seed_of(seed, 1), device)
    shapes = nerfacto_train.leaf_shapes(cfg, tr["poses"])
    params = {k: v[0] for k, v in weights.draw(shapes, 1, cfg["table_scale"], scene.seed_of(seed, 2), device).items()}
    chunk = cfg["model"]["eval_num_rays_per_chunk"]
    chunks = -(-(tr["height"] * tr["width"]) // chunk)
    rng = np.random.default_rng(scene.seed_of(seed, 7))
    sums: dict[str, list[float]] = {}
    t0 = time.perf_counter()
    for _ in range(tr["check_chunks"]):
        cam, px, py, valid = harness.chunk_rays(cams, int(rng.integers(tr["poses"])), chunk,
                                                int(rng.integers(chunks)), device)
        origins, dirs = ref.rays(cams["c2w"], cams["focal"], cams["cx"], cams["cy"], cam, px, py)
        with torch.no_grad():
            base = ref.forward(params, cfg["model"], origins, dirs, cam)
            harness.tf32(True)
            try:
                low = ref.forward(params, cfg["model"], origins, dirs, cam)
            finally:
                harness.tf32(False)
        base.pop("density_mean")
        low.pop("density_mean")
        for k, (d, m) in compare.eval_sums({k: v[:valid].cpu() for k, v in low.items()},
                                           {k: v[:valid] for k, v in base.items()}).items():
            acc = sums.setdefault(k, [0.0, 0.0])
            acc[0] += d
            acc[1] += m
    seconds = time.perf_counter() - t0
    return [{"reading": "control_tf32", **compare.eval_readings(sums),
             "channels": {k: d / m for k, (d, m) in sums.items()}},
            {"reading": "reference_seconds_twice", "value": seconds}]

