"""Training a nerfacto-family model: closed-loop launches of
``steps_per_launch`` steps of ``rays_per_step`` rays each through
``NerfactoTrainer.train``, each launch ending in the trainer's own host read
of its losses, on the ``views`` training views of the scene.

Set-up builds one trainer with the seeded weights and drives its first
``check_steps`` steps through the window's own call: the trainer's eager
warm-up steps, the capture of the step into a CUDA graph and replays of that
graph, which the window then times. The reference follows those steps from
the same seeded weights and generator state; each step's loss, the first
step's gradient (as Adam's first moment holds it) and each leaf's change
over the stretch are compared.

Traffic keys: ``rays_per_step``, ``steps_per_launch``, ``check_steps``,
``warmup_launches``, ``trace_launches`` and the ``scene`` (``height``,
``width``, ``camera_angle_x``, ``radius``, ``views``, ``gt_samples``).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any

import torch

from portbench import harness, scene, weights
from portbench.harness import mark
from portbench.yardstick import compare, flops, peaks, trace

KIND = "train"


def training_views(traffic: dict, seed: int, device) -> dict[str, Any]:
    """The scene's cameras and ground-truth images from the seed."""
    sc = traffic["scene"]
    cams = scene.cameras(sc, sc["views"], scene.seed_of(seed, 1), device)
    cams["images"] = scene.render_views(cams, sc["gt_samples"])
    return cams


def seeded_start(cell: dict, shapes: dict, seed: int, device) -> tuple[dict, torch.Tensor]:
    """The seeded weights of a trainer with leaves ``shapes``, and the state
    of the generator its batches and draws start from."""
    cfg = cell["config"]
    w0 = {k: v[0] for k, v in weights.draw(shapes, 1, cfg["table_scale"], scene.seed_of(seed, 2), device).items()}
    return w0, torch.Generator(device=device).manual_seed(scene.seed_of(seed, 3)).get_state()


def checked_stretch(trainer, cell: dict, start_params: dict) -> dict[str, Any]:
    """The trainer's next ``check_steps`` steps as one call of the window's
    ``train``: each step's loss, the first step's gradient as Adam's moments
    give it after that step, and each leaf's change over the stretch."""
    from uncertainty_nerf_gs_torch.engine.optimizers import ScheduledAdam

    tr = cell["traffic"]
    before = {k: v.clone() for k, v in trainer.state_dict()["opt_state"]["exp_avg"].items()}
    after: dict[str, torch.Tensor] = {}
    step = trainer._device_step

    def first_step_read(num_rays):
        out = step(num_rays)
        if not after:  # the first step runs eagerly, before any capture
            after.update({k: v.clone() for k, v in trainer.state_dict()["opt_state"]["exp_avg"].items()})
        return out

    losses = []
    trainer._device_step = first_step_read
    try:
        trainer.train(tr["check_steps"], tr["rays_per_step"], steps_per_launch=tr["steps_per_launch"],
                      callback=lambda i, row: losses.append(row["total_loss"]))
    finally:
        del trainer._device_step
    b1 = ScheduledAdam.b1
    grad = harness.norms({k: (after[k] - before[k]) / (1.0 - b1) + before[k] for k in after})
    change = harness.norms({k: v - start_params[k] for k, v in trainer.state_dict()["params"].items()})
    return {"losses": losses, "grad": grad, "change": change}


def drive(cell, seed: int, seconds: float, trace_on: bool, device, t_start: float,
          workdir: Path) -> dict[str, Any]:
    from uncertainty_nerf_gs_torch.engine.optimizers import OptimizerGroupConfig
    from uncertainty_nerf_gs_torch.engine.trainer import WARMUP_STEPS, NerfactoTrainer

    from portbench.reference import nerfacto as ref

    cfg, tr = cell["config"], cell["traffic"]
    rays, per_launch = tr["rays_per_step"], tr["steps_per_launch"]
    replays = tr["check_steps"] - WARMUP_STEPS
    if device.type == "cuda" and not 0 < replays < per_launch:
        raise ValueError(f"check_steps must run the captured step: more than {WARMUP_STEPS}, fewer than a launch")
    mark(t_start, "program imported")
    sc = training_views(tr, seed, device)
    mark(t_start, "scene rendered")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    groups = {k: OptimizerGroupConfig(**v) for k, v in cfg["optimizer"].items()}
    trainer = NerfactoTrainer(harness.program_config(cfg["model"]), harness.program_cameras(sc),
                              images=sc["images"].cpu().numpy(), use_camera_optimizer=cfg["camera_optimizer"],
                              optimizer_groups=groups, device=device)
    mark(t_start, "trainer built")
    shapes = {k: tuple(v.shape) for k, v in trainer.params().items()}
    w0, gen_state = seeded_start(cell, shapes, seed, device)
    trainer.restore({"params": w0, "generator": gen_state})
    mark(t_start, "seeded weights restored")
    checked = checked_stretch(trainer, cell, w0)
    del w0
    mark(t_start, "checked steps run (the step captured)")
    trainer.train(tr["warmup_launches"] * per_launch, rays, steps_per_launch=per_launch)
    mark(t_start, "warm-up launches run")

    counted = harness.launch_counts()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    steps, done_at = 0, []
    while True:
        trainer.train(per_launch, rays, steps_per_launch=per_launch)
        done_at.append(time.perf_counter())
        steps += per_launch
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    counted = harness.launches_since(counted)
    mark(t_start, "window closed")

    out = {"attempted": steps, "failed": 0, "peak": peak,
           "metrics": {"train_step_ms": (1e3 * window_s / steps, "ms/step"), "setup_s": (setup_s, "s")}}
    if trace_on:
        units = tr["trace_launches"] * per_launch
        t = trace.profile(lambda: trainer.train(units, rays, steps_per_launch=per_launch), workdir, KIND, units,
                          counters=harness.program_counts)
        t.flops_per_unit = 3.0 * rays * flops.forward_flops_per_ray(cfg["model"])
        t.peak_flops = peaks.matmul_peak(torch.backends.cuda.matmul.allow_tf32)
        bgen = torch.Generator(device=device).manual_seed(scene.seed_of(seed, 4))

        def one_forward():
            from uncertainty_nerf_gs_torch.cameras.cameras import generate_rays
            from uncertainty_nerf_gs_torch.models.nerfacto import proposal_anneal_factor

            b = trainer.sample_batch(rays, generator=bgen)
            rb = generate_rays(trainer.cameras, b["camera_indices"], b["pixel_x"], b["pixel_y"],
                               pose_adjustment=trainer.camera_opt)
            trainer.model(rb, train=True, draws=trainer.model.draw(rays, bgen),
                          proposal_anneal=proposal_anneal_factor(trainer.step, trainer.config))

        t.bound_ms_per_unit["cell_lookup_bwd"] = harness.grid_bounds(one_forward, backward=True)
        out["trace"] = t
    del trainer
    harness.free()

    # the reference, from the same seeded weights and generator made again
    w0, gen_state = seeded_start(cell, shapes, seed, device)
    r = ref.train_steps(params=w0, cfg=cfg["model"], groups=cfg["optimizer"], scene=sc, gen_state=gen_state,
                        num_steps=tr["check_steps"], num_rays=rays)
    mine = {"losses": r["losses"], "grad": harness.norms(r["first_grad"]), "change": harness.norms(r["change"])}
    out["readings"] = compare.train_readings(checked, mine)
    out["diagnostics"] = {"checked": {"losses": checked["losses"], "reference_losses": r["losses"],
                                      "replayed_steps": max(replays, 0) if device.type == "cuda" else 0,
                                      "worst_leaves": compare.worst_leaves(checked, mine)},
                          "kernel_launches": counted,
                          "launch_ms": [round(1e3 * (b - a), 3) for a, b in zip([t0] + done_at, done_at)]}
    mark(t_start, "reference compared")
    return out


def leaf_shapes(cfg: dict, num_cameras: int) -> dict[str, tuple[int, ...]]:
    """The leaves a trainer of ``num_cameras`` cameras has, in its order."""
    from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoModel

    model = NerfactoModel(harness.program_config(cfg["model"]), device=torch.device("cpu"))
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    if cfg["camera_optimizer"]:
        shapes["camera_opt"] = (num_cameras, 6)
    return shapes


def calibrate(cell, seed: int, device) -> list[dict]:
    """The reference in float32 against the reference with TF32 products
    (the control) and against the reference that leaves out each step's
    second half of rays (a fault), over the stretch a run checks."""
    from portbench.reference import nerfacto as ref

    tr = cell["traffic"]
    sc = training_views(tr, seed, device)
    shapes = leaf_shapes(cell["config"], tr["scene"]["views"])
    w0, gen_state = seeded_start(cell, shapes, seed, device)

    def steps(**kw):
        r = ref.train_steps(w0, cell["config"]["model"], cell["config"]["optimizer"], sc, gen_state,
                            tr["check_steps"], tr["rays_per_step"], **kw)
        return {"losses": r["losses"], "grad": harness.norms(r["first_grad"]), "change": harness.norms(r["change"])}

    t0 = time.perf_counter()
    base = steps()
    seconds = time.perf_counter() - t0
    harness.tf32(True)
    try:
        control = steps()
    finally:
        harness.tf32(False)
    fault = steps(half_batch=True)
    out = []
    for name, got in (("control_tf32", control), ("fault_half_batch", fault)):
        out.append({"reading": name, **compare.train_readings(got, base),
                    "step_gaps": [abs(a - b) / abs(b) for a, b in zip(got["losses"], base["losses"])]})
    out.append({"reading": "reference_seconds", "value": seconds})
    return out
