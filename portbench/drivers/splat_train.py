"""Training active-splatfacto: closed-loop full-image steps through
``SplatfactoTrainer.train``, one 800 x 800 camera a step, drawn by the
trainer from the ``views`` training views, on a random background at SH
degree 3.

Set-up renders the scene's training views, draws the seeded state (a
trained scene's Gaussians on the three spheres' surfaces, the Adam moments
of the second half of a run), builds the trainer with the state's points
and restores the state at step ``state.step``. Past ``stop_split_at`` no
refine or opacity reset runs, so every step has the same shapes. The
rasterizer's budgets come from the program's tuner over every training
view (``tune_rasterize_capacity``, the configuration's margin); then the
``check_steps`` checked steps and ``warmup_steps`` warm-up steps run.

After the window (and the traced stretch) every training view is probed
again on the final state: a hit beyond a budget counts in
``splat_overflow``. The reference then follows the checked steps from the
same state, made again from the seed, on the cameras, backgrounds and
images the program used: each step's loss, the first step's gradient and
each leaf's change over the steps, and the first step's render; and
renders view ``image_view`` from the program's final state, which the
program renders with ``render_image``.

Traffic keys: ``check_steps``, ``warmup_steps``, ``trace_steps``,
``image_view``, ``fault_budget_share`` (``calibrate``'s cut budget, a
share of the largest tile count) and the ``scene`` (``height``, ``width``,
``camera_angle_x``, ``radius``, ``views``, ``gt_samples``). Configuration
keys: ``model`` (``SplatfactoConfig``), ``compositing`` (the rules the
program composites by, which the reference follows), ``optimizer`` (the
attribute groups, as the program's ``SPLAT_GROUPS``), ``state``.
"""

from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from portbench import harness, scene
from portbench.harness import mark
from portbench.yardstick import compare, splat_bounds, trace

KIND = "train"
# Set from calibrate's readings and the sound runs (PERF.md section 2).
# The depth variance, E[d^2] - E[d]^2 of depths near 4 in float32, has a
# limit of its own: its sound gaps are about 1 %, the other channels'
# below 1e-6.
LIMITS = {
    "splat_loss_gap": 1e-5,
    "splat_grad_gap": 3e-4,
    "splat_update_gap": 1e-4,
    "splat_image_gap": 3e-5,
    "splat_depth_var_gap": 0.05,
    "splat_overflow": 0,
}
EXIT_BATCHES = (64, 256)  # calibrate's other exit batches
C0 = 0.28209479177387814  # the SH band-0 constant
NEIGHBOURS = 3
KNN_ROWS = 1024  # rows a 3-NN block holds


def training_views(traffic: dict, seed: int, device) -> dict[str, Any]:
    """The scene's cameras and ground-truth images from the seed."""
    sc = traffic["scene"]
    cams = scene.cameras(sc, sc["views"], scene.seed_of(seed, 1), device)
    cams["images"] = scene.render_views(cams, sc["gt_samples"])
    return cams


def knn_mean_distance(points: torch.Tensor) -> torch.Tensor:
    """Each point's mean distance to its three nearest others."""
    out = []
    for start in range(0, points.shape[0], KNN_ROWS):
        blk = points[start:start + KNN_ROWS]
        d2 = torch.cdist(blk, points) ** 2
        d2[torch.arange(blk.shape[0]), torch.arange(start, start + blk.shape[0])] = math.inf
        out.append(torch.topk(d2, min(NEIGHBOURS, points.shape[0] - 1), dim=1, largest=False).values.mean(1))
    return torch.sqrt(torch.cat(out))


def seeded_state(cfg: dict, seed: int, device) -> dict[str, Any]:
    """The configuration's trained-scene state from the seed, in a buffer of
    the model's ``capacity`` slots with the first ``live`` alive: means on
    the spheres' surfaces (area-weighted, a radial jitter), the spheres'
    shaded colours in the SH band 0, small higher bands, log-scales from
    the mean 3-NN distance plus a per-axis anisotropy, random unit quats,
    opacity logits and log-uncertainties from normals; the dead slots as
    ``init_gaussians`` pads them. The Adam state at ``step``: first
    moments zero, second moments ``adam_rms`` squared."""
    st, model = cfg["state"], cfg["model"]
    n, cap = st["live"], model["capacity"]
    gen = torch.Generator(device=device).manual_seed(scene.seed_of(seed, 5))
    centers = torch.tensor([s[:3] for s in scene.SPHERES], device=device)
    radii = torch.tensor([s[3] for s in scene.SPHERES], device=device)
    which = torch.multinomial(radii**2, n, replacement=True, generator=gen)
    dirs = torch.randn((n, 3), generator=gen, device=device)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    jitter = 1.0 + st["surface_jitter"] * torch.randn((n, 1), generator=gen, device=device)
    points = centers[which] + dirs * radii[which, None] * jitter
    colors = st["color_shade"] * torch.tensor(scene.COLORS, device=device)[which]
    log_scales = torch.log(knn_mean_distance(points))[:, None] + torch.empty((n, 3), device=device).uniform_(
        *st["log_scale_anisotropy"], generator=gen)
    quats = torch.randn((n, 4), generator=gen, device=device)
    quats = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    mean, std = st["opacity_logit"]
    opacities = mean + std * torch.randn(n, generator=gen, device=device)
    bases = (model["sh_degree"] + 1) ** 2
    rest = st["features_rest_std"] * torch.randn((n, bases - 1, 3), generator=gen, device=device)
    mean, std = st["log_uncertainty"]
    log_unc = mean + std * torch.randn((n, 1), generator=gen, device=device)

    def pad(x: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
        return torch.cat([x, torch.full((cap - n, *x.shape[1:]), fill, dtype=x.dtype, device=device)])

    params = {"means": pad(points), "scales": pad(log_scales, -10.0), "quats": pad(quats),
              "opacities": pad(opacities, -10.0), "features_dc": pad((colors - 0.5) / C0),
              "features_rest": pad(rest)}
    if model["uncertainty_channels"]:
        params["log_uncertainties"] = pad(log_unc)
    adam = {"exp_avg": {k: torch.zeros_like(v) for k, v in params.items()},
            "exp_avg_sq": {k: torch.full_like(v, st["adam_rms"][k] ** 2) for k, v in params.items()},
            "adam_count": {k: st["step"] for k in params}, "schedule_count": {k: st["step"] for k in params}}
    return {"params": params, "alive": torch.arange(cap, device=device) < n, "points": points, "colors": colors,
            "adam": adam}


def program_config(model: dict):
    from uncertainty_nerf_gs_torch.models.splatfacto import SplatfactoConfig

    return SplatfactoConfig(**model)


def reference_config(cfg: dict, **compositing) -> dict:
    """The configuration's model keys with its ``compositing`` rules, as the
    reference reads them; ``compositing`` overrides rules."""
    return {**cfg["model"], "compositing": {**cfg["compositing"], **compositing}}


def build_trainer(cell: dict, sc: dict, state: dict, seed: int, device):
    """The program's trainer, built as ``scripts/train.py`` builds it from
    the state's points, then restored at the state's step."""
    from uncertainty_nerf_gs_torch.engine.splat_trainer import SplatfactoTrainer

    cfg = cell["config"]
    trainer = SplatfactoTrainer(program_config(cfg["model"]), harness.program_cameras(sc),
                                images=sc["images"].cpu().numpy(), seed=scene.seed_of(seed, 6),
                                points=state["points"].cpu().numpy(), point_colors=state["colors"].cpu().numpy(),
                                use_camera_optimizer=cfg["camera_optimizer"], device=device)
    adam = state["adam"]
    trainer.restore({
        "params": state["params"], "splat_alive": state["alive"].cpu().numpy(), "step": cfg["state"]["step"],
        "opt_state": {"groups": {k: {"adam_count": adam["adam_count"][k], "schedule_count": adam["schedule_count"][k]}
                                 for k in state["params"]},
                      "exp_avg": adam["exp_avg"], "exp_avg_sq": adam["exp_avg_sq"]},
    })
    return trainer


def probe(trainer) -> dict[str, Any]:
    """Every training view's exact tile and row hit counts (the program's
    ``probe_tile_counts``) against the trainer's budgets: the largest and
    mean tile count, the largest row count, and the hits beyond a budget."""
    from uncertainty_nerf_gs_torch.models import splatfacto as sf

    cfg, cams = trainer.config, trainer.cameras
    row_cap = cfg.rasterize_row_capacity or max(4 * cfg.rasterize_capacity, 1024)
    tile_max = row_max = over = 0
    tile_sum = tiles = 0
    for i in range(len(cams)):
        c = sf.probe_tile_counts(trainer.params, trainer.splat_state.alive, *trainer.camera(i), cams.width,
                                 cams.height, cfg)
        tile, row = c.tile.to(torch.int64), c.row.to(torch.int64)
        tile_max, row_max = max(tile_max, int(tile.max())), max(row_max, int(row.max()))
        tile_sum, tiles = tile_sum + int(tile.sum()), tiles + tile.numel()
        over += int(torch.clamp(tile - cfg.rasterize_capacity, min=0).sum() + torch.clamp(row - row_cap, min=0).sum())
    return {"tile_max": tile_max, "tile_mean": tile_sum / tiles, "row_max": row_max, "overflow": over,
            "rasterize_capacity": cfg.rasterize_capacity, "rasterize_row_capacity": row_cap}


class StepRecorder:
    """Records, while open, each step's camera, background, ground-truth
    image and (the first step's) outputs, from the program's calls of
    ``render_splat`` and ``splatfacto_loss`` in the trainer's module."""

    OUTPUTS = ("rgb", "depth", "depth_var", "accumulation", "uncertainty")

    def __init__(self):
        from uncertainty_nerf_gs_torch.engine import splat_trainer

        self.module, self.steps = splat_trainer.sf, []

    def __enter__(self):
        render, loss = self.module.render_splat, self.module.splatfacto_loss
        self.originals = (render, loss)
        steps = self.steps

        def render_splat(params, alive, c2w, fx, fy, cx, cy, width, height, config, sh_deg=None, background=None,
                         means2d_tap=None):
            out = render(params, alive, c2w, fx, fy, cx, cy, width, height, config, sh_deg=sh_deg,
                         background=background, means2d_tap=means2d_tap)
            step = {"camera": {"c2w": c2w.detach().clone(), "fx": fx, "fy": fy, "cx": cx, "cy": cy, "width": width,
                               "height": height}, "background": background.detach().clone(), "sh_degree": sh_deg}
            if not steps:
                step["outputs"] = {k: out[k].detach().to("cpu", copy=True) for k in self.OUTPUTS if k in out}
            steps.append(step)
            return out

        def splatfacto_loss(outputs, image, *args, **kwargs):
            steps[-1]["image"] = image.detach().clone()
            return loss(outputs, image, *args, **kwargs)

        self.module.render_splat, self.module.splatfacto_loss = render_splat, splatfacto_loss
        return self

    def __exit__(self, *exc):
        self.module.render_splat, self.module.splatfacto_loss = self.originals


def checked_steps(trainer, n: int) -> dict[str, Any]:
    """The trainer's next ``n`` steps through ``train``: each step's loss,
    the first step's gradient, each leaf's change over the steps (all on
    the host) and what each step rendered from."""
    start = {k: v.detach().to("cpu", copy=True) for k, v in trainer.params.items()}
    losses, grad = [], None
    with StepRecorder() as rec:
        for _ in range(n):
            losses.append(trainer.train(1)["total_loss"])
            if grad is None:
                grad = {k: v.grad.detach().to("cpu", copy=True) for k, v in trainer.params.items()}
    change = {k: v.detach().cpu() - start[k] for k, v in trainer.params.items()}
    return {"losses": losses, "grad": grad, "change": change, "steps": rec.steps}


def composited_rows(trainer, views: list[int]) -> tuple[int, int, int, int]:
    """(rows K2 and K3 composite, live rows, tiles, slots a tile) summed over
    ``views`` rendered at the trainer's state: each view's packed rows
    caught where ``rasterize_gaussians`` hands them to ``composite_tiles``,
    their rows counted by the program's ``executed_rows`` a block of tiles
    at a time."""
    from uncertainty_nerf_gs_torch.ops import composite, rasterize

    total = [0, 0, 0, 0]

    def on_call(packed, pix, counts):
        t, k, _ = packed.shape
        step = max(1, (1 << 26) // (k * composite.PIXELS))
        for a in range(0, t, step):
            total[0] += int(composite.executed_rows(packed[a:a + step], pix[a:a + step], counts[a:a + step]).sum())
        total[1] += int(counts.sum())
        total[2] += t
        total[3] = k

    with torch.no_grad(), harness.Recorder(rasterize, "composite_tiles", on_call):
        for v in views:
            trainer.render_image(v)
    return tuple(total)


def readings(prog: dict[str, Any], ref: dict[str, Any], images: list[tuple[dict, dict]], overflow: int
             ) -> tuple[dict[str, float], dict[str, str]]:
    """The driver's readings of a program (or a variant) against the
    reference: the worst step's relative loss gap; the worst leaf's
    |g_prog - g_ref| / |g_ref| of the first step's gradient, and the gap of
    the norms of its change over the steps (``norm_gap``: entrywise, a
    change of float32 parameters measures their storage); over ``images``
    (pairs of outputs) the worst mean gap of rgb, depth, accumulation and
    uncertainty, and apart the depth variance's; the hits beyond a budget.
    Also the leaves that set the two leaf gaps, and each image's channel
    gaps."""
    from portbench.reference import splatfacto as ref_sf

    if len(prog["losses"]) != len(ref["losses"]):
        return {"splat_loss_gap": math.inf}, {}
    loss = max((abs(p - r) / max(abs(r), 1e-12) if math.isfinite(p) else math.inf)
               for p, r in zip(prog["losses"], ref["losses"]))
    out, worst = {"splat_loss_gap": loss}, {}
    gaps_of = (("grad", "splat_grad_gap", ref_sf.leaf_gap), ("change", "splat_update_gap", ref_sf.norm_gap))
    for key, name, gap in gaps_of:
        gaps = {k: gap(prog[key][k], ref[key][k].cpu()) for k in ref[key]}
        worst[key] = max(gaps, key=gaps.get)
        out[name] = gaps[worst[key]]
    channels = [{k: d / max(m, 1e-30) for k, (d, m) in compare.eval_sums(p, r).items()} for p, r in images]
    out["splat_image_gap"] = max(max((v for k, v in c.items() if k != "depth_var"), default=math.inf)
                                 for c in channels)
    out["splat_depth_var_gap"] = max(c.get("depth_var", math.inf) for c in channels)
    out["splat_overflow"] = overflow
    worst["image_channels"] = channels
    return out, worst


def drive(cell, seed: int, seconds: float, trace_on: bool, device, t_start: float,
          workdir: Path) -> dict[str, Any]:
    from portbench.reference import splatfacto as ref

    cfg, tr = cell["config"], cell["traffic"]
    harness.tf32(False)  # the configuration's precision
    mark(t_start, "program imported")
    sc = training_views(tr, seed, device)
    mark(t_start, "scene rendered")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = seeded_state(cfg, seed, device)
    mark(t_start, "state drawn")
    trainer = build_trainer(cell, sc, state, seed, device)
    del state
    mark(t_start, "trainer built and restored")
    from uncertainty_nerf_gs_torch.models import splatfacto as sf

    trainer.config = sf.tune_rasterize_capacity(trainer.config, trainer.params, trainer.splat_state.alive,
                                                trainer.cameras, max_probes=len(trainer.cameras))
    counts_start = probe(trainer)
    mark(t_start, f"budgets from {len(trainer.cameras)} views: {counts_start}")
    checked = checked_steps(trainer, tr["check_steps"])
    mark(t_start, "checked steps run")
    trainer.train(tr["warmup_steps"])
    mark(t_start, "warm-up steps run")

    counted = harness.launch_counts()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    steps, done_at = 0, []
    while True:
        trainer.train(1)
        done_at.append(time.perf_counter())
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    counted = harness.launches_since(counted)
    mark(t_start, "window closed")

    out = {"attempted": steps, "failed": 0, "peak": peak,
           "metrics": {"train_step_ms": (1e3 * window_s / steps, "ms/step"), "setup_s": (setup_s, "s")}}
    diagnostics: dict[str, Any] = {}
    if trace_on:
        views: list[int] = []
        units = tr["trace_steps"]
        with harness.Recorder(trainer, "camera", lambda i: views.append(int(i))):
            t = trace.profile(lambda: trainer.train(units), workdir, KIND, units, counters=harness.program_counts)
        rows, live, tiles, k = composited_rows(trainer, views)
        c = 6 if cfg["model"]["uncertainty_channels"] else 5
        t.bound_ms_per_unit["composite_fwd"] = splat_bounds.composite_bound_ms(rows, tiles, c, False) / units
        t.bound_ms_per_unit["composite_bwd"] = splat_bounds.composite_bound_ms(rows, tiles, c, True) / units
        diagnostics["traced"] = {"views": views, "composited_rows": rows, "live_rows": live, "tiles": tiles,
                                 "slots_a_tile": k}
        out["trace"] = t
    counts_end = probe(trainer)
    mark(t_start, "final state probed")
    view = tr["image_view"]
    final_render = {k: torch.from_numpy(v) for k, v in trainer.render_image(view).items() if k in StepRecorder.OUTPUTS}
    final = {"params": {k: v.detach().to("cpu", copy=True) for k, v in trainer.params.items()},
             "alive": trainer.splat_state.alive.cpu(), "camera": trainer.camera(view),
             "background": sf.fixed_background(trainer.config).cpu()}
    del trainer
    harness.free()

    # the reference, from the same state made again from the seed
    model = reference_config(cfg)
    state = seeded_state(cfg, seed, device)
    steps_in = [{"camera": s["camera"], "background": s["background"], "image": s["image"]} for s in checked["steps"]]
    sh = checked["steps"][0]["sh_degree"]
    r = ref.train_steps(state["params"], state["alive"], state["adam"], steps_in, model, cfg["optimizer"], sh)
    del state
    c2w, fx, fy, cx, cy = final["camera"]
    cam = {"c2w": c2w.to(device), "fx": fx, "fy": fy, "cx": cx, "cy": cy, "width": sc["width"], "height": sc["height"]}
    r_final = ref.render({k: v.to(device) for k, v in final["params"].items()}, final["alive"].to(device), cam,
                         final["background"].to(device), model, model["sh_degree"])
    images = [(checked["steps"][0]["outputs"], {k: v.cpu() for k, v in r["outputs"].items()}),
              (final_render, {k: v.cpu() for k, v in r_final.items()})]
    out["readings"], worst = readings(checked, r, images, counts_end["overflow"])
    diagnostics.update({
        "checked": {"losses": checked["losses"], "reference_losses": r["losses"], "worst_leaves": worst},
        "probes": {"start": counts_start, "end": counts_end}, "kernel_launches": counted,
        "step_ms": [round(1e3 * (b - a), 3) for a, b in zip([t0] + done_at, done_at)]})
    out["diagnostics"] = diagnostics
    mark(t_start, "reference compared")
    return out


def calibrate(cell, seed: int, device) -> list[dict]:
    """The reference in float32 against itself in float64 (the control),
    against three planted faults and against two other exit batches, over
    the stretch a run checks. The faults: the payload rounded to bfloat16
    before compositing, each tile's hits cut to ``fault_budget_share`` of
    the largest tile count (the far ones drop), and SH degree 2 in place of
    3. The exit batches (``EXIT_BATCHES``) in place of the configuration's
    show how far the readings move where a tile stops at another row.
    Cameras and backgrounds are drawn from the seed; the image compared
    besides the first step's is view ``image_view`` rendered at the start
    state."""
    from portbench.reference import splatfacto as ref

    cfg, tr = cell["config"], cell["traffic"]
    model = reference_config(cfg)
    harness.tf32(False)
    sc = training_views(tr, seed, device)
    state = seeded_state(cfg, seed, device)
    rng = np.random.default_rng(scene.seed_of(seed, 7))
    gen = torch.Generator(device=device).manual_seed(scene.seed_of(seed, 8))

    def camera(i):
        return {"c2w": sc["c2w"][i], "fx": float(sc["focal"][i]), "fy": float(sc["focal"][i]),
                "cx": float(sc["cx"][i]), "cy": float(sc["cy"][i]), "width": sc["width"], "height": sc["height"]}

    views = [int(v) for v in rng.integers(0, len(sc["c2w"]), tr["check_steps"])]
    steps_in = [{"camera": camera(v), "background": torch.rand(3, generator=gen, device=device),
                 "image": sc["images"][v]} for v in views]
    view, bg = camera(tr["image_view"]), torch.tensor([0.149, 0.1647, 0.2157], device=device)

    def run(dtype=torch.float32, sh=model["sh_degree"], ref_cfg=model, **faults):
        r = ref.train_steps(state["params"], state["alive"], state["adam"], steps_in, ref_cfg, cfg["optimizer"], sh,
                            dtype=dtype, **faults)
        p = {k: v.to(dtype) for k, v in state["params"].items()}
        img = ref.render(p, state["alive"], {**view, "c2w": view["c2w"].to(dtype)}, bg.to(dtype), ref_cfg, sh,
                         **faults)
        r["image"] = {k: v.float().cpu() for k, v in img.items()}
        return r

    t0 = time.perf_counter()
    base = run()
    seconds = time.perf_counter() - t0
    budget = max(1, int(tr["fault_budget_share"] * int(base["counts"].max())))
    variants = (("control_float64", dict(dtype=torch.float64)), ("fault_payload_bf16", dict(payload_bf16=True)),
                ("fault_budget_cut", dict(budget=budget)), ("fault_sh_degree_2", dict(sh=2)),
                *((f"exit_batch_{b}", dict(ref_cfg=reference_config(cfg, exit_batch=b))) for b in EXIT_BATCHES))
    out = []
    for name, kw in variants:
        got = run(**kw)
        prog = {"losses": got["losses"], "grad": {k: v.cpu() for k, v in got["grad"].items()},
                "change": {k: v.cpu() for k, v in got["change"].items()}}
        images = [({k: v.cpu() for k, v in got["outputs"].items()}, {k: v.cpu() for k, v in base["outputs"].items()}),
                  (got["image"], base["image"])]
        line, worst = readings(prog, base, images, 0)
        out.append({"reading": name, **line, "worst_leaves": worst})
    out.append({"reading": "budget_cut", "value": budget})
    out.append({"reading": "reference_seconds", "value": seconds})
    return out

