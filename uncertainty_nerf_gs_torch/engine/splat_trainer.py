"""Training and rendering for the splatfacto family.

Counterpart of ``SplatfactoTrainer`` in
``uncertainty_nerf_gs_tpu/engine/splat_trainer.py``: full-image batches, one
Adam (eps 1e-15) per Gaussian attribute with the splatfacto learning rates
(means 1.6e-4 decaying to 1.6e-6 over 30k steps, scales 5e-3, quats 1e-3,
opacities 5e-2, features_dc 2.5e-3, features_rest 2.5e-3 / 20,
log_uncertainties 2.5e-3), and the screen-space gradient tap that feeds the
strategy state. Each group's lr is set from its schedule at the group's own
count of updates, as optax counts them (``_apply_updates``).

After ``warmup_length`` the refinement schedule runs between steps, as in
the JAX trainer: every ``refine_every`` steps ``refine_gaussians`` densifies
and culls, and the Adam moments of the slots it replaced are zeroed; every
``reset_alpha_every`` refines the opacities are clamped and their Adam
state starts afresh (its count, and so its schedule, back at 0). Refined
rows are written into the existing leaf tensors, which the optimizers hold.
The camera optimizer adjusts each image's camera-to-world by an SO3xR3
tangent with its own Adam; ``rasterize_capacity_auto`` and
``capacity_retune_every`` size the rasterizer's budgets from probed hit
counts (``tune_rasterize_capacity``), growing them only.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from uncertainty_nerf_gs_torch.cameras.cameras import Cameras
from uncertainty_nerf_gs_torch.cameras.lie import compose_poses, exp_map_SO3xR3
from uncertainty_nerf_gs_torch.engine.optimizers import OptimizerGroupConfig, exp_decay_schedule
from uncertainty_nerf_gs_torch.models import splatfacto as sf
from uncertainty_nerf_gs_torch.ops.backend import resolve_device
from uncertainty_nerf_gs_torch.utils.tracing import span

SPLAT_GROUPS: dict[str, OptimizerGroupConfig] = {
    "means": OptimizerGroupConfig(lr=1.6e-4, lr_final=1.6e-6, max_steps=30_000),
    "scales": OptimizerGroupConfig(lr=5e-3, lr_final=5e-3, max_steps=30_000),
    "quats": OptimizerGroupConfig(lr=1e-3, lr_final=1e-3, max_steps=30_000),
    "opacities": OptimizerGroupConfig(lr=5e-2, lr_final=5e-2, max_steps=30_000),
    "features_dc": OptimizerGroupConfig(lr=2.5e-3, lr_final=2.5e-3, max_steps=30_000),
    "features_rest": OptimizerGroupConfig(lr=2.5e-3 / 20, lr_final=2.5e-3 / 20, max_steps=30_000),
    "log_uncertainties": OptimizerGroupConfig(lr=2.5e-3, lr_final=2.5e-3, max_steps=30_000),
}


def _apply_updates(opt: torch.optim.Adam) -> None:
    """One update: the group's lr from its schedule at its count of
    updates made so far (optax's count), Adam's step, then the count
    advances. The splat steps are not captured, so the lr is a host
    float."""
    for group in opt.param_groups:
        group["lr"] = exp_decay_schedule(group["config"])(group["count"])
    opt.step()
    for group in opt.param_groups:
        group["count"] += 1


def _adam_state(opt: torch.optim.Adam) -> dict:
    """``opt``'s only parameter's Adam count and moments (zeros before its
    first update)."""
    p = opt.param_groups[0]["params"][0]
    st = opt.state.get(p, {})
    moments = {k: st[k].detach() if st else torch.zeros_like(p.detach()) for k in ("exp_avg", "exp_avg_sq")}
    return {"adam_count": int(st["step"]) if st else 0, **moments}


def _load_adam_state(opt: torch.optim.Adam, state: Mapping[str, Any]) -> None:
    p = opt.param_groups[0]["params"][0]
    opt.state[p] = {
        # torch.optim.Adam's own layout: a float32 step on the host
        "step": torch.tensor(float(state["adam_count"]), dtype=torch.float32),
        **{k: torch.as_tensor(state[k]).to(p.device).clone() for k in ("exp_avg", "exp_avg_sq")},
    }


class SplatfactoTrainer:
    """Owns the Gaussian parameters, the strategy state, the camera
    tangents and the optimizers on one device.

    Args:
      config: model config.
      cameras: the scene's cameras (moved to ``device``).
      images: (N, H, W, 3) float32 in [0, 1], one per camera.
      seed: seeds the ``torch.Generator`` of the initial Gaussians, random
        backgrounds and the refinement's split samples; the camera order
        comes from ``np.random.default_rng(seed + 17)``, as in the JAX
        package.
      points, point_colors: optional (M, 3) initial points and colors.
      use_camera_optimizer: train an SO3xR3 tangent per image, applied to
        its camera-to-world before projection.
      camera_opt_lr: the tangents' Adam learning rate.
      device: ``None`` is the card; raises when there is none.
    """

    def __init__(
        self,
        config: sf.SplatfactoConfig,
        cameras: Cameras,
        images: np.ndarray,
        seed: int = 0,
        points: np.ndarray | None = None,
        point_colors: np.ndarray | None = None,
        use_camera_optimizer: bool = False,
        camera_opt_lr: float = 1e-4,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.config = config
        self.cameras = cameras.to(self.device)
        # intrinsics as host floats: the projection takes them as scalars
        self._intrinsics = torch.stack(
            [cameras.fx, cameras.fy, cameras.cx, cameras.cy], dim=1
        ).tolist()
        self.images = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

        def as_tensor(x):
            return None if x is None else torch.as_tensor(np.asarray(x, np.float32), device=self.device)

        params, self.splat_state = sf.init_gaussians(
            self._generator, config, as_tensor(points), as_tensor(point_colors)
        )
        if config.rasterize_capacity_auto:
            self.config = sf.tune_rasterize_capacity(config, params, self.splat_state.alive, self.cameras)
            print(f"[auto-capacity] rasterize_capacity={self.config.rasterize_capacity} "
                  f"row_capacity={self.config.rasterize_row_capacity}")
        self.use_camera_optimizer = use_camera_optimizer
        self.camera_opt_lr = camera_opt_lr
        self._set_params(params)
        self._cam_rng = np.random.default_rng(seed + 17)
        self.step = 0
        self.launch_lock = contextlib.nullcontext()
        self._last_opacity_reset = -(10**9)  # no reset yet: NLL ramp weight 1
        self.scene_extent = float(torch.max(torch.abs(self.cameras.camera_to_worlds[:, :3, 3])))

    def _set_params(self, params: Mapping[str, Any], camera_opt=None) -> None:
        """Leaf tensors on the device, one fresh Adam per attribute (a param
        group carrying its ``config`` and its ``count`` of updates), and the
        camera tangents (zeros unless given) with their own Adam."""
        self.params = {
            k: torch.as_tensor(v, dtype=torch.float32).to(self.device).clone().requires_grad_(True)
            for k, v in params.items()
        }
        self.optimizers = {k: self._adam(k, p) for k, p in self.params.items()}
        self.camera_opt = (
            torch.zeros((len(self.cameras), 6), device=self.device) if camera_opt is None
            else torch.as_tensor(camera_opt, dtype=torch.float32).to(self.device).clone()
        ).requires_grad_(True)
        self.cam_optimizer = torch.optim.Adam([self.camera_opt], lr=self.camera_opt_lr, eps=1e-15)

    def _adam(self, k: str, p: torch.Tensor) -> torch.optim.Adam:
        cfg = SPLAT_GROUPS[k]
        return torch.optim.Adam([dict(params=[p], name=k, config=cfg, count=0,
                                      lr=exp_decay_schedule(cfg)(0), eps=cfg.eps)])

    # --------------------------------------------------------------- resume
    def state_dict(self) -> dict:
        """Resumable training state: parameters (detached views), per
        attribute the Adam count, the schedule's count and the moments
        (``opt_state``), the camera tangents and their Adam state, the
        alive mask, the step and the last opacity reset."""
        groups, moments = {}, {"exp_avg": {}, "exp_avg_sq": {}}
        for k, opt in self.optimizers.items():
            st = _adam_state(opt)
            groups[k] = {"adam_count": st["adam_count"],
                         "schedule_count": opt.param_groups[0]["count"]}
            for key, out in moments.items():
                out[k] = st[key]
        return {
            "params": {k: v.detach() for k, v in self.params.items()},
            "opt_state": {"groups": groups, **moments},
            "camera_opt": self.camera_opt.detach(),
            "cam_opt_state": _adam_state(self.cam_optimizer),
            "splat_alive": self.splat_state.alive.cpu().numpy(),
            "step": self.step,
            "last_opacity_reset": self._last_opacity_reset,
        }

    def restore(self, ckpt: Mapping[str, Any]) -> None:
        """Load ``state_dict()`` output (or ``interop.
        splat_trainer_state_from_jax`` of the JAX trainer's). Without
        ``opt_state`` (e.g. parameters converted by
        ``interop.splat_params_from_jax``) the Adam states start fresh;
        without ``camera_opt`` the tangents start at zero. The strategy
        statistics start at zero, as in the JAX trainer."""
        self._set_params(ckpt["params"], ckpt.get("camera_opt"))
        opt_state = ckpt.get("opt_state")
        if opt_state is not None:
            for k, opt in self.optimizers.items():
                counts = opt_state["groups"][k]
                opt.param_groups[0]["count"] = int(counts["schedule_count"])
                _load_adam_state(opt, {"adam_count": counts["adam_count"],
                                       "exp_avg": opt_state["exp_avg"][k],
                                       "exp_avg_sq": opt_state["exp_avg_sq"][k]})
        if "cam_opt_state" in ckpt:
            _load_adam_state(self.cam_optimizer, ckpt["cam_opt_state"])
        cap = self.config.capacity
        dev = self.device
        self.splat_state = sf.SplatState(
            alive=torch.as_tensor(np.asarray(ckpt["splat_alive"]), dtype=torch.bool, device=dev),
            grad_accum=torch.zeros(cap, device=dev),
            vis_count=torch.zeros(cap, dtype=torch.int32, device=dev),
            max_radii=torch.zeros(cap, device=dev),
        )
        self.step = int(ckpt["step"])
        self._last_opacity_reset = int(ckpt.get("last_opacity_reset", -(10**9)))

    # ------------------------------------------------------------------ step
    def camera(self, idx: int) -> tuple:
        """(c2w on the device, fx, fy, cx, cy) of camera ``idx``."""
        fx, fy, cx, cy = self._intrinsics[idx]
        return self.cameras.camera_to_worlds[idx], fx, fy, cx, cy

    def train_step(self, refine_eps: torch.Tensor | None = None) -> dict[str, float]:
        """One full-image step on a camera drawn from the numpy generator,
        then the refinement schedule and the capacity retune. A refine
        this step makes takes its split samples from ``refine_eps`` when
        given ((n_split_samples, capacity, 3) standard normal draws), else
        from the trainer's generator. Its spans: ``ungs.splat.step`` around
        it all, and inside it ``.loss``, ``.backward``, ``.update`` (the
        attribute Adams and the camera Adam) and ``.stats``; the render's
        own (``.project``, ``.rasterize``), ``.refine`` and ``.retune``."""
        with span("ungs.splat.step", splat_steps=1):
            cfg = self.config
            cam_idx = int(self._cam_rng.integers(0, len(self.cameras)))
            if cfg.background_color == "random":
                background = torch.rand(3, generator=self._generator, device=self.device)
            else:
                background = sf.fixed_background(cfg, self.device)
            if cfg.nll_ramp_after_reset > 0:
                since = self.step - self._last_opacity_reset
                nll_w = min(1.0, max(0.0, since / cfg.nll_ramp_after_reset))
            else:
                nll_w = 1.0

            c2w, fx, fy, cx, cy = self.camera(cam_idx)
            if self.use_camera_optimizer:
                delta = exp_map_SO3xR3(self.camera_opt[cam_idx][None])
                c2w = compose_poses(delta, c2w[None])[0]
            tap = torch.zeros((cfg.capacity, 2), device=self.device, requires_grad=True)
            out = sf.render_splat(
                self.params, self.splat_state.alive, c2w, fx, fy, cx, cy,
                self.cameras.width, self.cameras.height, cfg,
                sh_deg=sf.active_sh_degree(self.step, cfg), background=background,
                means2d_tap=tap,
            )
            with span("ungs.splat.loss"):
                total, losses = sf.splatfacto_loss(out, self.images[cam_idx], self.params, cfg, nll_w)
            for opt in self.optimizers.values():
                opt.zero_grad(set_to_none=False)
            self.cam_optimizer.zero_grad(set_to_none=False)
            with span("ungs.splat.backward"):
                total.backward()
            with span("ungs.splat.update"):
                for opt in self.optimizers.values():
                    _apply_updates(opt)
                if self.use_camera_optimizer:
                    self.cam_optimizer.step()
            with span("ungs.splat.stats"):
                self.splat_state = sf.accumulate_stats(
                    self.splat_state, tap.grad, out["radii"].detach(), out["visible"],
                    self.cameras.width, self.cameras.height,
                )
            self.step += 1
            losses["total_loss"] = total

            # the refinement schedule, the JAX trainer's arithmetic
            if (self.step > cfg.warmup_length and self.step % cfg.refine_every == 0
                    and self.step < cfg.stop_split_at):
                reset_period = cfg.reset_alpha_every * cfg.refine_every
                if self.step % reset_period > max(cfg.warmup_length, cfg.refine_every):
                    info = self.refine(refine_eps)
                    losses["num_alive"] = info["num_alive"]
                if self.step % reset_period == 0:
                    self.reset_opacities()
            if cfg.capacity_retune_every and self.step % cfg.capacity_retune_every == 0:
                self.retune_capacity()
            return {k: float(v.detach()) for k, v in losses.items()}

    @torch.no_grad()
    def refine(self, eps: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        """``refine_gaussians`` at the current step, its rows written into
        the parameters' own leaves (the optimizers hold them), then the Adam
        moments of the slots it replaced zeroed, in the span
        ``ungs.splat.refine``. Returns its ``info``."""
        with span("ungs.splat.refine", refines=1):
            params, self.splat_state, info = sf.refine_gaussians(
                self.params, self.splat_state, self.config, self.step,
                scene_extent=self.scene_extent, generator=self._generator,
                eps=None if eps is None else eps.to(self.device),
            )
            for k, v in params.items():
                self.params[k].copy_(v)
            if int(info["num_dropped_capacity"]) > 0:
                print(f"[refine] capacity overflow: dropped {int(info['num_dropped_capacity'])} new gaussians")
            self._zero_moment_slots(info["touched_slots"])
            return info

    @torch.no_grad()
    def reset_opacities(self) -> None:
        """Clamp the opacities (``splatfacto.reset_opacities``) and give
        their Adam a fresh state: count and schedule back at 0, as optax
        re-initialises the whole chain."""
        self.params["opacities"].copy_(sf.reset_opacities(self.params, self.config)["opacities"])
        opt = self.optimizers["opacities"]
        opt.state.clear()  # Adam builds a zero state at its next update
        opt.param_groups[0]["count"] = 0
        self._last_opacity_reset = self.step

    def _zero_moment_slots(self, touched: torch.Tensor) -> None:
        """Zero the first and second moments of the replaced slots only
        (splatfacto's dup_in_optim); Adam's count is kept, and the other
        slots keep their momentum."""
        for opt in self.optimizers.values():
            for st in opt.state.values():
                for key in ("exp_avg", "exp_avg_sq"):
                    m = st[key]
                    m.masked_fill_(touched.reshape((-1,) + (1,) * (m.dim() - 1)), 0.0)

    def retune_capacity(self) -> bool:
        """Probe the hit counts again and grow the rasterizer's budgets
        where they no longer hold; never shrink. Returns True when a budget
        grew (there is nothing to recompile). In the span
        ``ungs.splat.retune``."""
        with span("ungs.splat.retune", retunes=1):
            cfg = self.config
            tuned = sf.tune_rasterize_capacity(cfg, self.params, self.splat_state.alive, self.cameras)
            row_now = cfg.rasterize_row_capacity or max(4 * cfg.rasterize_capacity, 1024)
            if (tuned.rasterize_capacity <= cfg.rasterize_capacity
                    and (tuned.rasterize_row_capacity or 0) <= row_now):
                return False
            self.config = dataclasses.replace(
                cfg,
                rasterize_capacity=max(tuned.rasterize_capacity, cfg.rasterize_capacity),
                rasterize_row_capacity=max(tuned.rasterize_row_capacity or 0, row_now),
            )
            print(f"[auto-capacity] step {self.step}: grew rasterize_capacity="
                  f"{self.config.rasterize_capacity} row_capacity={self.config.rasterize_row_capacity}")
            return True

    def train(self, num_steps: int, log_every: int = 0, writer=None) -> dict[str, float]:
        """``num_steps`` steps, each under ``launch_lock`` (a live viewer
        renders under the same lock); ``writer.write(step, losses)`` after
        every one, as in the JAX trainer."""
        losses: dict[str, float] = {}
        for i in range(num_steps):
            with self.launch_lock:
                losses = self.train_step()
            if writer is not None:
                writer.write(self.step, losses)
            if log_every and (i + 1) % log_every == 0:
                print(f"step {self.step}: " + ", ".join(f"{k}={v:.4f}" for k, v in losses.items()))
        return losses

    # ------------------------------------------------------------- rendering
    @torch.no_grad()
    def render_image(self, camera_idx: int, background=None) -> dict[str, np.ndarray]:
        """One full image at the full SH degree, on the config's fixed
        background unless one is given."""
        cfg = self.config
        bg = (
            torch.as_tensor(np.asarray(background, np.float32), device=self.device)
            if background is not None else sf.fixed_background(cfg, self.device)
        )
        out = sf.render_splat(
            self.params, self.splat_state.alive, *self.camera(camera_idx),
            self.cameras.width, self.cameras.height, cfg,
            sh_deg=cfg.sh_degree, background=bg,
        )
        return {k: v.cpu().numpy() for k, v in out.items() if k not in ("radii", "visible")}
