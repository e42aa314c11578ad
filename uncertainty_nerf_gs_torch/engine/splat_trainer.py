"""Training and rendering for the splatfacto family.

Counterpart of ``SplatfactoTrainer`` in
``uncertainty_nerf_gs_tpu/engine/splat_trainer.py``: full-image batches, one
Adam (eps 1e-15) per Gaussian attribute with the splatfacto learning rates
(means 1.6e-4 decaying to 1.6e-6 over 30k steps, scales 5e-3, quats 1e-3,
opacities 5e-2, features_dc 2.5e-3, features_rest 2.5e-3 / 20,
log_uncertainties 2.5e-3), and the screen-space gradient tap that feeds the
strategy state. Each group's lr is set from its schedule at the count of
updates made so far, before ``optimizer.step()``, as optax does.

Not ported yet, and refused rather than skipped: the refinement schedule
(``train_step`` raises once ``step`` reaches ``warmup_length``), the camera
optimizer, and the capacity tuner (``rasterize_capacity_auto``,
``capacity_retune_every``).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from uncertainty_nerf_gs_torch.cameras.cameras import Cameras
from uncertainty_nerf_gs_torch.engine.optimizers import (
    OptimizerGroupConfig,
    exp_decay_schedule,
)
from uncertainty_nerf_gs_torch.models import splatfacto as sf
from uncertainty_nerf_gs_torch.ops.backend import resolve_device

SPLAT_GROUPS: dict[str, OptimizerGroupConfig] = {
    "means": OptimizerGroupConfig(lr=1.6e-4, lr_final=1.6e-6, max_steps=30_000),
    "scales": OptimizerGroupConfig(lr=5e-3, lr_final=5e-3, max_steps=30_000),
    "quats": OptimizerGroupConfig(lr=1e-3, lr_final=1e-3, max_steps=30_000),
    "opacities": OptimizerGroupConfig(lr=5e-2, lr_final=5e-2, max_steps=30_000),
    "features_dc": OptimizerGroupConfig(lr=2.5e-3, lr_final=2.5e-3, max_steps=30_000),
    "features_rest": OptimizerGroupConfig(lr=2.5e-3 / 20, lr_final=2.5e-3 / 20, max_steps=30_000),
    "log_uncertainties": OptimizerGroupConfig(lr=2.5e-3, lr_final=2.5e-3, max_steps=30_000),
}


class SplatfactoTrainer:
    """Owns the Gaussian parameters, the strategy state and the optimizers
    on one device.

    Args:
      config: model config.
      cameras: the scene's cameras (moved to ``device``).
      images: (N, H, W, 3) float32 in [0, 1], one per camera.
      seed: seeds the ``torch.Generator`` of the initial Gaussians and of
        random backgrounds; the camera order comes from
        ``np.random.default_rng(seed + 17)``, as in the JAX package.
      points, point_colors: optional (M, 3) initial points and colors.
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
        device: str | torch.device | None = None,
    ):
        if use_camera_optimizer:
            raise NotImplementedError("the camera optimizer (cameras/lie.py) is not ported yet")
        if config.rasterize_capacity_auto or config.capacity_retune_every:
            raise NotImplementedError(
                "rasterize capacity tuning (tune_rasterize_capacity) is not ported yet"
            )
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
        self._set_params(params)
        self._cam_rng = np.random.default_rng(seed + 17)
        self.step = 0
        self._last_opacity_reset = -(10**9)  # no reset yet: NLL ramp weight 1

    def _set_params(self, params: Mapping[str, Any], opt_state: Mapping | None = None) -> None:
        """Leaf tensors on the device and one Adam per attribute."""
        self.params = {
            k: torch.as_tensor(v, dtype=torch.float32).to(self.device).clone().requires_grad_(True)
            for k, v in params.items()
        }
        self._schedules = {k: exp_decay_schedule(SPLAT_GROUPS[k]) for k in self.params}
        self.optimizers = {
            k: torch.optim.Adam([p], lr=self._schedules[k](0), eps=SPLAT_GROUPS[k].eps)
            for k, p in self.params.items()
        }
        if opt_state is not None:
            for k, st in opt_state.items():
                self.optimizers[k].load_state_dict(st)

    # --------------------------------------------------------------- resume
    def state_dict(self) -> dict:
        """Resumable training state: parameters (detached views), Adam
        states, the alive mask, the step."""
        return {
            "params": {k: v.detach() for k, v in self.params.items()},
            "opt_state": {k: o.state_dict() for k, o in self.optimizers.items()},
            "splat_alive": self.splat_state.alive.cpu().numpy(),
            "step": self.step,
            "last_opacity_reset": self._last_opacity_reset,
        }

    def restore(self, ckpt: Mapping[str, Any]) -> None:
        """Load ``state_dict()`` output. Without ``opt_state`` (e.g.
        parameters converted by ``interop.splat_params_from_jax``) the Adam
        states start fresh."""
        self._set_params(ckpt["params"], ckpt.get("opt_state"))
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

    def train_step(self) -> dict[str, float]:
        """One full-image step on a camera drawn from the numpy generator.
        Raises once ``step`` reaches ``warmup_length``: the refinement that
        would follow is not ported yet."""
        cfg = self.config
        if self.step >= cfg.warmup_length:
            raise NotImplementedError(
                f"step {self.step} reaches warmup_length={cfg.warmup_length}: "
                "refinement (refine_gaussians) is not ported yet"
            )
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

        tap = torch.zeros((cfg.capacity, 2), device=self.device, requires_grad=True)
        out = sf.render_splat(
            self.params, self.splat_state.alive, *self.camera(cam_idx),
            self.cameras.width, self.cameras.height, cfg,
            sh_deg=sf.active_sh_degree(self.step, cfg), background=background,
            means2d_tap=tap,
        )
        total, losses = sf.splatfacto_loss(out, self.images[cam_idx], self.params, cfg, nll_w)
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=False)
        total.backward()
        for k, opt in self.optimizers.items():
            opt.param_groups[0]["lr"] = self._schedules[k](self.step)
            opt.step()
        self.splat_state = sf.accumulate_stats(
            self.splat_state, tap.grad, out["radii"].detach(), out["visible"],
            self.cameras.width, self.cameras.height,
        )
        self.step += 1
        losses["total_loss"] = total
        return {k: float(v.detach()) for k, v in losses.items()}

    def train(self, num_steps: int, log_every: int = 0) -> dict[str, float]:
        losses: dict[str, float] = {}
        for i in range(num_steps):
            losses = self.train_step()
            if log_every and (i + 1) % log_every == 0:
                print(f"step {self.step}: " + ", ".join(f"{k}={v:.4f}" for k, v in losses.items()))
        return losses

    # ------------------------------------------------------------- rendering
    @torch.no_grad()
    def render_image(
        self, camera_idx: int, background=None, plain: bool = False
    ) -> dict[str, np.ndarray]:
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
            sh_deg=cfg.sh_degree, background=bg, plain=plain,
        )
        return {k: v.cpu().numpy() for k, v in out.items() if k not in ("radii", "visible")}
