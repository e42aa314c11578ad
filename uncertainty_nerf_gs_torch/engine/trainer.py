"""Training loop and rendering for the nerfacto family.

Counterpart of ``NerfactoTrainer`` in
``uncertainty_nerf_gs_tpu/engine/trainer.py``: per step a batch of rays is
drawn from the images on the device, rays are generated inside the loss so
that the camera optimizer's pose tangents receive gradients, the model's
training forward and ``nerfacto_loss`` run with autograd, and one Adam with
a param group per label (``engine/optimizers.py``) updates the weights.
``render_image`` renders a full image in chunks with the eval forward and
ignores the pose tangents, as the JAX package does.

The batch and the forward's draws come from the trainer's own
``torch.Generator`` (seeded ``seed + 1``; the weights' from ``seed``), so
they are not the JAX package's numbers; the parity tests inject those.
Refused rather than skipped: ``steps_per_launch > 1`` and
``gradient_checkpointing`` (ROADMAP, queue 1, item 7) and the face
consistency loss (item 3).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch

from uncertainty_nerf_gs_torch.cameras.cameras import Cameras, generate_rays, pixel_grid
from uncertainty_nerf_gs_torch.engine.optimizers import (
    OptimizerGroupConfig,
    apply_updates,
    label_params,
    make_optimizer,
)
from uncertainty_nerf_gs_torch.models.nerfacto import (
    NerfactoConfig,
    NerfactoModel,
    nerfacto_loss,
    proposal_anneal_factor,
)
from uncertainty_nerf_gs_torch.ops.backend import resolve_device


class NerfactoTrainer:
    """Owns the model, the cameras, the images and the optimizer on one
    device.

    Args:
      config: model config.
      cameras: the scene's cameras (moved to ``device``).
      images: (N, H, W, 3) float32 in [0, 1], one per camera; ``None``
        builds a trainer that only renders.
      seed: seeds the ``torch.Generator`` of the initial weights; ``seed +
        1`` seeds the batches and draws.
      use_camera_optimizer: adds ``camera_opt``, an (N, 6) SO3xR3 pose
        tangent leaf starting at zero, as its own param group.
      optimizer_groups: per-group configs (``DEFAULT_GROUPS`` if None).
      masks: (N, H, W) bool, True for pixels the sampler may draw.
      device: ``None`` is the card; raises when there is none.
    """

    def __init__(
        self,
        config: NerfactoConfig,
        cameras: Cameras,
        images: np.ndarray | None = None,
        seed: int = 0,
        use_camera_optimizer: bool = False,
        optimizer_groups: Mapping[str, OptimizerGroupConfig] | None = None,
        masks: np.ndarray | None = None,
        gradient_checkpointing: bool = False,
        device: str | torch.device | None = None,
    ):
        if gradient_checkpointing:
            raise NotImplementedError(
                "gradient_checkpointing is not ported yet (ROADMAP, queue 1, item 7)"
            )
        if config.face_consistency_mult > 0.0:
            raise NotImplementedError(
                "face_consistency_loss is not ported yet (ROADMAP, queue 1, item 3)"
            )
        self.device = resolve_device(device)
        self.config = config
        self.cameras = cameras.to(self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.model = NerfactoModel(config, device=self.device, generator=generator)
        self.model.eval()
        self._generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.images = (
            None if images is None
            else torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        )
        self._valid_coords = None
        if masks is not None:
            # the valid (cam, y, x) triples; masked sampling draws uniformly
            # from them, as nerfstudio's PixelSampler does
            valid = torch.nonzero(torch.as_tensor(np.asarray(masks, bool), device=self.device))
            if valid.shape[0] == 0:
                raise ValueError("masks exclude every pixel")
            self._valid_coords = valid
        self.camera_opt = (
            torch.zeros((len(cameras), 6), device=self.device, requires_grad=True)
            if use_camera_optimizer else None
        )
        self.optimizer_groups = optimizer_groups
        self.optimizer = make_optimizer(self.params(), optimizer_groups)
        self.step = 0

    def params(self) -> dict[str, torch.Tensor]:
        """Every trained leaf by name: the model's state-dict names, and
        ``camera_opt`` with the camera optimizer."""
        params = dict(self.model.named_parameters())
        if self.camera_opt is not None:
            params["camera_opt"] = self.camera_opt
        return params

    # --------------------------------------------------------------- resume
    def state_dict(self) -> dict[str, Any]:
        """Resumable training state: ``params`` (detached views, by name),
        ``opt_state`` (per group the Adam count and the schedule's count;
        per parameter Adam's first and second moments, zeros before the
        first step) and ``step``."""
        params = self.params()
        groups = {}
        for group in self.optimizer.param_groups:
            st = self.optimizer.state.get(group["params"][0], {})
            groups[group["name"]] = {
                "adam_count": int(st["step"]) if st else 0,
                "schedule_count": group["count"],
            }
        moments: dict[str, dict[str, torch.Tensor]] = {"exp_avg": {}, "exp_avg_sq": {}}
        for name, p in params.items():
            st = self.optimizer.state.get(p, {})
            for key, out in moments.items():
                out[name] = st[key].detach() if st else torch.zeros_like(p.detach())
        return {
            "params": {k: v.detach() for k, v in params.items()},
            "opt_state": {"groups": groups, **moments},
            "step": self.step,
        }

    def restore(self, ckpt: Mapping[str, Any]) -> None:
        """Load ``state_dict()`` output (or ``interop.trainer_state_from_jax``
        of the JAX trainer's). ``params`` holds every parameter (e.g.
        ``interop.params_from_jax`` of a flax tree, plus ``camera_opt`` with
        the camera optimizer); without ``opt_state`` the Adam state starts
        fresh, without ``step`` at 0."""
        params = {k: torch.as_tensor(v) for k, v in ckpt["params"].items()}
        camera_opt = params.pop("camera_opt", None)
        if (camera_opt is None) != (self.camera_opt is None):
            raise ValueError("camera_opt must be in params exactly when the camera optimizer is on")
        self.model.load_state_dict(params, strict=True)
        with torch.no_grad():
            if camera_opt is not None:
                self.camera_opt.copy_(camera_opt)
        self.optimizer = make_optimizer(self.params(), self.optimizer_groups)
        opt_state = ckpt.get("opt_state")
        if opt_state is not None:
            labels = label_params(self.params())
            for group in self.optimizer.param_groups:
                group["count"] = int(opt_state["groups"][group["name"]]["schedule_count"])
            for name, p in self.params().items():
                count = opt_state["groups"][labels[name]]["adam_count"]
                self.optimizer.state[p] = {
                    # torch.optim.Adam's own layout: a float32 step on the host
                    "step": torch.tensor(float(count), dtype=torch.float32),
                    "exp_avg": torch.as_tensor(opt_state["exp_avg"][name]).to(self.device).clone(),
                    "exp_avg_sq": torch.as_tensor(opt_state["exp_avg_sq"][name]).to(self.device).clone(),
                }
        self.step = int(ckpt.get("step", 0))

    # ------------------------------------------------------------------ data
    def sample_batch(self, num_rays: int) -> dict[str, torch.Tensor]:
        """Uniform over cameras and pixels, or with masks uniform over the
        valid-pixel list, from the trainer's generator."""
        if self.images is None:
            raise ValueError("this trainer was built without images")
        n, h, w = self.images.shape[:3]
        gen = self._generator

        def randint(high):
            return torch.randint(0, high, (num_rays,), generator=gen, device=self.device)

        if self._valid_coords is not None:
            rows = self._valid_coords[randint(self._valid_coords.shape[0])]
            cam_idx, py, px = rows[:, 0], rows[:, 1], rows[:, 2]
        else:
            cam_idx, px, py = randint(n), randint(w), randint(h)
        return {
            "camera_indices": cam_idx,
            "pixel_x": px.to(torch.float32),
            "pixel_y": py.to(torch.float32),
            "image": self.images[cam_idx, py, px],
        }

    # ------------------------------------------------------------------ step
    def _loss_fn(
        self, batch: Mapping[str, torch.Tensor], step: int, draws: dict[str, Any] | None = None
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Total loss and its terms at the current weights, with autograd.
        ``draws`` (``NerfactoModel.draw``'s layout) replaces the generator's."""
        rb = generate_rays(
            self.cameras,
            batch["camera_indices"],
            batch["pixel_x"],
            batch["pixel_y"],
            pose_adjustment=self.camera_opt,
        )
        outputs = self.model(
            rb, train=True, proposal_anneal=proposal_anneal_factor(step, self.config),
            generator=self._generator, draws=draws,
        )
        return nerfacto_loss(outputs, batch, self.config)

    def train_step(self, num_rays_per_batch: int = 4096) -> dict[str, float]:
        """One step: a batch, the loss, its gradients, one update."""
        batch = self.sample_batch(num_rays_per_batch)
        self.optimizer.zero_grad(set_to_none=True)
        total, losses = self._loss_fn(batch, self.step)
        total.backward()
        apply_updates(self.optimizer)
        self.step += 1
        losses["total_loss"] = total
        return {k: float(v.detach()) for k, v in losses.items()}

    def train(
        self,
        num_steps: int,
        num_rays_per_batch: int = 4096,
        log_every: int = 0,
        callback: Callable[[int, dict], None] | None = None,
        writer=None,
        steps_per_launch: int = 1,
    ) -> dict[str, float]:
        """``num_steps`` steps; ``writer.write(step, losses)`` every 10th and
        the last, ``callback(i, losses)`` after each."""
        if steps_per_launch > 1:
            raise NotImplementedError(
                "steps_per_launch > 1 is not ported yet (ROADMAP, queue 1, item 7)"
            )
        losses: dict[str, float] = {}
        for i in range(num_steps):
            losses = self.train_step(num_rays_per_batch)
            if writer is not None and (i % 10 == 0 or i == num_steps - 1):
                writer.write(self.step, losses)
            if log_every and (i + 1) % log_every == 0:
                print(f"step {i + 1}: " + ", ".join(f"{k}={v:.4f}" for k, v in losses.items()))
            if callback is not None:
                callback(i, losses)
        return losses

    # ------------------------------------------------------------- rendering
    @torch.no_grad()
    def render_image(self, camera_idx: int, chunk: int | None = None) -> dict[str, np.ndarray]:
        """Full-image render in fixed-size ray chunks. The last chunk is
        padded with pixel (0, 0), as in the JAX package, and cut off after."""
        chunk = chunk or self.config.eval_num_rays_per_chunk
        h, w = self.cameras.height, self.cameras.width
        px, py = pixel_grid(h, w, self.device)
        total = h * w
        pad = (-total) % chunk
        zeros = torch.zeros(pad, dtype=torch.float32, device=self.device)
        px = torch.cat([px, zeros])
        py = torch.cat([py, zeros])
        idx = torch.full((total + pad,), camera_idx, dtype=torch.int64, device=self.device)
        outs: dict[str, list[torch.Tensor]] = {}
        for start in range(0, total + pad, chunk):
            rb = generate_rays(
                self.cameras,
                idx[start : start + chunk],
                px[start : start + chunk],
                py[start : start + chunk],
            )
            for k, v in self.model(rb).items():
                if k != "density_mean":
                    outs.setdefault(k, []).append(v)
        images = {}
        for k, parts in outs.items():
            flat = torch.cat(parts, dim=0)[:total].cpu().numpy()
            images[k] = flat.reshape((h, w) + flat.shape[1:])
        return images
