"""Serving side of the nerfacto trainer: build, restore, render.

Counterpart of ``NerfactoTrainer`` in
``uncertainty_nerf_gs_tpu/engine/trainer.py``, holding what rendering a
trained model needs: the model built on its device, ``restore`` of weights,
and the chunked full-image ``render_image``. The optimizer, the pixel
sampler and the train loop come with the training port.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from uncertainty_nerf_gs_torch.cameras.cameras import Cameras, generate_rays, pixel_grid
from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig, NerfactoModel
from uncertainty_nerf_gs_torch.ops.backend import resolve_device


class NerfactoTrainer:
    """Owns the model and the cameras on one device.

    Args:
      config: model config.
      cameras: the scene's cameras (moved to ``device``).
      seed: seeds the ``torch.Generator`` of the initial weights.
      device: ``None`` is the card; raises when there is none.
    """

    def __init__(
        self,
        config: NerfactoConfig,
        cameras: Cameras,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.config = config
        self.cameras = cameras.to(self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.model = NerfactoModel(config, device=self.device, generator=generator)
        self.model.eval()

    def restore(self, params: Mapping[str, torch.Tensor | np.ndarray]) -> None:
        """Load a full state dict (e.g. ``interop.params_from_jax``)."""
        state = {k: torch.as_tensor(v) for k, v in params.items()}
        self.model.load_state_dict(state, strict=True)

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
