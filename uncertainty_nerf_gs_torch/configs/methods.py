"""Method registry: CLI names -> model configs.

Counterpart of ``uncertainty_nerf_gs_tpu/configs/methods.py`` over the port's
``NerfactoConfig`` and ``SplatfactoConfig``:

  * ``nerfacto``            — plain baseline (trainable, ensemble member)
  * ``active-nerfacto``     — aleatoric RGB variance head
  * ``nerfacto-mcdropout``  — dropout rate 0.2 before the last density/rgb
                              layers
  * ``nerfacto-laplace``    — plain nerfacto + post-hoc diag-GGN posterior
                              (softplus density)
  * ``splatfacto``          — plain 3DGS baseline
  * ``active-splatfacto``   — per-Gaussian log-uncertainty head

Each spec also carries the reference's training-schedule knobs (30k
iterations, 4096 rays a batch, a checkpoint every 2000 steps).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig
from uncertainty_nerf_gs_torch.models.splatfacto import SplatfactoConfig


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    name: str
    family: str  # "nerfacto" | "splatfacto"
    description: str
    model_config: Any
    # trainer schedule (reference TrainerConfig fields)
    max_num_iterations: int = 30_000
    steps_per_save: int = 2_000
    num_rays_per_batch: int = 4_096
    # eval-time knobs
    mc_samples: int = 0  # >0 => MC-dropout inference
    laplace: bool = False
    # the reference trains every nerfacto-family method with an SO3xR3
    # camera optimizer ON (`laplace_config.py:37`, `mcdropout_configs.py:33`,
    # `activenerfacto_config.py:40`); splatfacto's default mode is "off"
    use_camera_optimizer: bool = False


def _nerfacto(**overrides) -> NerfactoConfig:
    return dataclasses.replace(NerfactoConfig(), **overrides)


METHODS: dict[str, MethodSpec] = {
    "nerfacto": MethodSpec(
        name="nerfacto",
        family="nerfacto",
        description="nerfstudio nerfacto baseline (ensemble member)",
        model_config=_nerfacto(),
        use_camera_optimizer=True,
    ),
    "active-nerfacto": MethodSpec(
        name="active-nerfacto",
        family="nerfacto",
        description="nerfacto + aleatoric RGB variance head (ActiveNeRF NLL)",
        model_config=_nerfacto(uncertainty_channels=1),
        use_camera_optimizer=True,
    ),
    "nerfacto-mcdropout": MethodSpec(
        name="nerfacto-mcdropout",
        family="nerfacto",
        description="nerfacto with MC-dropout heads (rate 0.2, last layers)",
        model_config=_nerfacto(
            density_dropout_layers=(-1,),
            rgb_dropout_layers=(-1,),
            dropout_rate=0.2,
        ),
        use_camera_optimizer=True,
        mc_samples=10,
    ),
    "nerfacto-laplace": MethodSpec(
        name="nerfacto-laplace",
        family="nerfacto",
        description="nerfacto + post-hoc linearized-Laplace posterior",
        model_config=_nerfacto(density_activation="softplus"),
        use_camera_optimizer=True,
        laplace=True,
    ),
    "splatfacto": MethodSpec(
        name="splatfacto",
        family="splatfacto",
        description="3D Gaussian Splatting baseline",
        model_config=SplatfactoConfig(),
    ),
    "active-splatfacto": MethodSpec(
        name="active-splatfacto",
        family="splatfacto",
        description="splatfacto + per-Gaussian learned uncertainty",
        model_config=SplatfactoConfig(uncertainty_channels=1),
    ),
}


def get_method(name: str) -> MethodSpec:
    if name not in METHODS:
        raise KeyError(
            f"unknown method {name!r}; available: {sorted(METHODS)}"
        )
    return METHODS[name]
