"""Spatial distortions and box normalization for unbounded scenes.

Counterpart of ``uncertainty_nerf_gs_tpu/ops/spatial.py``: the Mip-NeRF 360
contraction (L-inf norm by default) maps all space into [-2, 2]^3, and
``contract_to_unit_cube`` then maps it to the hash grid's [0, 1]^3. The
operation order matches the JAX package, so cell floors agree in float32.
"""

from __future__ import annotations

import math

import torch


def scene_contraction(x: torch.Tensor, order: float = math.inf) -> torch.Tensor:
    if order == math.inf:
        mag = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    else:
        mag = torch.linalg.vector_norm(x, ord=order, dim=-1, keepdim=True)
    mag = torch.clamp(mag, min=1e-9)
    contracted = (2.0 - 1.0 / mag) * (x / mag)
    return torch.where(mag <= 1.0, x, contracted)


def contract_to_unit_cube(x: torch.Tensor) -> torch.Tensor:
    """Contract then map [-2, 2]^3 -> [0, 1]^3 (nerfacto hash-grid input)."""
    return (scene_contraction(x) + 2.0) / 4.0


def normalize_aabb(x: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """Map points inside an axis-aligned box (2, 3) [min; max] to [0, 1]^3."""
    return (x - aabb[0]) / (aabb[1] - aabb[0])
