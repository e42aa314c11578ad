"""Lie-group exponential maps for camera pose optimization.

Counterpart of ``uncertainty_nerf_gs_tpu/cameras/lie.py``: nerfstudio's
``exp_map_SO3xR3`` / ``exp_map_SE3`` as the camera optimizer uses them.
Tangent vectors are (..., 6) = [translation (3), rotation (3)].

The camera tangents start at exactly zero, so value and gradient at
omega = 0 follow the JAX package's ``_safe_theta``: below the threshold the
Taylor branches are taken, and the square root reads 1.0 instead of
|omega|^2, so that no NaN reaches the gradient through the branch
``torch.where`` does not select.
"""

from __future__ import annotations

import torch


def _skew(v: torch.Tensor) -> torch.Tensor:
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def _safe_theta(omega: torch.Tensor, eps_sq: float):
    """(theta_sq, theta, safe), each (..., 1, 1), with finite gradients at
    omega = 0."""
    theta_sq = torch.sum(omega * omega, dim=-1, keepdim=True)[..., None]
    safe = theta_sq > eps_sq
    theta = torch.sqrt(torch.where(safe, theta_sq, 1.0))
    return theta_sq, theta, safe


def exp_map_SO3(omega: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rodrigues formula: (..., 3) tangent -> (..., 3, 3) rotation."""
    k = _skew(omega)
    theta_sq, theta, safe = _safe_theta(omega, eps * eps)
    a = torch.where(safe, torch.sin(theta) / theta, 1.0 - theta_sq / 6.0)
    b = torch.where(
        safe,
        (1.0 - torch.cos(theta)) / torch.where(safe, theta_sq, 1.0),
        0.5 - theta_sq / 24.0,
    )
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(k.shape)
    return eye + a * k + b * (k @ k)


def exp_map_SO3xR3(tangent: torch.Tensor) -> torch.Tensor:
    """Decoupled rotation and translation: (..., 6) -> (..., 3, 4)."""
    rot = exp_map_SO3(tangent[..., 3:])
    return torch.cat([rot, tangent[..., :3, None]], dim=-1)


def exp_map_SE3(tangent: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Full SE(3) exponential: (..., 6) -> (..., 3, 4), the translation
    coupled through V."""
    rho = tangent[..., :3]
    omega = tangent[..., 3:]
    rot = exp_map_SO3(omega)
    k = _skew(omega)
    theta_sq, theta, safe = _safe_theta(omega, eps * eps)
    safe_sq = torch.where(safe, theta_sq, 1.0)
    b = torch.where(safe, (1.0 - torch.cos(theta)) / safe_sq, 0.5 - theta_sq / 24.0)
    c = torch.where(
        safe,
        (theta - torch.sin(theta)) / (safe_sq * theta),
        1.0 / 6.0 - theta_sq / 120.0,
    )
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(k.shape)
    v = eye + b * k + c * (k @ k)
    t = (v @ rho[..., None])[..., 0]
    return torch.cat([rot, t[..., None]], dim=-1)


def compose_poses(delta: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Apply a (..., 3, 4) correction to a (..., 3, 4) camera-to-world."""
    r = delta[..., :3, :3] @ pose[..., :3, :3]
    t = (delta[..., :3, :3] @ pose[..., :3, 3:])[..., 0] + delta[..., :3, 3]
    return torch.cat([r, t[..., None]], dim=-1)
