"""3D Gaussian geometry: quaternion rotations, covariances, EWA projection.

Counterpart of ``uncertainty_nerf_gs_tpu/ops/gaussians.py``, the same
arithmetic in PyTorch. Projection is elementwise per Gaussian, so plain
tensor code serves it on the card; there is no kernel here.

Conventions (gsplat's):
  * quats are (w, x, y, z), not necessarily normalized;
  * scales are linear (callers exponentiate stored log-scales);
  * viewmat is world->camera (R|t), OpenCV convention (+z forward);
  * the 2D covariance gets the +0.3 px low-pass dilation with the matching
    density "compensation" factor sqrt(det(S) / det(S + 0.3 I)).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """(N, 4) wxyz quaternions -> (N, 3, 3) rotation matrices."""
    # rsqrt(sum + eps) instead of the norm: zero (dead-slot) quats must get
    # finite gradients, and d||q||/dq is NaN at q = 0
    q = quats * torch.rsqrt(torch.sum(quats * quats, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y**2 + z**2), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x**2 + z**2), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x**2 + y**2)], -1),
        ],
        dim=-2,
    )


def scale_rot_to_cov3d(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """S = (R S)(R S)^T from (N, 3) linear scales and (N, 4) quats."""
    m = quat_to_rotmat(quats) * scales[..., None, :]
    return m @ m.transpose(-1, -2)


class Projection(NamedTuple):
    """Per-Gaussian screen-space quantities (all leading dim N)."""

    means2d: torch.Tensor  # (N, 2) pixel coords
    depths: torch.Tensor  # (N,) camera-space z
    conics: torch.Tensor  # (N, 3) upper triangle (a, b, c) of the inverse 2D cov
    radii: torch.Tensor  # (N,) float 3-sigma pixel radius (0 for culled)
    compensation: torch.Tensor  # (N,) density compensation of the dilation
    valid: torch.Tensor  # (N,) bool: in front of the camera, finite footprint


def project_gaussians(
    means: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    viewmat: torch.Tensor,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    width: int,
    height: int,
    near: float = 0.01,
    eps2d: float = 0.3,
) -> Projection:
    """EWA-project (N,) Gaussians into one camera; viewmat (4, 4)
    world->camera."""
    r_wc = viewmat[:3, :3]
    t_wc = viewmat[:3, 3]
    p_cam = means @ r_wc.T + t_wc  # (N, 3)
    z = p_cam[..., 2]
    in_front = z > near
    zs = torch.clamp(z, min=near)  # safe z for culled points

    x_ndc = p_cam[..., 0] / zs
    y_ndc = p_cam[..., 1] / zs
    # gsplat clips the Jacobian footprint at 1.3 * tan(fov / 2)
    tan_x = 0.5 * width / fx
    tan_y = 0.5 * height / fy
    tx = torch.clamp(x_ndc, -1.3 * tan_x, 1.3 * tan_x)
    ty = torch.clamp(y_ndc, -1.3 * tan_y, 1.3 * tan_y)
    means2d = torch.stack([fx * x_ndc + cx, fy * y_ndc + cy], dim=-1)

    cov3d = scale_rot_to_cov3d(scales, quats)  # (N, 3, 3)
    cov_cam = r_wc[None] @ cov3d @ r_wc.T[None]

    # Jacobian of pixel coords wrt camera coords at the clipped point
    zero = torch.zeros_like(zs)
    jac = torch.stack(
        [
            torch.stack([fx / zs, zero, -fx * tx / zs], -1),
            torch.stack([zero, fy / zs, -fy * ty / zs], -1),
        ],
        dim=-2,
    )  # (N, 2, 3)
    cov2d = jac @ cov_cam @ jac.transpose(-1, -2)  # (N, 2, 2)

    det_orig = cov2d[..., 0, 0] * cov2d[..., 1, 1] - cov2d[..., 0, 1] ** 2
    cov2d = cov2d + eps2d * torch.eye(2, dtype=cov2d.dtype, device=cov2d.device)
    det = cov2d[..., 0, 0] * cov2d[..., 1, 1] - cov2d[..., 0, 1] ** 2
    det_safe = torch.clamp(det, min=1e-12)
    # safe sqrt by a double where: a collapsed Gaussian (det_orig <= 0 in
    # float32) gets compensation 0 with a zero, not NaN, gradient
    ratio = det_orig / det_safe
    ratio_ok = ratio > 1e-6
    compensation = torch.where(
        ratio_ok, torch.sqrt(torch.where(ratio_ok, ratio, torch.ones_like(ratio))),
        torch.zeros_like(ratio),
    )

    inv_det = 1.0 / det_safe
    conics = torch.stack(
        [cov2d[..., 1, 1] * inv_det, -cov2d[..., 0, 1] * inv_det, cov2d[..., 0, 0] * inv_det],
        dim=-1,
    )

    # 3-sigma radius from the larger eigenvalue of cov2d
    mid = 0.5 * (cov2d[..., 0, 0] + cov2d[..., 1, 1])
    lam1 = mid + torch.sqrt(torch.clamp(mid**2 - det, min=0.01))
    radii = 3.0 * torch.sqrt(torch.clamp(lam1, min=0.0))

    valid = in_front & (det > 0.0) & (radii > 0.0)
    inside = (
        (means2d[..., 0] + radii > 0)
        & (means2d[..., 0] - radii < width)
        & (means2d[..., 1] + radii > 0)
        & (means2d[..., 1] - radii < height)
    )
    valid = valid & inside
    radii = torch.where(valid, radii, torch.zeros_like(radii))
    return Projection(
        means2d=means2d, depths=z, conics=conics, radii=radii,
        compensation=compensation, valid=valid,
    )
