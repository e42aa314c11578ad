"""Cameras and ray generation.

Counterpart of ``uncertainty_nerf_gs_tpu/cameras/cameras.py``. ``Cameras``
holds one entry per image; pixel -> ray math follows the OpenGL convention of
Blender/nerfstudio ``transforms.json`` (x right, y up, camera looks along
-z). Camera models: perspective (optional Brown-Conrady distortion, inverted
iteratively) and fisheye (equidistant). A camera optimizer's (N, 6) pose
tangents adjust each image's camera-to-world (``cameras/lie.py``), with
gradients into the tangents.
"""

from __future__ import annotations

import dataclasses

import torch

from uncertainty_nerf_gs_torch.cameras.lie import compose_poses, exp_map_SE3, exp_map_SO3xR3
from uncertainty_nerf_gs_torch.ops.sampling import RayBundle

PERSPECTIVE = 0
FISHEYE = 1


@dataclasses.dataclass
class Cameras:
    """Batched cameras: the leading axis is the image index."""

    camera_to_worlds: torch.Tensor  # (N, 3, 4) OpenGL c2w
    fx: torch.Tensor  # (N,)
    fy: torch.Tensor  # (N,)
    cx: torch.Tensor  # (N,)
    cy: torch.Tensor  # (N,)
    width: int
    height: int
    distortion_params: torch.Tensor | None = None  # (N, 6) k1..k4, p1, p2
    camera_type: int = PERSPECTIVE

    def __len__(self) -> int:
        return self.camera_to_worlds.shape[0]

    def to(self, device: torch.device | str) -> Cameras:
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **moved)


def _radial_tangential_undistort(
    x: torch.Tensor, y: torch.Tensor, d: torch.Tensor, iters: int = 3
) -> tuple[torch.Tensor, torch.Tensor]:
    """Iteratively invert the Brown-Conrady distortion (k1,k2,k3,k4,p1,p2)."""
    k1, k2, k3, k4, p1, p2 = (d[..., i] for i in range(6))
    xu, yu = x, y
    for _ in range(iters):
        r2 = xu * xu + yu * yu
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
        dx = 2.0 * p1 * xu * yu + p2 * (r2 + 2.0 * xu * xu)
        dy = p1 * (r2 + 2.0 * yu * yu) + 2.0 * p2 * xu * yu
        xu = (x - dx) / radial
        yu = (y - dy) / radial
    return xu, yu


def generate_rays(
    cameras: Cameras,
    camera_indices: torch.Tensor,
    pixel_x: torch.Tensor,
    pixel_y: torch.Tensor,
    pose_adjustment: torch.Tensor | None = None,
    pose_adjustment_mode: str = "SO3xR3",
) -> RayBundle:
    """Rays through pixel centers: (R,) image indices and pixel column/row
    -> RayBundle with unit directions and 0 / 1e10 near/far placeholders
    (the model overrides them with its planes). ``pose_adjustment``: (N, 6)
    camera-optimizer tangents, applied to each ray's camera as nerfstudio's
    CameraOptimizer does (``"SO3xR3"``, else the SE(3) exponential)."""
    camera_indices = camera_indices.to(torch.int64)
    c2w = cameras.camera_to_worlds[camera_indices]  # (R, 3, 4)
    if pose_adjustment is not None:
        tangent = pose_adjustment[camera_indices]
        if pose_adjustment_mode == "SO3xR3":
            delta = exp_map_SO3xR3(tangent)
        else:
            delta = exp_map_SE3(tangent)
        c2w = compose_poses(delta, c2w)
    fx = cameras.fx[camera_indices]
    fy = cameras.fy[camera_indices]
    cx = cameras.cx[camera_indices]
    cy = cameras.cy[camera_indices]

    # pixel center offset +0.5
    u = (pixel_x.to(torch.float32) + 0.5 - cx) / fx
    v = (pixel_y.to(torch.float32) + 0.5 - cy) / fy

    if cameras.distortion_params is not None:
        d = cameras.distortion_params[camera_indices]
        u, v = _radial_tangential_undistort(u, v, d)

    if cameras.camera_type == FISHEYE:
        theta = torch.clamp(torch.sqrt(u * u + v * v), min=1e-9)
        sin_over_theta = torch.sin(theta) / theta
        dirs_cam = torch.stack(
            [u * sin_over_theta, -v * sin_over_theta, -torch.cos(theta)], dim=-1
        )
    else:
        # OpenGL: +x right, +y up, looking down -z; image y grows downward
        dirs_cam = torch.stack([u, -v, -torch.ones_like(u)], dim=-1)

    dirs_world = torch.einsum("rij,rj->ri", c2w[..., :3, :3], dirs_cam)
    dirs_world = dirs_world / torch.linalg.vector_norm(
        dirs_world, dim=-1, keepdim=True
    )
    return RayBundle(
        origins=c2w[..., :3, 3],
        directions=dirs_world,
        nears=torch.zeros_like(u),
        fars=torch.full_like(u, 1e10),
        camera_indices=camera_indices,
    )


def pixel_grid(
    height: int, width: int, device: torch.device | str = "cpu"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-image pixel coordinate grid, flattened row-major: (H*W,) x, y."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return xs.reshape(-1), ys.reshape(-1)
