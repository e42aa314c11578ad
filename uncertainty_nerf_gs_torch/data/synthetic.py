"""Synthetic cameras for tests and the chip smoke run.

Counterpart of ``hemisphere_cameras`` in
``uncertainty_nerf_gs_tpu/data/synthetic.py``: the same numpy arithmetic, so
both packages get identical poses from the same arguments.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from uncertainty_nerf_gs_torch.cameras.cameras import Cameras


def hemisphere_cameras(
    num_cameras: int,
    height: int = 64,
    width: int = 64,
    radius: float = 2.2,
    full_sphere_x: bool = False,
    focal_mult: float = 1.2,
    seed: int = 0,
) -> Cameras:
    """Look-at cameras on a (hemi)sphere around the origin (Blender-style),
    as CPU tensors."""
    rng = np.random.default_rng(seed)
    golden = math.pi * (3.0 - math.sqrt(5.0))
    c2ws = []
    for i in range(num_cameras):
        # evenly spread on the upper hemisphere via golden spiral
        z = (i + 0.5) / num_cameras
        elev = 0.15 + 0.75 * z * math.pi / 2
        azim = golden * i + rng.uniform(0, 0.05)
        x = math.cos(azim) * math.cos(elev)
        y = math.sin(azim) * math.cos(elev)
        zz = math.sin(elev)
        eye = np.array([x, y, zz]) * radius
        if full_sphere_x and i % 2 == 1:
            eye[0] = -abs(eye[0])
        # OpenGL look-at: camera -z points to origin
        forward = -eye / np.linalg.norm(eye)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)
        true_up = np.cross(right, forward)
        rot = np.stack([right, true_up, -forward], axis=-1)  # columns x,y,z
        c2ws.append(np.concatenate([rot, eye[:, None]], axis=-1))
    c2ws = np.stack(c2ws).astype(np.float32)
    focal = focal_mult * max(height, width)
    n = num_cameras
    return Cameras(
        camera_to_worlds=torch.from_numpy(c2ws),
        fx=torch.full((n,), focal, dtype=torch.float32),
        fy=torch.full((n,), focal, dtype=torch.float32),
        cx=torch.full((n,), width / 2.0, dtype=torch.float32),
        cy=torch.full((n,), height / 2.0, dtype=torch.float32),
        width=width,
        height=height,
    )
