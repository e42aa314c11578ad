"""The benchmark's scene: three soft coloured spheres in the unit box, seen
by Blender-synthetic cameras (800 x 800, ``camera_angle_x`` 0.6911 rad) on
the upper hemisphere, rendered analytically on the card.

A plain copy of the arithmetic of the port's synthetic scene (density 60 x
the largest sigmoid((r - |p - c|) 40), the nearest sphere's colour with
radial shading, a white background as the Blender parser composites it),
at the camera distance of the Blender scenes. A ray is sampled uniformly
along its chord through a ball of radius 1.2 around the spheres (beyond it
the density is below 1e-6); a ray that misses the ball sees the background.
The poses are a golden spiral turned by an angle drawn from the seed; the
training views and the test poses are two spirals of their own.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SPHERES = ((0.0, 0.0, 0.0, 0.35), (0.45, 0.2, -0.1, 0.22), (-0.4, -0.25, 0.15, 0.18))
COLORS = ((0.9, 0.25, 0.2), (0.2, 0.7, 0.9), (0.95, 0.85, 0.2))
SHARPNESS, DENSITY = 40.0, 60.0
BOUND = 1.2  # radius of the ball outside which the density is below 1e-6
_GT_RAYS = 1 << 18  # rays a ground-truth pass takes at once


def seed_of(seed: int, purpose: int) -> int:
    """A 63-bit seed for one use of the run's seed."""
    return int(np.random.SeedSequence([int(seed), purpose]).generate_state(1, np.uint64)[0] >> np.uint64(1))


def hemisphere_poses(num: int, radius: float, seed: int) -> np.ndarray:
    """(num, 3, 4) float32 OpenGL camera-to-world matrices looking at the
    origin from a golden spiral on the upper hemisphere."""
    rng = np.random.default_rng(seed)
    turn = rng.uniform(0.0, 2.0 * math.pi)
    golden = math.pi * (3.0 - math.sqrt(5.0))
    out = []
    for i in range(num):
        elev = 0.15 + 0.75 * ((i + 0.5) / num) * math.pi / 2
        azim = turn + golden * i + rng.uniform(0.0, 0.05)
        eye = radius * np.array([math.cos(azim) * math.cos(elev), math.sin(azim) * math.cos(elev), math.sin(elev)])
        forward = -eye / np.linalg.norm(eye)
        right = np.cross(forward, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, forward)
        out.append(np.concatenate([np.stack([right, up, -forward], axis=-1), eye[:, None]], axis=-1))
    return np.stack(out).astype(np.float32)


def cameras(spec: dict, num: int, seed: int, device) -> dict[str, torch.Tensor | int]:
    """Poses and intrinsics as tensors on ``device``."""
    h, w = spec["height"], spec["width"]
    focal = 0.5 * w / math.tan(0.5 * spec["camera_angle_x"])
    c2w = torch.from_numpy(hemisphere_poses(num, spec["radius"], seed)).to(device)
    full = lambda v: torch.full((num,), float(v), dtype=torch.float32, device=device)  # noqa: E731
    return {"c2w": c2w, "focal": full(focal), "cx": full(w / 2.0), "cy": full(h / 2.0), "height": h, "width": w}


def _shade(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(density, rgb) of the scene at points (..., 3)."""
    occ, scaled = [], []
    for cx, cy, cz, r in SPHERES:
        d = torch.sqrt((p[..., 0] - cx) ** 2 + (p[..., 1] - cy) ** 2 + (p[..., 2] - cz) ** 2)
        occ.append(torch.sigmoid((r - d) * SHARPNESS))
        scaled.append(d / r)
    density = DENSITY * torch.amax(torch.stack(occ, -1), dim=-1)
    scaled = torch.stack(scaled, -1)
    nearest = torch.argmin(scaled, dim=-1)
    base = torch.tensor(COLORS, device=p.device)[nearest]
    shade = 0.6 + 0.4 * torch.clamp(1.0 - torch.amin(scaled, dim=-1), 0.0, 1.0)
    return density, torch.clamp(base * shade[..., None], 0.0, 1.0)


@torch.no_grad()
def render_views(cams: dict, samples: int) -> torch.Tensor:
    """(N, H, W, 3) float32 images of every camera on the white background."""
    c2w = cams["c2w"]
    n, h, w = c2w.shape[0], cams["height"], cams["width"]
    device = c2w.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    steps = (torch.arange(samples, dtype=torch.float32, device=device) + 0.5) / samples
    out = torch.ones((n * h * w, 3), dtype=torch.float32, device=device)
    flat = torch.arange(n * h * w, device=device)
    for s in range(0, n * h * w, _GT_RAYS):
        idx = flat[s:s + _GT_RAYS]
        cam, pix = idx // (h * w), idx % (h * w)
        u = (px[pix] + 0.5 - cams["cx"][cam]) / cams["focal"][cam]
        v = (py[pix] + 0.5 - cams["cy"][cam]) / cams["focal"][cam]
        dirs = torch.einsum("rij,rj->ri", c2w[cam, :, :3], torch.stack([u, -v, -torch.ones_like(u)], -1))
        dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
        origins = c2w[cam, :, 3]
        b = torch.sum(origins * dirs, -1)
        disc = b * b - (torch.sum(origins * origins, -1) - BOUND**2)
        hit = torch.nonzero(disc > 0)[:, 0]
        root = torch.sqrt(disc[hit])
        t0, length = -b[hit] - root, 2.0 * root
        t = t0[:, None] + length[:, None] * steps
        p = origins[hit][:, None, :] + dirs[hit][:, None, :] * t[..., None]
        density, rgb = _shade(p)
        tau = density * (length / samples)[:, None]
        weights = (1.0 - torch.exp(-tau)) * torch.exp(-(torch.cumsum(tau, -1) - tau))
        acc = torch.sum(weights, -1, keepdim=True)
        out[s + hit] = torch.sum(weights[..., None] * rgb, -2) + (1.0 - acc)
    return out.reshape(n, h, w, 3)
