"""Analytic synthetic scenes and the dataset writers.

Counterpart of ``uncertainty_nerf_gs_tpu/data/synthetic.py``: three coloured
soft spheres in the unit box, volume-rendered densely against the analytic
density and colour (``render_ground_truth``, ``make_dataset``), written as a
Blender-synthetic tree (``write_blender_dataset``) or a COLMAP-processed
nerfstudio capture with distortion, per-frame intrinsics, an
``applied_transform`` and a binary PLY of seed points
(``write_nerfstudio_dataset``). The numpy parts (cameras, seed points) are
the JAX package's arithmetic, so both packages write the same poses and
points from the same arguments; the images go through the port's ray
generation, uniform sampler and renderers (within 2e-5 of the JAX
package's) and its PNG encoder. ``device=None`` renders on the card.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import torch

from uncertainty_nerf_gs_torch.cameras.cameras import Cameras, generate_rays, pixel_grid
from uncertainty_nerf_gs_torch.data.png import write_png
from uncertainty_nerf_gs_torch.ops.backend import resolve_device
from uncertainty_nerf_gs_torch.ops.raymarch import (
    render_accumulation,
    render_expected_depth,
    render_rgb,
    render_weights,
)
from uncertainty_nerf_gs_torch.ops.sampling import sample_uniform, spacing_uniform, spacing_uniform_inv

# scene: three colored soft spheres
_SPHERES = np.array(
    [  # cx, cy, cz, radius
        [0.0, 0.0, 0.0, 0.35],
        [0.45, 0.2, -0.1, 0.22],
        [-0.4, -0.25, 0.15, 0.18],
    ],
    dtype=np.float32,
)
_COLORS = np.array(
    [[0.9, 0.25, 0.2], [0.2, 0.7, 0.9], [0.95, 0.85, 0.2]], dtype=np.float32
)
_SHARPNESS = 40.0
_DENSITY = 60.0
# rays a ground-truth render takes at once (bounds the (rays, 256, 3, 3)
# distance tensor)
_GT_CHUNK = 1 << 14


def scene_density(p: torch.Tensor) -> torch.Tensor:
    """Analytic density at points (..., 3)."""
    centers = torch.as_tensor(_SPHERES[:, :3], device=p.device)
    radii = torch.as_tensor(_SPHERES[:, 3], device=p.device)
    d = torch.linalg.vector_norm(p[..., None, :] - centers, dim=-1)  # (..., K)
    occ = torch.sigmoid((radii - d) * _SHARPNESS)
    return _DENSITY * torch.amax(occ, dim=-1)


def scene_rgb(p: torch.Tensor) -> torch.Tensor:
    """Analytic colour: the nearest sphere's colour with radial shading."""
    centers = torch.as_tensor(_SPHERES[:, :3], device=p.device)
    radii = torch.as_tensor(_SPHERES[:, 3], device=p.device)
    colors = torch.as_tensor(_COLORS, device=p.device)
    d = torch.linalg.vector_norm(p[..., None, :] - centers, dim=-1) / radii
    base = colors[torch.argmin(d, dim=-1)]
    shade = 0.6 + 0.4 * torch.clamp(1.0 - torch.amin(d, dim=-1), 0.0, 1.0)
    return torch.clamp(base * shade[..., None], 0.0, 1.0)


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


@torch.no_grad()
def _render_gt(cameras: Cameras, camera_idx: int, num_samples: int, near: float, far: float,
               white_background: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    device = cameras.camera_to_worlds.device
    px, py = pixel_grid(cameras.height, cameras.width, device)
    bg = torch.ones(3, device=device) if white_background else torch.zeros(3, device=device)
    parts = []
    for s in range(0, px.shape[0], _GT_CHUNK):
        x, y = px[s:s + _GT_CHUNK], py[s:s + _GT_CHUNK]
        idx = torch.full(x.shape, camera_idx, dtype=torch.int64, device=device)
        rb = generate_rays(cameras, idx, x, y)
        rb = rb._replace(nears=torch.full_like(rb.nears, near), fars=torch.full_like(rb.fars, far))
        rs = sample_uniform(rb, num_samples, spacing_fn=spacing_uniform, spacing_fn_inv=spacing_uniform_inv)
        weights = render_weights(scene_density(rs.positions), rs.deltas)
        parts.append((render_rgb(weights, scene_rgb(rs.positions), bg),
                      render_expected_depth(weights, rs.midpoints), render_accumulation(weights)))
    return tuple(torch.cat(p) for p in zip(*parts))


def render_ground_truth(
    cameras: Cameras,
    camera_idx: int,
    num_samples: int = 256,
    near: float = 0.5,
    far: float = 4.5,
    white_background: bool = True,
    device: str | torch.device | None = None,
):
    """Dense analytic volume render -> (H, W, 3) rgb, (H, W) depth, acc as
    numpy arrays."""
    h, w = cameras.height, cameras.width
    rgb, depth, acc = _render_gt(cameras.to(resolve_device(device)), camera_idx, num_samples, near, far,
                                 white_background)
    return (rgb.cpu().numpy().reshape(h, w, 3), depth.cpu().numpy().reshape(h, w),
            acc.cpu().numpy().reshape(h, w))


def make_dataset(
    num_cameras: int = 10, height: int = 64, width: int = 64,
    device: str | torch.device | None = None, **kwargs
) -> tuple[Cameras, np.ndarray, np.ndarray]:
    """Cameras + stacked GT images (N, H, W, 3) + depths (N, H, W)."""
    cameras = hemisphere_cameras(num_cameras, height, width, **kwargs)
    images, depths = [], []
    for i in range(num_cameras):
        rgb, depth, _ = render_ground_truth(cameras, i, device=device)
        images.append(rgb)
        depths.append(depth)
    return cameras, np.stack(images), np.stack(depths)


def write_blender_dataset(
    root: Path | str,
    num_train: int = 8,
    num_test: int = 4,
    height: int = 64,
    width: int = 64,
    write_depth: bool = True,
    device: str | torch.device | None = None,
) -> Path:
    """Write the scene as a Blender-synthetic dataset tree:
    ``transforms_{split}.json`` with ``camera_angle_x`` and per-frame
    ``file_path`` (no extension) + ``transform_matrix`` (4x4 OpenGL c2w),
    images under ``<split>/r_{i}.png``, optional test-split depth
    ``r_{i}_depth_0001.png``."""
    root = Path(root)
    total = num_train + num_test
    cameras, images, depths = make_dataset(total, height, width, device=device)
    focal = float(cameras.fx[0])
    camera_angle_x = 2.0 * math.atan(width / (2.0 * focal))

    splits = {"train": range(num_train), "test": range(num_train, total)}
    splits["val"] = splits["test"]
    for split, idxs in splits.items():
        (root / split).mkdir(parents=True, exist_ok=True)
        frames = []
        for j, i in enumerate(idxs):
            name = f"r_{j}"
            write_png(root / split / f"{name}.png", (images[i] * 255).astype(np.uint8))
            if write_depth and split == "test":
                d = depths[i]
                write_png(root / split / f"{name}_depth_0001.png",
                          (np.clip(d / d.max(), 0, 1) * 255).astype(np.uint8))
            c2w = cameras.camera_to_worlds[i].numpy()
            mat = np.concatenate([c2w, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)
            frames.append({"file_path": f"./{split}/{name}", "transform_matrix": mat.tolist()})
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f, indent=1)
    return root


# The COLMAP->nerfstudio axis permutation ns-process-data records as
# `applied_transform` (an involution: A @ A == I).
_APPLIED_TRANSFORM = np.array(
    [[0.0, 1.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0], [0.0, 0.0, -1.0, 0.0]],
    dtype=np.float64,
)


def write_nerfstudio_dataset(
    root: Path | str,
    num_frames: int = 10,
    height: int = 24,
    width: int = 24,
    k1: float = 1e-3,
    p1: float = 2e-4,
    num_points: int = 240,
    seed: int = 0,
    applied_transform: bool = True,
    device: str | torch.device | None = None,
) -> Path:
    """Write the scene as a COLMAP-processed nerfstudio capture tree: one
    ``transforms.json`` with global ``cx/cy/w/h`` and OPENCV distortion
    (``k1``/``p1``) and per-frame ``fl_x``/``fl_y``; images under
    ``images/frame_XXXXX.png``; an ``applied_transform`` and a
    ``binary_little_endian`` ``sparse_pc.ply`` of seed points stored in the
    pre-applied (COLMAP) frame. The images are rendered through the
    distortion model; the world-space seed points are saved as
    ``points_world.npy`` beside the tree."""
    root = Path(root)
    (root / "images").mkdir(parents=True, exist_ok=True)
    base = hemisphere_cameras(num_frames, height, width)
    # per-frame focal spread (COLMAP per-image intrinsics); distortion on
    focal = float(base.fx[0])
    fx = focal * (1.0 + 0.04 * np.arange(num_frames) / max(num_frames - 1, 1))
    dist = np.tile(np.array([[k1, 0.0, 0.0, 0.0, p1, 0.0]], np.float32), (num_frames, 1))
    cams = dataclasses.replace(
        base,
        fx=torch.as_tensor(fx, dtype=torch.float32),
        fy=torch.as_tensor(fx, dtype=torch.float32),
        distortion_params=torch.from_numpy(dist),
    )

    frames = []
    for i in range(num_frames):
        rgb, _, _ = render_ground_truth(cams, i, device=device)
        name = f"images/frame_{i:05d}.png"
        write_png(root / name, (rgb * 255).astype(np.uint8))
        c2w = cams.camera_to_worlds[i].numpy().astype(np.float64)
        mat = np.concatenate([c2w, [[0.0, 0.0, 0.0, 1.0]]], axis=0)
        frames.append({
            "file_path": name,
            "transform_matrix": mat.tolist(),
            "fl_x": float(fx[i]),
            "fl_y": float(fx[i]),
        })

    # SfM seed points on the analytic sphere surfaces (world frame),
    # stored in the PLY pre-applied: p_ply = A @ p_world (A involution)
    rng = np.random.default_rng(seed)
    per = num_points // len(_SPHERES)
    pts_w, cols = [], []
    for (cx_, cy_, cz_, r), col in zip(_SPHERES, _COLORS):
        n = rng.normal(size=(per, 3))
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        pts_w.append(np.array([cx_, cy_, cz_]) + r * n)
        cols.append(np.tile((col * 255).astype(np.uint8), (per, 1)))
    pts_w = np.concatenate(pts_w).astype(np.float64)
    cols = np.concatenate(cols)
    np.save(root / "points_world.npy", pts_w.astype(np.float32))
    if applied_transform:
        a_h = np.concatenate([_APPLIED_TRANSFORM, [[0.0, 0.0, 0.0, 1.0]]], axis=0)
        pts_ply = (np.linalg.inv(a_h)[:3, :3] @ pts_w.T).T.astype(np.float32)
    else:  # no applied_transform recorded: PLY already in world frame
        pts_ply = pts_w.astype(np.float32)
    dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                   ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec = np.empty(len(pts_ply), dtype=dt)
    rec["x"], rec["y"], rec["z"] = pts_ply.T
    rec["red"], rec["green"], rec["blue"] = cols.T
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(rec)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    with open(root / "sparse_pc.ply", "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())

    meta = {
        "camera_model": "OPENCV",
        "cx": width / 2.0,
        "cy": height / 2.0,
        "w": width,
        "h": height,
        "k1": k1,
        "k2": 0.0,
        "p1": p1,
        "p2": 0.0,
        "ply_file_path": "sparse_pc.ply",
        "frames": frames,
    }
    if applied_transform:
        meta["applied_transform"] = _APPLIED_TRANSFORM.tolist()
    with open(root / "transforms.json", "w") as f:
        json.dump(meta, f, indent=1)
    return root
