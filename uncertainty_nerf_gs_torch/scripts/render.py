"""`ut-render` on the card: render a camera trajectory from a trained run.

Counterpart of ``uncertainty_nerf_gs_tpu/scripts/render.py``, with its
flags and files: RGB (and depth and, for uncertainty methods, std maps)
along a generated path, written as PNG frames, one animated GIF per output
and ``trajectory.json``. Trajectories: ``orbit``, a circle at the mean
camera radius and height looking at the cameras' mean position;
``interpolate``, positions interpolated through the run's eval cameras,
always looking at that point. The frames render through the eval CLI's
``build_render_fn`` (the method's own predictive path, splats included).

The card's machine has no PIL: the PNGs go through ``data/png.py``, the
GIFs through ``data/gif.py``. Jet-coloured frames use the 256-entry jet
table as their palette and are exact; RGB frames use ``data/gif.py``'s
uniform palette of 6 x 7 x 6 levels, each channel at most
``UNIFORM_BOUND`` (25) from the PNG frame's (the JAX package lets PIL pick
an adaptive palette a frame). ``--device`` (an addition: the card by
default) takes ``cpu`` for a try without one.

Usage:
    python -m uncertainty_nerf_gs_torch.scripts.render --load-config outputs/run1 \\
        --output-dir renders/ --traj orbit --num-frames 60
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from uncertainty_nerf_gs_torch.cameras.cameras import Cameras
from uncertainty_nerf_gs_torch.data.gif import write_gif
from uncertainty_nerf_gs_torch.data.png import write_png
from uncertainty_nerf_gs_torch.ops.backend import resolve_device
from uncertainty_nerf_gs_torch.utils.colormaps import TABLES
from uncertainty_nerf_gs_torch.utils.images import colorize as _colorize
from uncertainty_nerf_gs_torch.utils.images import to_u8 as _to_u8


def _look_at(origin: np.ndarray, target: np.ndarray, up=(0.0, 0.0, 1.0)):
    """OpenGL c2w (3, 4): camera at origin looking at target."""
    forward = target - origin
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, np.float64))
    nr = np.linalg.norm(right)
    if nr < 1e-8:  # looking along up: pick another basis
        right = np.cross(forward, np.array([0.0, 1.0, 0.0]))
        nr = np.linalg.norm(right)
    right = right / nr
    true_up = np.cross(right, forward)
    c2w = np.zeros((3, 4), np.float32)
    c2w[:, 0], c2w[:, 1], c2w[:, 2], c2w[:, 3] = right, true_up, -forward, origin
    return c2w


def _positions(cameras: Cameras) -> np.ndarray:
    return cameras.camera_to_worlds[:, :3, 3].detach().cpu().numpy()


def orbit_path(cameras: Cameras, num_frames: int) -> np.ndarray:
    """(F, 3, 4) orbit at the mean camera radius + height around z."""
    pos = _positions(cameras)
    center = pos.mean(0)
    radius = float(np.linalg.norm((pos - center)[:, :2], axis=1).mean())
    height = float(pos[:, 2].mean())
    frames = []
    for t in np.linspace(0, 2 * np.pi, num_frames, endpoint=False):
        origin = center + np.array([radius * np.cos(t), radius * np.sin(t), height - center[2]])
        frames.append(_look_at(origin, center))
    return np.stack(frames)


def interpolate_path(cameras: Cameras, num_frames: int) -> np.ndarray:
    """(F, 3, 4) positions interpolated through the camera ring, always
    looking at the scene center."""
    pos = _positions(cameras)
    center = pos.mean(0)
    n = len(pos)
    frames = []
    for t in np.linspace(0, n, num_frames, endpoint=False):
        i0, frac = int(t) % n, t - int(t)
        i1 = (i0 + 1) % n
        origin = (1 - frac) * pos[i0] + frac * pos[i1]
        frames.append(_look_at(origin, center))
    return np.stack(frames)


def path_cameras(base: Cameras, c2ws: np.ndarray) -> Cameras:
    """The trajectory's cameras: ``c2ws`` with the first eval camera's
    intrinsics, size and model."""
    n = len(c2ws)
    return Cameras(
        camera_to_worlds=torch.as_tensor(c2ws),
        fx=torch.full((n,), float(base.fx[0])),
        fy=torch.full((n,), float(base.fy[0])),
        cx=torch.full((n,), float(base.cx[0])),
        cy=torch.full((n,), float(base.cy[0])),
        width=base.width,
        height=base.height,
        camera_type=base.camera_type,
    )


def frame_image(key: str, value) -> np.ndarray:
    """One output of a render as the frame written: rgb through ``to_u8``,
    any other map through ``colorize`` (jet)."""
    arr = np.asarray(value.detach().cpu() if isinstance(value, torch.Tensor) else value)
    return _to_u8(arr) if key == "rgb" else _colorize(arr)


def main(argv: list[str] | None = None) -> Path:
    ap = argparse.ArgumentParser(description="render a camera trajectory")
    ap.add_argument("--load-config", required=True, help="trained run dir")
    ap.add_argument("--output-dir", default="renders")
    ap.add_argument("--traj", default="orbit", choices=["orbit", "interpolate"])
    ap.add_argument("--num-frames", type=int, default=30)
    ap.add_argument("--fps", type=int, default=10)
    ap.add_argument("--outputs", nargs="+", default=["rgb"],
                    help="channels to export: rgb, depth, rgb_std, depth_std")
    ap.add_argument("--device", default=None,
                    help="torch device to render on; the card by default, 'cpu' for a try without one")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from uncertainty_nerf_gs_torch.scripts.eval_uncertainty import (
        _eval_cameras_and_images,
        _load_run,
        build_render_fn,
    )

    run_dir = Path(args.load_config)
    trainer, spec, run_cfg, _ = _load_run(run_dir, device)
    eval_outputs, _ = _eval_cameras_and_images(run_cfg)
    path_fn = orbit_path if args.traj == "orbit" else interpolate_path
    c2ws = path_fn(eval_outputs.cameras, args.num_frames)
    render_fn = build_render_fn(trainer, spec, path_cameras(eval_outputs.cameras, c2ws), run_dir=run_dir)

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    frames_by_key: dict[str, list] = {k: [] for k in args.outputs}
    for i in range(len(c2ws)):
        outs = render_fn(i)
        for k in args.outputs:
            if k not in outs:
                continue
            img = frame_image(k, outs[k])
            write_png(out_dir / f"{k}_{i:04d}.png", img)
            frames_by_key[k].append(img)
        print(f"frame {i + 1}/{len(c2ws)}", flush=True)

    for k, frames in frames_by_key.items():
        if frames:
            write_gif(out_dir / f"{k}.gif", frames, int(1000 / args.fps),
                      palette=None if k == "rgb" else TABLES["jet"])
    with open(out_dir / "trajectory.json", "w") as f:
        json.dump({"traj": args.traj, "num_frames": args.num_frames, "c2ws": c2ws.tolist()}, f)
    print(f"wrote {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
