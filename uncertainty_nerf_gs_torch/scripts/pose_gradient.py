"""Camera-pose sensitivity maps on the card: per-pixel gradients of the
render with respect to a 6-DoF pose perturbation.

Counterpart of ``uncertainty_nerf_gs_tpu/scripts/pose_gradient.py``, with
its flags and files: ``jacobian_{i}.npy`` (H, W, 3, 6), ``sensitivity_{i}.npy``
(the norm over the tangent of the channel-mean Jacobian),
``render_{i}.png``, ``sensitivity_{i}.png`` (through ``data/png.py``; the
card's machine has no PIL) and ``intrinsics.json``. The pose is the eval
camera's composed with ``exp_map_SE3`` of the given (6,) tangent
[tx ty tz | rx ry rz].

The JAX package takes one ``jax.jacrev`` of a chunk's rgb (chunk, 3) with
respect to one shared (6,) tangent. Eval rays do not interact, so here each
ray gets its own copy of the tangent ((chunk, 6), all equal), and three
backward passes, one a colour channel, give each ray's (3, 6) rows of the
same Jacobian. ``torch.func.jacrev`` would need a vmap rule on every
autograd Function of the path (the hash-grid lookups K4/K5 and K7/K8, the
activations); plain backward passes run them as they are. The gradient
reaches the pose through ray generation, the samples' positions, the scene
contraction and the lookups' position gradient (K5 or K8 in their
positions-only mode: the model's parameters are frozen, so no table
gradient is formed); the proposal weights feed the resampler (K1) without
a gradient, as the JAX package's stop_gradient.

Usage:
    python -m uncertainty_nerf_gs_torch.scripts.pose_gradient --load-config outputs/run1 \\
        --output-dir pose_grads --camera-idx 0 --magnitude-trans 0.01 --direction 0
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from uncertainty_nerf_gs_torch.cameras.cameras import Cameras, generate_rays, pixel_grid
from uncertainty_nerf_gs_torch.data.png import write_png
from uncertainty_nerf_gs_torch.ops.backend import resolve_device


def get_perturbed_6dof_pose(
    magnitude_trans: float = 0.0,
    magnitude_rot: float = 0.0,
    direction: int = 0,
) -> np.ndarray:
    """(6,) tangent [tx ty tz | rx ry rz] with one active component."""
    v = np.zeros(6, np.float32)
    if direction < 3:
        v[direction] = magnitude_trans
    else:
        v[direction] = magnitude_rot
    return v


def _ray_cameras(cameras: Cameras, camera_idx: int, n: int) -> Cameras:
    """``n`` copies of camera ``camera_idx``, one a ray."""
    def rows(x):
        return None if x is None else x[camera_idx:camera_idx + 1].expand(n, *x.shape[1:])

    return dataclasses.replace(cameras, **{f.name: rows(getattr(cameras, f.name)) for f in dataclasses.fields(cameras)
                                           if isinstance(getattr(cameras, f.name), torch.Tensor)})


def pose_jacobian_render(
    model_apply: Callable,
    cameras: Cameras,
    camera_idx: int,
    tangent: torch.Tensor,
    chunk: int = 256,
) -> dict[str, np.ndarray]:
    """Per-pixel (3, 6) pose Jacobians and the perturbed render.

    ``model_apply(ray_bundle)`` -> outputs with "rgb" (R, 3), differentiable
    with respect to the rays. ``cameras`` on the model's device; ``tangent``
    (6,). The last chunk is padded with pixel (0, 0) and cut off after."""
    device = cameras.camera_to_worlds.device
    h, w = cameras.height, cameras.width
    px, py = pixel_grid(h, w, device)
    total = h * w
    pad = (-total) % chunk
    zeros = torch.zeros(pad, dtype=torch.float32, device=device)
    px, py = torch.cat([px, zeros]), torch.cat([py, zeros])
    per_ray = _ray_cameras(cameras, camera_idx, chunk)
    ray_idx = torch.arange(chunk, device=device)
    image_idx = torch.full((chunk,), camera_idx, dtype=torch.int64, device=device)
    tangent = torch.as_tensor(tangent, dtype=torch.float32, device=device)
    jacs, rgbs = [], []
    for s in range(0, total + pad, chunk):
        tan = tangent.expand(chunk, 6).clone().requires_grad_(True)
        rb = generate_rays(per_ray, ray_idx, px[s:s + chunk], py[s:s + chunk], pose_adjustment=tan,
                           pose_adjustment_mode="SE3")
        rgb = model_apply(rb._replace(camera_indices=image_idx))["rgb"]
        rows = [torch.autograd.grad(rgb[:, c].sum(), tan, retain_graph=c < 2)[0] for c in range(3)]
        jacs.append(torch.stack(rows, dim=1).detach())
        rgbs.append(rgb.detach())
    jac = torch.cat(jacs, 0)[:total].reshape(h, w, 3, 6).cpu().numpy()
    rgb = torch.cat(rgbs, 0)[:total].reshape(h, w, 3).cpu().numpy()
    # sensitivity magnitude per pixel: ||d mean_rgb / d tangent||
    sens = np.linalg.norm(jac.mean(axis=2), axis=-1)
    return {"jacobian": jac, "rgb": rgb, "sensitivity": sens}


@contextlib.contextmanager
def frozen(module: torch.nn.Module):
    """The module's parameters need no gradient within the block."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield module
    finally:
        for p in params:
            p.requires_grad_(True)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="pose-gradient sensitivity maps")
    ap.add_argument("--load-config", required=True, help="trained run dir")
    ap.add_argument("--output-dir", default="pose_grads")
    ap.add_argument("--camera-idx", type=int, default=0)
    ap.add_argument("--magnitude-trans", type=float, default=0.0)
    ap.add_argument("--magnitude-rot", type=float, default=0.0)
    ap.add_argument("--direction", type=int, default=0, choices=range(6))
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device to run on; the card by default, 'cpu' for a try without one")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from uncertainty_nerf_gs_torch.scripts.eval_uncertainty import _eval_cameras_and_images, _load_run

    trainer, spec, run_cfg, _ = _load_run(Path(args.load_config), device)
    if spec.family == "splatfacto":
        raise ValueError("the pose gradient renders ray chunks through a nerfacto-family model")
    eval_outputs, _ = _eval_cameras_and_images(run_cfg)
    model = trainer.model

    def model_apply(rb):
        return model(rb, train=False, with_grad=True)

    tangent = torch.as_tensor(get_perturbed_6dof_pose(args.magnitude_trans, args.magnitude_rot, args.direction))
    with frozen(model):
        out = pose_jacobian_render(model_apply, eval_outputs.cameras.to(trainer.device), args.camera_idx, tangent,
                                   args.chunk)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.save(out_dir / f"jacobian_{args.camera_idx}.npy", out["jacobian"])
    np.save(out_dir / f"sensitivity_{args.camera_idx}.npy", out["sensitivity"])
    write_png(out_dir / f"render_{args.camera_idx}.png", (np.clip(out["rgb"], 0, 1) * 255).astype(np.uint8))
    s = out["sensitivity"]
    write_png(out_dir / f"sensitivity_{args.camera_idx}.png",
              (np.clip(s / max(s.max(), 1e-9), 0, 1) * 255).astype(np.uint8))
    cams = eval_outputs.cameras
    with open(out_dir / "intrinsics.json", "w") as f:
        json.dump({k: float(getattr(cams, k)[args.camera_idx]) for k in ("fx", "fy", "cx", "cy")}, f)
    print(f"pose-gradient maps written to {out_dir}")


if __name__ == "__main__":
    main()
