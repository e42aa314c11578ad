"""Bilinear resize with JAX's antialiasing, in plain PyTorch.

The JAX package resizes with ``jax.image.resize(x, shape, "bilinear")``
(the evaluator's depth maps, LPIPS's small inputs and spatial maps). That is
a separable scale-and-translate with a triangle kernel which, when it
down-samples, widens the kernel by the scale: an anti-aliasing filter that
``F.interpolate`` does not apply by default and whose ``antialias=True`` is
another filter. ``resize_bilinear`` builds the same weight matrix per
resized axis as ``jax._src.image.scale.compute_weight_mat`` (float32 sample
positions, weights normalized per output sample, zero for a sample outside
the input) and contracts the axis with it.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


def resize_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(in_size, out_size) float32 weights of one axis."""
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32, device=device)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    x = torch.abs(sample[None, :] - src[:, None]) / kernel_scale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)  # the triangle kernel
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_bilinear(x: torch.Tensor, shape) -> torch.Tensor:
    """``jax.image.resize(x, shape, "bilinear")`` of a float tensor: every
    axis whose size changes is resampled, the others pass through."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.dim():
        raise ValueError(f"shape {shape} for a {x.dim()}-d tensor")
    out = x.to(torch.float32)
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        w = resize_weights(n_in, n_out, x.device)
        out = torch.movedim(torch.movedim(out, d, -1) @ w, -1, d)
    return out
