"""Volumetric ray-march compositing: weights and renderers.

Counterpart of ``uncertainty_nerf_gs_tpu/ops/raymarch.py``, eval side. R
rays, S samples per ray; ``weights`` are compositing weights. The interlevel
and distortion losses come with training.
"""

from __future__ import annotations

import torch


def render_weights(densities: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """w_i = alpha_i * T_i: alpha = 1 - exp(-sigma delta),
    T_i = exp(-sum_{j<i} sigma_j delta_j). (R, S) -> (R, S)."""
    tau = densities * deltas
    alphas = 1.0 - torch.exp(-tau)
    accum = torch.cumsum(tau, dim=-1)
    trans = torch.exp(-(accum - tau))
    return alphas * trans


def render_rgb(
    weights: torch.Tensor,
    rgbs: torch.Tensor,
    background: torch.Tensor | None = None,
) -> torch.Tensor:
    """(R, S) weights x (R, S, 3) rgbs -> (R, 3); optional background comp."""
    comp = torch.sum(weights[..., None] * rgbs, dim=-2)
    if background is not None:
        acc = torch.sum(weights, dim=-1, keepdim=True)
        comp = comp + (1.0 - acc) * background
    return comp


def render_accumulation(weights: torch.Tensor) -> torch.Tensor:
    return torch.sum(weights, dim=-1)


def render_expected_depth(
    weights: torch.Tensor, steps: torch.Tensor, eps: float = 1e-10
) -> torch.Tensor:
    """Accumulation-normalized expected termination depth (R,)."""
    acc = torch.sum(weights, dim=-1)
    depth = torch.sum(weights * steps, dim=-1) / (acc + eps)
    lo = torch.amin(steps, dim=-1)
    hi = torch.amax(steps, dim=-1)
    return torch.minimum(torch.maximum(depth, lo), hi)


def render_median_depth(weights: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """Depth where the cumulative weight first reaches 0.5 (R,)."""
    cum = torch.cumsum(weights, dim=-1)
    split = torch.full(
        weights.shape[:-1] + (1,), 0.5, dtype=weights.dtype, device=weights.device
    )
    idx = torch.searchsorted(cum.contiguous(), split, right=False)
    idx = torch.clamp(idx, 0, steps.shape[-1] - 1)
    return torch.gather(steps, -1, idx)[..., 0]


def render_uncertainty(betas: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """UncertaintyRenderer semantics: sum(weights * betas) over samples.
    Callers pass ``weights**2`` to propagate variances."""
    return torch.sum(betas * weights, dim=-1)


def depth_variance(
    weights: torch.Tensor, steps: torch.Tensor, depth: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Analytic depth variance sum_i w_i (t_i - d)^2 + eps."""
    return torch.sum(weights * (steps - depth[..., None]) ** 2, dim=-1) + eps
