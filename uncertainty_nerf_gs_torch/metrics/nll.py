"""Gaussian negative log-likelihood with a std floor.

Counterpart of ``uncertainty_nerf_gs_tpu/metrics/nll.py`` (the reference's
``negative_gaussian_loglikelihood``): the predictive std is shared across
the channels, floored at ``eps``, and each element's NLL is
``0.5 log(2 pi sigma^2) + (target - mean)^2 / (2 sigma^2)``.
"""

from __future__ import annotations

import math

import torch


def gaussian_nll(
    preds: torch.Tensor, targets: torch.Tensor, stds: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """preds, targets (..., c); stds (...,) or (..., 1) -> (n, c) per-element
    NLL, n the product of the leading dims."""
    c = preds.shape[-1]
    preds = preds.reshape(-1, c).to(torch.float32)
    targets = targets.reshape(-1, c).to(torch.float32)
    stds = torch.clamp(stds.reshape(-1, 1).to(torch.float32), min=eps)
    var = stds * stds
    return 0.5 * torch.log(2.0 * math.pi * var) + (targets - preds) ** 2 / (2.0 * var)
