"""Activations for radiance fields.

Counterpart of ``uncertainty_nerf_gs_tpu/ops/activations.py``. ``trunc_exp``
is ``exp(min(x, 15))`` forward; its gradient is ``g * exp(clip(x, -15, 15))``,
so density gradients stay finite where the forward saturates.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_TRUNC_MAX = 15.0


class TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp(x, max=_TRUNC_MAX))

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -_TRUNC_MAX, _TRUNC_MAX))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return TruncExp.apply(x)


def shifted_softplus(x: torch.Tensor, beta_min: float = 0.0) -> torch.Tensor:
    """Softplus + beta_min floor, the aleatoric-variance activation."""
    return F.softplus(x) + beta_min
