"""MLP with skip connections.

Counterpart of ``uncertainty_nerf_gs_tpu/ops/mlp.py``: ``num_layers`` linear
layers named ``dense_{i}`` as in the flax module, ReLU between them, the
input concatenated before each layer listed in ``skip_connections``, and an
optional output activation. Dropout (the MC-dropout hook) and bf16 hidden
compute are not ported yet; asking for either raises.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
from torch import nn


def init_dense(
    layer: nn.Linear, generator: torch.Generator | None = None
) -> nn.Linear:
    """flax ``nn.Dense`` defaults: lecun-normal kernel (a normal truncated at
    two standard deviations, fan-in scaled), zero bias."""
    # 0.8796... is the std of a unit normal truncated to [-2, 2]
    std = math.sqrt(1.0 / layer.in_features) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(
            layer.weight, std=std, a=-2 * std, b=2 * std, generator=generator
        )
        layer.bias.zero_()
    return layer


class MLP(nn.Module):
    """num_layers linear layers (num_layers - 1 hidden activations)."""

    def __init__(
        self,
        in_dim: int,
        num_layers: int,
        layer_width: int,
        out_dim: int,
        skip_connections: Sequence[int] = (),
        activation: Callable = torch.relu,
        out_activation: Callable | None = None,
        dropout_layers: Sequence[int] = (),
        dropout_rate: float = 0.0,
        compute_dtype: torch.dtype | None = None,
        *,
        device: torch.device | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if dropout_rate > 0.0:
            raise NotImplementedError("MLP dropout is not ported yet")
        if compute_dtype is not None:
            raise NotImplementedError("reduced-precision MLP compute is not ported yet")
        self.num_layers = num_layers
        self.skips = {i for i in skip_connections if i > 0}
        self.activation = activation
        self.out_activation = out_activation
        width = in_dim
        for i in range(num_layers):
            if i in self.skips:
                width += in_dim
            out = out_dim if i == num_layers - 1 else layer_width
            layer = nn.Linear(width, out, device=device)
            self.add_module(f"dense_{i}", init_dense(layer, generator))
            width = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.num_layers):
            if i in self.skips:
                h = torch.cat([h, x], dim=-1)
            h = getattr(self, f"dense_{i}")(h)
            if i < self.num_layers - 1:
                h = self.activation(h)
        if self.out_activation is not None:
            h = self.out_activation(h)
        return h
