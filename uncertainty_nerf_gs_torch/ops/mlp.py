"""MLP with skip connections, per-layer dropout and reduced-precision compute.

Counterpart of ``uncertainty_nerf_gs_tpu/ops/mlp.py``: ``num_layers`` linear
layers named ``dense_{i}`` as in the flax module, ReLU between them, the
input concatenated before each layer listed in ``skip_connections``, and an
optional output activation.

Dropout follows flax's ``nn.Dropout``, inserted before each layer listed in
``dropout_layers`` (``-1`` is the last layer), after that layer's skip
concatenation: a unit is kept with probability ``1 - rate`` and scaled by
``1 / (1 - rate)``. It applies only when the caller passes a ``Dropout``
(the MC-dropout hook); the masks come from its ``torch.Generator`` or are
given, so that a test can impose the JAX package's.

``compute_dtype`` follows ``nn.Dense(dtype=...)``: each layer casts its
input, weight and bias to it, adds the bias after the product and applies
its activation in it; the result is cast back to the input's dtype before
the output activation. The parameters stay float32. The products are plain
``F.linear`` matrix products, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Sequence

import torch
import torch.nn.functional as F
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


class Dropout:
    """Where a forward's dropout masks come from: ``masks`` (name -> bool
    keep mask of the layer input's shape; names are ``"{mlp}.{layer}"``,
    e.g. ``"base_mlp.0"``), else fresh draws from ``generator``
    (``rand < 1 - rate``, as ``jax.random.bernoulli``). ``drawn`` records
    every mask used, by name."""

    def __init__(
        self,
        generator: torch.Generator | None = None,
        masks: Mapping[str, torch.Tensor] | None = None,
    ):
        if (generator is None) == (masks is None):
            raise ValueError("Dropout takes a generator or masks, not both or neither")
        self.generator = generator
        self.masks = masks
        self.drawn: dict[str, torch.Tensor] = {}

    def keep(self, name: str, shape: torch.Size, keep_prob: float, device) -> torch.Tensor:
        if self.masks is not None:
            mask = torch.as_tensor(self.masks[name], device=device)
            if mask.dtype != torch.bool or tuple(mask.shape) != tuple(shape):
                raise ValueError(f"dropout mask {name!r} must be bool {tuple(shape)}, got "
                                 f"{mask.dtype} {tuple(mask.shape)}")
        else:
            mask = torch.rand(shape, generator=self.generator, device=device) < keep_prob
        self.drawn[name] = mask
        return mask

    def scoped(self, prefix: str) -> "Dropout":
        """This source with names prefixed ``prefix.``: one a module."""
        return _Scoped(self, prefix)


class ReplayDropout(Dropout):
    """Draws each name's mask from ``generator`` the first time and gives
    the same mask when the name comes again: a forward recomputed under
    ``torch.utils.checkpoint`` applies the masks the first run drew."""

    def __init__(self, generator: torch.Generator):
        super().__init__(generator=generator)

    def keep(self, name: str, shape: torch.Size, keep_prob: float, device) -> torch.Tensor:
        if name in self.drawn:
            return self.drawn[name]
        return super().keep(name, shape, keep_prob, device)


class _Scoped(Dropout):
    def __init__(self, parent: Dropout, prefix: str):
        self.parent, self.prefix = parent, prefix

    def keep(self, name, shape, keep_prob, device):
        return self.parent.keep(f"{self.prefix}.{name}", shape, keep_prob, device)


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
        if not 0.0 <= dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
        self.num_layers = num_layers
        self.skips = {i for i in skip_connections if i > 0}
        self.activation = activation
        self.out_activation = out_activation
        self.dropout_rate = dropout_rate
        self.drops = (
            {num_layers - 1 if d == -1 else d for d in dropout_layers} if dropout_rate > 0.0 else set()
        )
        self.compute_dtype = compute_dtype
        width = in_dim
        for i in range(num_layers):
            if i in self.skips:
                width += in_dim
            out = out_dim if i == num_layers - 1 else layer_width
            layer = nn.Linear(width, out, device=device)
            self.add_module(f"dense_{i}", init_dense(layer, generator))
            width = out

    @property
    def first_dropout(self) -> int:
        """The first layer with dropout on its input (the last layer if
        none): the layers before it do not depend on the draw, and a run
        that stops there returns a hidden activation."""
        return min(self.drops, default=self.num_layers - 1)

    def forward(self, x: torch.Tensor, dropout: Dropout | None = None) -> torch.Tensor:
        """``dropout`` None is flax's ``deterministic=True``."""
        return self.layers(x, x, 0, dropout)

    def layers(
        self, h: torch.Tensor, x: torch.Tensor, start: int, dropout: Dropout | None = None,
        stop: int | None = None,
    ) -> torch.Tensor:
        """Layers ``start`` to ``stop`` (the end by default) from ``h``, the
        input of layer ``start`` (``x`` the MLP's input, for the skips). A
        partial run returns the hidden activation in the compute dtype; the
        full one casts back and applies the output activation."""
        stop = self.num_layers if stop is None else stop
        for i in range(start, stop):
            if i in self.skips:  # promoted as jnp.concatenate promotes
                dt = torch.promote_types(h.dtype, x.dtype)
                h = torch.cat([h.to(dt), x.to(dt)], dim=-1)
            if dropout is not None and i in self.drops:
                keep_prob = 1.0 - self.dropout_rate
                mask = dropout.keep(str(i), h.shape, keep_prob, h.device)
                # divided by keep_prob rounded to h's dtype, as jnp rounds a
                # weak-typed scalar (in bf16, 0.8 is 0.80078125)
                kp = torch.tensor(keep_prob, dtype=h.dtype).item()
                h = torch.where(mask, h / kp, torch.zeros_like(h))
            dense = getattr(self, f"dense_{i}")
            if self.compute_dtype is None:
                h = dense(h)
            else:
                dt = self.compute_dtype
                h = F.linear(h.to(dt), dense.weight.to(dt)) + dense.bias.to(dt)
            if i < self.num_layers - 1:
                h = self.activation(h)
        if stop < self.num_layers:
            return h
        h = h.to(x.dtype)
        if self.out_activation is not None:
            h = self.out_activation(h)
        return h
