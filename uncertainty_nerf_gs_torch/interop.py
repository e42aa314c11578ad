"""Weights across the two packages.

``params_from_jax`` turns a flax parameter tree of numpy arrays (the
``params`` collection of the JAX ``NerfactoModel``) into a state dict of
this package's ``NerfactoModel``; ``params_to_jax`` goes back. The port keeps
the flax module names, so a tree path maps to a dotted key leaf by leaf:

* ``Dense.kernel`` (in, out) <-> ``Linear.weight`` (out, in), transposed;
* ``Dense.bias`` <-> ``Linear.bias``;
* ``Embed.embedding`` <-> ``Embedding.weight``;
* ``cells`` is copied as is, in the JAX package's (L, n_rows, 128) layout.

Both directions only copy and transpose, so the round trip is bit-exact.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def params_from_jax(tree: Mapping[str, Any]) -> OrderedDict[str, torch.Tensor]:
    """flax param tree of numpy arrays -> torch state dict (CPU tensors)."""
    state: OrderedDict[str, torch.Tensor] = OrderedDict()
    for path, leaf in _flatten(tree):
        *mods, name = path
        if name == "kernel":
            name, leaf = "weight", leaf.T
        elif name == "embedding":
            name = "weight"
        elif name not in ("bias", "cells"):
            raise KeyError(f"no torch counterpart for leaf {'/'.join(path)}")
        state[".".join(mods + [name])] = torch.from_numpy(np.ascontiguousarray(leaf))
    return state


def draw_params(
    tree: Mapping[str, Any],
    rng: np.random.Generator,
    cell_scale: float = 2.0,
    kernel_scale: float = 1.5,
    bias_scale: float = 0.5,
) -> dict[str, Any]:
    """A flax param tree of ``tree``'s structure with fresh float32 numpy
    draws: cells uniform in [-cell_scale, cell_scale), kernels normal with
    std kernel_scale / sqrt(fan_in), everything else normal with std
    bias_scale. These scales give peaked compositing weights; init-scale
    tables (+-1e-4) give near-constant densities, which leave the PDF
    resampler untested."""
    out: dict[str, Any] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out[key] = draw_params(value, rng, cell_scale, kernel_scale, bias_scale)
            continue
        shape = np.shape(value)
        if key == "cells":
            leaf = rng.uniform(-cell_scale, cell_scale, shape)
        elif key == "kernel":
            leaf = rng.normal(size=shape) * (kernel_scale / np.sqrt(shape[0]))
        else:
            leaf = rng.normal(size=shape) * bias_scale
        out[key] = leaf.astype(np.float32)
    return out


def params_to_jax(state: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """torch state dict -> flax param tree of numpy arrays."""
    tree: dict[str, Any] = {}
    for key, value in state.items():
        *mods, name = key.split(".")
        leaf = value.detach().cpu().numpy()
        if name == "weight":
            if mods[-1] == "appearance_embedding":
                name = "embedding"
            else:
                name, leaf = "kernel", leaf.T
        elif name not in ("bias", "cells"):
            raise KeyError(f"no flax counterpart for {key}")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(leaf)
    return tree
