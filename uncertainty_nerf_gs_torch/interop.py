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

``trainer_state_from_jax`` turns the JAX ``NerfactoTrainer.state_dict()``
(params with ``camera_opt``, optax's ``multi_transform`` state, step) into
what this package's ``NerfactoTrainer.restore`` takes: per group the Adam
count and the schedule's count, per parameter the first and second moments
under the parameter's name, transposed like the parameter.
``trainer_state_to_jax`` goes back into the structure of a JAX state dict
given as ``like``; optax's state classes are read by their fields, so
neither direction imports optax. Both are bit-exact.

The splat models' parameters are a flat dict with the same names in both
packages (``SPLAT_PARAM_NAMES``); ``splat_params_from_jax`` and
``splat_params_to_jax`` copy them leaf by leaf, also bit-exact.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = (), skip=None):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path, skip)
        elif skip is None or not skip(value):
            yield path, np.asarray(value)


def _torch_leaf(path: tuple[str, ...], leaf: np.ndarray) -> tuple[str, torch.Tensor]:
    """A flax tree path and leaf -> the state-dict key and tensor."""
    *mods, name = path
    if name == "kernel":
        name, leaf = "weight", leaf.T
    elif name == "embedding":
        name = "weight"
    elif name not in ("bias", "cells") and path != ("camera_opt",):
        raise KeyError(f"no torch counterpart for leaf {'/'.join(path)}")
    return ".".join(mods + [name]), torch.from_numpy(np.array(leaf, order="C"))


def params_from_jax(tree: Mapping[str, Any]) -> OrderedDict[str, torch.Tensor]:
    """flax param tree of numpy arrays -> torch state dict (CPU tensors). A
    top-level ``camera_opt`` leaf keeps its name."""
    return OrderedDict(_torch_leaf(path, leaf) for path, leaf in _flatten(tree))


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


def _jax_leaf(key: str, value: torch.Tensor) -> tuple[list[str], np.ndarray]:
    """A state-dict key and tensor -> the flax tree path and leaf."""
    *mods, name = key.split(".")
    leaf = value.detach().cpu().numpy()
    if name == "weight":
        if mods[-1] == "appearance_embedding":
            name = "embedding"
        else:
            name, leaf = "kernel", leaf.T
    elif name not in ("bias", "cells", "camera_opt"):
        raise KeyError(f"no flax counterpart for {key}")
    return mods + [name], np.ascontiguousarray(leaf)


def params_to_jax(state: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """torch state dict -> flax param tree of numpy arrays."""
    tree: dict[str, Any] = {}
    for key, value in state.items():
        path, leaf = _jax_leaf(key, value)
        node = tree
        for m in path[:-1]:
            node = node.setdefault(m, {})
        node[path[-1]] = leaf
    return tree


def _is_empty_node(x) -> bool:
    """optax's ``MaskedNode`` (and ``EmptyState``): a NamedTuple without fields."""
    return isinstance(x, tuple) and hasattr(x, "_fields") and not x._fields


def _group_states(masked) -> tuple[Any, Any]:
    """(ScaleByAdamState, ScaleByScheduleState) of one group's chain."""
    chain = masked.inner_state
    adam = next(s for s in chain if "mu" in getattr(s, "_fields", ()))
    sched = next(s for s in chain if getattr(s, "_fields", ()) == ("count",))
    return adam, sched


def _moments_from_jax(tree: Mapping[str, Any], out: dict[str, torch.Tensor]) -> None:
    """The unmasked leaves of one group's mu or nu tree, by parameter name."""
    for path, leaf in _flatten(tree, skip=_is_empty_node):
        key, value = _torch_leaf(path, leaf)
        out[key] = value


def trainer_state_from_jax(state: Mapping[str, Any]) -> dict[str, Any]:
    """JAX ``NerfactoTrainer.state_dict()`` -> this package's
    ``NerfactoTrainer.restore`` input (CPU tensors)."""
    groups: dict[str, dict[str, int]] = {}
    exp_avg: dict[str, torch.Tensor] = {}
    exp_avg_sq: dict[str, torch.Tensor] = {}
    for label, masked in state["opt_state"].inner_states.items():
        adam, sched = _group_states(masked)
        groups[label] = {"adam_count": int(adam.count), "schedule_count": int(sched.count)}
        _moments_from_jax(adam.mu, exp_avg)
        _moments_from_jax(adam.nu, exp_avg_sq)
    return {
        "params": params_from_jax(state["params"]),
        "opt_state": {"groups": groups, "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq},
        "step": int(state["step"]),
    }


def _fill(like: Any, leaf_fn, path: tuple[str, ...] = ()) -> Any:
    """``like`` rebuilt with each array leaf at ``path`` replaced by
    ``leaf_fn(path, leaf)``; empty nodes are kept as they are."""
    if isinstance(like, Mapping):
        return {k: _fill(v, leaf_fn, path + (str(k),)) for k, v in like.items()}
    if _is_empty_node(like):
        return like
    return leaf_fn(path, like)


def trainer_state_to_jax(state: Mapping[str, Any], like: Mapping[str, Any]) -> dict[str, Any]:
    """This package's ``NerfactoTrainer.state_dict()`` -> a JAX
    ``NerfactoTrainer.state_dict()`` with the structure, optax classes and
    dtypes of ``like`` (numpy leaves), for the JAX trainer's ``restore``."""
    def from_torch(named):
        def leaf(path, old):
            key = ".".join(path[:-1] + ("weight",)) if path[-1] in ("kernel", "embedding") else ".".join(path)
            return _jax_leaf(key, named[key])[1].astype(old.dtype, copy=False)
        return leaf

    def count(value, old):
        return np.asarray(value, dtype=np.asarray(old).dtype)

    opt = state["opt_state"]
    inner = {}
    for label, masked in like["opt_state"].inner_states.items():
        adam, sched = _group_states(masked)
        counts = opt["groups"][label]
        new_adam = adam._replace(
            count=count(counts["adam_count"], adam.count),
            mu=_fill(adam.mu, from_torch(opt["exp_avg"])),
            nu=_fill(adam.nu, from_torch(opt["exp_avg_sq"])),
        )
        new_sched = sched._replace(count=count(counts["schedule_count"], sched.count))
        chain = tuple(
            new_adam if s is adam else new_sched if s is sched else s for s in masked.inner_state
        )
        inner[label] = masked._replace(inner_state=chain)
    return {
        "params": _fill(like["params"], from_torch(state["params"])),
        "opt_state": like["opt_state"]._replace(inner_states=inner),
        "step": count(state["step"], like["step"]),
    }


SPLAT_PARAM_NAMES = (
    "means", "scales", "quats", "opacities", "features_dc", "features_rest",
    "log_uncertainties",
)


def splat_params_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Splat parameter dict of numpy arrays -> dict of CPU tensors."""
    out = {}
    for key, value in params.items():
        if key not in SPLAT_PARAM_NAMES:
            raise KeyError(f"no splat parameter named {key}")
        out[key] = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
    return out


def splat_params_to_jax(params: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Splat parameter dict of tensors -> dict of numpy arrays."""
    out = {}
    for key, value in params.items():
        if key not in SPLAT_PARAM_NAMES:
            raise KeyError(f"no splat parameter named {key}")
        out[key] = np.ascontiguousarray(value.detach().cpu().numpy())
    return out
