"""Weights across the two packages.

``params_from_jax`` turns a flax parameter tree of numpy arrays (the
``params`` collection of the JAX ``NerfactoModel``) into a state dict of
this package's ``NerfactoModel``; ``params_to_jax`` goes back. The port keeps
the flax module names, so a tree path maps to a dotted key leaf by leaf:

* ``Dense.kernel`` (in, out) <-> ``Linear.weight`` (out, in), transposed;
* ``Dense.bias`` <-> ``Linear.bias``;
* ``Embed.embedding`` <-> ``Embedding.weight``;
* ``cells`` is copied as is, in the JAX package's (L, n_rows, 128) layout,
  and so is a hybrid grid's ``corners_{lvl}`` ((res + 1, res + 1, (res + 1)
  F)), which is not a kernel;
* the corner layout's ``table`` is the JAX package's (L, F, T) with its last
  two axes swapped, (L, T, F), so that a corner's F features are one read.

Both directions only copy and transpose, so the round trip is bit-exact.

``trainer_state_from_jax`` turns the JAX ``NerfactoTrainer.state_dict()``
(params with ``camera_opt``, optax's ``multi_transform`` state, step) into
what this package's ``NerfactoTrainer.restore`` takes: per group the Adam
count and the schedule's count, per parameter the first and second moments
under the parameter's name, transposed like the parameter.
``trainer_state_to_jax`` goes back into the structure of a JAX state dict
given as ``like``; optax's state classes are read by their fields, so
neither direction imports optax. Both are bit-exact. Their optimizer halves,
``opt_state_from_jax`` and ``opt_state_to_jax``, also carry the stacked
state of ``jax.vmap(tx.init)`` (a count a member, (M, ...) moments) to the
ensemble step's optimizer state and back.

The splat models' parameters are a flat dict with the same names in both
packages (``SPLAT_PARAM_NAMES``); ``splat_params_from_jax`` and
``splat_params_to_jax`` copy them leaf by leaf, also bit-exact.
``splat_trainer_state_from_jax`` and ``splat_trainer_state_to_jax`` carry
the JAX ``SplatfactoTrainer.state_dict()`` whole (per attribute the optax
Adam count, moments and schedule count; the camera tangents and their
Adam; the alive mask, the step and the last opacity reset), bit-exact both
ways.

An ensemble's members are one dict of (M, ...) tensors under the state
dict's names (``stack_params``); ``ensemble_params_from_jax`` takes the JAX
package's stacked flax tree (a leading member axis on every leaf) to it.
``packed_tables_from_jax`` and ``packed_tables_to_jax`` move the member-packed
eval tables between the JAX layout, (L, T, lanes) rows padded with zeros to a
multiple of 128 lanes, and the port's (L, T, 8, M, F) without the pad; both
directions only copy, so the round trip is exact.

``laplace_posterior_from_jax`` and ``laplace_posterior_to_jax`` move the
nerfacto-laplace diagonal GGN (``models/laplace.py::LaplacePosterior``),
transposing each head's kernel as a ``Dense`` kernel is; bit-exact both ways.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Mapping, Sequence

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = (), skip=None):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path, skip)
        elif skip is None or not skip(value):
            yield path, np.asarray(value)


def _is_table(name: str) -> bool:
    """A hash grid's table leaf: ``cells`` or ``corners_{lvl}`` (copied as
    is), or the corner layout's ``table`` (transposed)."""
    return name in ("cells", "table") or (name.startswith("corners_") and name[len("corners_"):].isdigit())


def _table_leaf(name: str, leaf: np.ndarray) -> np.ndarray:
    """The corner layout's ``table``: the JAX package's (..., L, F, T) <-> the
    port's (..., L, T, F), the last two axes swapped (an optional leading
    member axis kept); other leaves as they are."""
    return np.swapaxes(leaf, -1, -2) if name == "table" else leaf


def _torch_leaf(path: tuple[str, ...], leaf: np.ndarray) -> tuple[str, torch.Tensor]:
    """A flax tree path and leaf -> the state-dict key and tensor."""
    *mods, name = path
    if name == "kernel":  # (..., in, out) -> (..., out, in), a leading member axis kept
        name, leaf = "weight", np.swapaxes(leaf, -1, -2)
    elif name == "embedding":
        name = "weight"
    elif name != "bias" and not _is_table(name) and path != ("camera_opt",):
        raise KeyError(f"no torch counterpart for leaf {'/'.join(path)}")
    return ".".join(mods + [name]), torch.from_numpy(np.array(_table_leaf(name, leaf), order="C"))


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
    draws: cells, hybrid corner grids and corner tables uniform in
    [-cell_scale, cell_scale), kernels normal with
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
        if _is_table(key):
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
            name, leaf = "kernel", np.swapaxes(leaf, -1, -2)
    elif name not in ("bias", "camera_opt") and not _is_table(name):
        raise KeyError(f"no flax counterpart for {key}")
    return mods + [name], np.ascontiguousarray(_table_leaf(name, leaf))


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


def _chain_states(chain) -> tuple[Any, Any]:
    """(ScaleByAdamState, ScaleByScheduleState or None) of an optax chain's
    state: ``optax.adam`` at a constant lr keeps no schedule count."""
    adam = next(s for s in chain if "mu" in getattr(s, "_fields", ()))
    sched = next((s for s in chain if getattr(s, "_fields", ()) == ("count",)), None)
    return adam, sched


def _moments_from_jax(tree: Mapping[str, Any], out: dict[str, torch.Tensor]) -> None:
    """The unmasked leaves of one group's mu or nu tree, by parameter name."""
    for path, leaf in _flatten(tree, skip=_is_empty_node):
        key, value = _torch_leaf(path, leaf)
        out[key] = value


def _count(x) -> int | list[int]:
    """An optax count: an int, or a list of ints where ``jax.vmap(tx.init)``
    stacked one a member."""
    x = np.asarray(x)
    return int(x) if x.ndim == 0 else [int(v) for v in x]


def opt_state_from_jax(opt_state) -> dict[str, Any]:
    """The JAX package's ``make_optimizer`` state (optax's
    ``multi_transform``) -> ``{"groups": {label: {"adam_count",
    "schedule_count"}}, "exp_avg": {name: tensor}, "exp_avg_sq": ...}``,
    the moments under the parameters' names and transposed like them. A
    stacked state (``jax.vmap(tx.init)`` over an ensemble's members) gives
    lists of counts and (M, ...) moments: the ensemble step's layout
    (``parallel/ensemble_parallel.py::EnsembleTrainState``)."""
    groups: dict[str, dict[str, Any]] = {}
    exp_avg: dict[str, torch.Tensor] = {}
    exp_avg_sq: dict[str, torch.Tensor] = {}
    for label, masked in opt_state.inner_states.items():
        adam, sched = _chain_states(masked.inner_state)
        groups[label] = {"adam_count": _count(adam.count), "schedule_count": _count(sched.count)}
        _moments_from_jax(adam.mu, exp_avg)
        _moments_from_jax(adam.nu, exp_avg_sq)
    return {"groups": groups, "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq}


def trainer_state_from_jax(state: Mapping[str, Any]) -> dict[str, Any]:
    """JAX ``NerfactoTrainer.state_dict()`` -> this package's
    ``NerfactoTrainer.restore`` input (CPU tensors)."""
    return {
        "params": params_from_jax(state["params"]),
        "opt_state": opt_state_from_jax(state["opt_state"]),
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


def _from_torch(named: Mapping[str, torch.Tensor]):
    """``_fill``'s leaf function: a flax path's leaf from the state-dict
    tensor of that name, in the old leaf's dtype."""
    def leaf(path, old):
        key = ".".join(path[:-1] + ("weight",)) if path[-1] in ("kernel", "embedding") else ".".join(path)
        return _jax_leaf(key, named[key])[1].astype(old.dtype, copy=False)
    return leaf


def _count_like(value, old) -> np.ndarray:
    return np.asarray(value, dtype=np.asarray(old).dtype)


def opt_state_to_jax(opt: Mapping[str, Any], like) -> Any:
    """``opt_state_from_jax``'s layout -> an optax state with the structure,
    classes and dtypes of ``like`` (numpy leaves), stacked where ``like``
    is."""
    inner = {}
    for label, masked in like.inner_states.items():
        adam, sched = _chain_states(masked.inner_state)
        counts = opt["groups"][label]
        new_adam = adam._replace(
            count=_count_like(counts["adam_count"], adam.count),
            mu=_fill(adam.mu, _from_torch(opt["exp_avg"])),
            nu=_fill(adam.nu, _from_torch(opt["exp_avg_sq"])),
        )
        new_sched = sched._replace(count=_count_like(counts["schedule_count"], sched.count))
        chain = tuple(
            new_adam if s is adam else new_sched if s is sched else s for s in masked.inner_state
        )
        inner[label] = masked._replace(inner_state=chain)
    return like._replace(inner_states=inner)


def trainer_state_to_jax(state: Mapping[str, Any], like: Mapping[str, Any]) -> dict[str, Any]:
    """This package's ``NerfactoTrainer.state_dict()`` -> a JAX
    ``NerfactoTrainer.state_dict()`` with the structure, optax classes and
    dtypes of ``like`` (numpy leaves), for the JAX trainer's ``restore``."""
    return {
        "params": _fill(like["params"], _from_torch(state["params"])),
        "opt_state": opt_state_to_jax(state["opt_state"], like["opt_state"]),
        "step": _count_like(state["step"], like["step"]),
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


def _adam_from_jax(chain) -> tuple[dict[str, Any], int | None]:
    """The Adam count and moments of an optax chain's state, and its
    schedule count where it keeps one."""
    adam, sched = _chain_states(chain)
    return ({"adam_count": int(adam.count),
             "exp_avg": torch.from_numpy(np.array(adam.mu)),
             "exp_avg_sq": torch.from_numpy(np.array(adam.nu))},
            None if sched is None else int(sched.count))


def _adam_to_jax(state: Mapping[str, Any], chain, schedule_count=None) -> tuple:
    """``chain`` (an optax chain's state) with the Adam count, moments and,
    where it keeps one, the schedule count replaced."""
    adam, sched = _chain_states(chain)
    new_adam = adam._replace(
        count=np.asarray(state["adam_count"], dtype=np.asarray(adam.count).dtype),
        mu=np.ascontiguousarray(state["exp_avg"].detach().cpu().numpy()),
        nu=np.ascontiguousarray(state["exp_avg_sq"].detach().cpu().numpy()),
    )
    new_sched = sched if sched is None else sched._replace(
        count=np.asarray(schedule_count, dtype=np.asarray(sched.count).dtype))
    return tuple(new_adam if s is adam else new_sched if s is sched else s for s in chain)


def splat_trainer_state_from_jax(state: Mapping[str, Any]) -> dict[str, Any]:
    """JAX ``SplatfactoTrainer.state_dict()`` -> this package's
    ``SplatfactoTrainer.restore`` input (CPU tensors)."""
    groups, exp_avg, exp_avg_sq = {}, {}, {}
    for k, chain in state["opt_state"].items():
        adam, schedule_count = _adam_from_jax(chain)
        groups[k] = {"adam_count": adam["adam_count"], "schedule_count": schedule_count}
        exp_avg[k], exp_avg_sq[k] = adam["exp_avg"], adam["exp_avg_sq"]
    return {
        "params": splat_params_from_jax(state["params"]),
        "opt_state": {"groups": groups, "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq},
        "camera_opt": torch.from_numpy(np.array(state["camera_opt"])),
        "cam_opt_state": _adam_from_jax(state["cam_opt_state"])[0],
        "splat_alive": np.array(state["splat_alive"]),
        "step": int(state["step"]),
        "last_opacity_reset": int(state["last_opacity_reset"]),
    }


def splat_trainer_state_to_jax(state: Mapping[str, Any], like: Mapping[str, Any]) -> dict[str, Any]:
    """This package's ``SplatfactoTrainer.state_dict()`` -> a JAX
    ``SplatfactoTrainer.state_dict()`` with the structure, optax classes and
    dtypes of ``like`` (numpy leaves), for the JAX trainer's ``restore``."""
    opt = state["opt_state"]

    def scalar(value, old):
        return np.asarray(value, dtype=np.asarray(old).dtype)

    return {
        "params": splat_params_to_jax(state["params"]),
        "opt_state": {
            k: _adam_to_jax({"adam_count": opt["groups"][k]["adam_count"], "exp_avg": opt["exp_avg"][k],
                             "exp_avg_sq": opt["exp_avg_sq"][k]},
                            chain, opt["groups"][k]["schedule_count"])
            for k, chain in like["opt_state"].items()
        },
        "camera_opt": np.ascontiguousarray(state["camera_opt"].detach().cpu().numpy()),
        "cam_opt_state": _adam_to_jax(state["cam_opt_state"], like["cam_opt_state"]),
        "splat_alive": np.asarray(state["splat_alive"], dtype=bool),
        "step": scalar(state["step"], like["step"]),
        "last_opacity_reset": scalar(state["last_opacity_reset"], like["last_opacity_reset"]),
    }


def stack_params(states: Sequence[Mapping[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """M state dicts with the same keys -> one dict of (M, ...) tensors, the
    ensemble's members on a leading axis (the JAX ``stack_params``)."""
    keys = list(states[0])
    for state in states[1:]:
        if list(state) != keys:
            raise KeyError("the members' state dicts hold different keys")
    return {k: torch.stack([state[k] for state in states]) for k in keys}


def ensemble_params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX package's stacked flax param tree of numpy arrays (every leaf
    with a leading member axis, as ``init_ensemble_params`` makes it) ->
    ``stack_params`` of the members' state dicts (CPU tensors)."""
    leaves = list(_flatten(tree))
    members = {leaf.shape[0] for _, leaf in leaves}
    if len(members) != 1:
        raise ValueError(f"leaves disagree on the member count: {sorted(members)}")
    m = members.pop()

    def member(j):
        return OrderedDict(_torch_leaf(path, leaf[j]) for path, leaf in leaves)

    return stack_params([member(j) for j in range(m)])


def packed_tables_from_jax(rows, num_members: int, features_per_level: int = 2) -> torch.Tensor:
    """JAX ``pack_member_cell_tables`` rows (L, T, lanes), 8 M F real lanes
    padded to a multiple of 128 -> the port's (L, T, 8, M, F) float32
    without the pad lanes (CPU tensor)."""
    rows = np.asarray(rows)
    payload = 8 * num_members * features_per_level
    levels, table, lanes = rows.shape
    if lanes < payload or lanes % 128:
        raise ValueError(f"{lanes} lanes cannot hold {num_members} members at F = {features_per_level}")
    real = np.ascontiguousarray(rows[:, :, :payload]).astype(np.float32, copy=False)
    return torch.from_numpy(real.reshape(levels, table, 8, num_members, features_per_level))


def packed_tables_to_jax(packed: torch.Tensor) -> np.ndarray:
    """The port's (L, T, 8, M, F) packed tables -> the JAX layout (L, T,
    lanes), zeros in the pad lanes up to a multiple of 128."""
    levels, table = packed.shape[:2]
    payload = int(np.prod(packed.shape[2:]))
    lanes = -(-payload // 128) * 128
    out = np.zeros((levels, table, lanes), dtype=np.float32)
    out[:, :, :payload] = packed.detach().cpu().numpy().reshape(levels, table, payload)
    return out


def laplace_posterior_from_jax(posterior) -> Any:
    """A JAX ``LaplacePosterior`` (per head a flax tree {"kernel" (in, out),
    "bias"}) -> this package's (per head {"weight" (out, in), "bias"}),
    bit-exact."""
    from uncertainty_nerf_gs_torch.models.laplace import LaplacePosterior

    def head(tree):
        return {"weight": torch.from_numpy(np.ascontiguousarray(np.asarray(tree["kernel"]).T)),
                "bias": torch.from_numpy(np.array(tree["bias"]))}

    return LaplacePosterior(density_head=head(posterior.density_head), rgb_head=head(posterior.rgb_head))


def laplace_posterior_to_jax(posterior) -> dict[str, dict[str, np.ndarray]]:
    """This package's ``LaplacePosterior`` -> {head: {"kernel", "bias"}}
    numpy trees in the JAX package's layout (``LaplacePosterior(**tree)``
    there), bit-exact."""
    return {name: {"kernel": np.ascontiguousarray(getattr(posterior, name)["weight"].detach().cpu().numpy().T),
                   "bias": getattr(posterior, name)["bias"].detach().cpu().numpy().copy()}
            for name in ("density_head", "rgb_head")}
