"""Checkpoint save/load/resume and the Laplace GGN cache.

Counterpart of ``uncertainty_nerf_gs_tpu/engine/checkpointing.py``, with the
same file names: ``step-{step:09d}.ckpt`` in a run directory, the latest
found by the step parsed from the name, per-member loading for ensembles,
and the GGN cache ``ggn_v2_{n_iters}.npz``.

A checkpoint is one ``torch.save`` of a trainer's ``state_dict()`` with every
tensor moved to the host (numpy arrays become tensors), read back with
``torch.load(weights_only=True)``: the state holds only tensors, numbers,
strings and containers of them. The JAX package's checkpoints are orbax
directories under the same names; the port does not read them (it does not
import orbax) and says how to convert one. The GGN cache keeps the JAX
package's own layout (``arr_i`` in ``jax.tree.flatten`` order of its
``LaplacePosterior``), so a cache written by either package loads in the
other.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any

import numpy as np
import torch

_STEP_RE = re.compile(r"step-(\d+)\.ckpt")


def checkpoint_path(load_dir: Path, step: int) -> Path:
    return Path(load_dir) / f"step-{step:09d}.ckpt"


def latest_checkpoint(load_dir: Path) -> Path | None:
    """Latest ``step-*.ckpt`` by parsed step number."""
    load_dir = Path(load_dir)
    if not load_dir.exists():
        return None
    best, best_step = None, -1
    for p in load_dir.iterdir():
        m = _STEP_RE.fullmatch(p.name)
        if m and int(m.group(1)) > best_step:
            best, best_step = p, int(m.group(1))
    return best


def _to_host(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, np.generic):
        return tree.item()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def save_checkpoint(load_dir: Path, step: int, state: Any) -> Path:
    """Write ``state`` (a trainer's ``state_dict()``) as
    ``step-{step:09d}.ckpt`` under ``load_dir``, through a temporary file
    renamed into place."""
    path = checkpoint_path(load_dir, step)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".ckpt.tmp")
    torch.save(_to_host(state), tmp)
    tmp.replace(path)
    return path


def load_checkpoint(path: Path) -> Any:
    """A checkpoint's state, tensors on the host (the file holds its own
    dtypes, so no target tree is needed, unlike orbax)."""
    path = Path(path)
    if path.is_dir():
        raise ValueError(
            f"{path} is a directory: an orbax checkpoint of the JAX package. Convert its state "
            "with uncertainty_nerf_gs_torch.interop.trainer_state_from_jax (or "
            "splat_trainer_state_from_jax) in a program that imports both packages, and write it "
            "with save_checkpoint."
        )
    return torch.load(path, map_location="cpu", weights_only=True)


def load_latest(load_dir: Path) -> tuple[Any, int] | None:
    p = latest_checkpoint(load_dir)
    if p is None:
        return None
    step = int(_STEP_RE.fullmatch(p.name).group(1))
    return load_checkpoint(p), step


def load_ensemble_checkpoints(load_dirs: list[Path]) -> list[Any]:
    """Per-member latest-checkpoint loading: each member directory is
    searched on its own; every member must have a checkpoint."""
    states = []
    for d in load_dirs:
        got = load_latest(d)
        if got is None:
            raise FileNotFoundError(f"no step-*.ckpt under {d}")
        states.append(got[0])
    return states


# --- Laplace GGN cache ---------------------------------------------------------

# the JAX LaplacePosterior's leaves in jax.tree.flatten order: its fields in
# order, each head's flax dict by sorted key
_GGN_LEAVES = (("density_head", "bias"), ("density_head", "kernel"),
               ("rgb_head", "bias"), ("rgb_head", "kernel"))


def ggn_cache_path(config_dir: Path, n_iters: int) -> Path:
    # v2: the sum-reduction GGN scale, as the JAX package names it
    return Path(config_dir) / f"ggn_v2_{n_iters}.npz"


def save_ggn_cache(config_dir: Path, n_iters: int, posterior: Any) -> Path:
    """Write the port's ``LaplacePosterior`` in the JAX package's layout."""
    from uncertainty_nerf_gs_torch.interop import laplace_posterior_to_jax

    path = ggn_cache_path(config_dir, n_iters)
    path.parent.mkdir(parents=True, exist_ok=True)
    tree = laplace_posterior_to_jax(posterior)
    np.savez(path, *[tree[head][leaf] for head, leaf in _GGN_LEAVES])
    return path


def load_ggn_cache(config_dir: Path, n_iters: int, device: str | torch.device = "cpu") -> Any | None:
    """The cached posterior as the port's ``LaplacePosterior`` on
    ``device``, or None when there is no cache file."""
    from uncertainty_nerf_gs_torch.interop import laplace_posterior_from_jax
    from uncertainty_nerf_gs_torch.models.laplace import LaplacePosterior

    path = ggn_cache_path(config_dir, n_iters)
    if not path.exists():
        return None
    with np.load(path) as data:
        tree: dict[str, dict[str, np.ndarray]] = {}
        for i, (head, leaf) in enumerate(_GGN_LEAVES):
            tree.setdefault(head, {})[leaf] = data[f"arr_{i}"]
    posterior = laplace_posterior_from_jax(LaplacePosterior(**tree))
    return LaplacePosterior(*({k: v.to(device) for k, v in head.items()} for head in posterior))
