"""Device mesh and this rank's slices.

Counterpart of ``uncertainty_nerf_gs_tpu/parallel/mesh.py``. There one
process places arrays on a 2-D ``jax.sharding.Mesh`` and XLA inserts the
collectives. Here every rank is a process of its own in a
``torch.distributed`` process group that the caller initialises
(``init_process_group`` with its address, world size and rank: NCCL on the
cards, gloo on the CPU), and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the group's ranks with
the JAX package's two dims:

* ``"data"`` splits the ray axis of train batches and render chunks;
* ``"member"`` splits the ensemble's stacked members.

``shard_batch``, ``shard_members`` and ``replicate`` return this rank's part
of a tree of tensors (dicts, lists, tuples, NamedTuples such as
``RayBundle``) on the mesh's device: its rows, its members, or the whole
tree broadcast from the mesh's first rank. Rows are split in equal shards
only: every loss term is a mean over rays, so the mean of the shards'
gradients is the whole batch's only when the shards are equal, and a batch
that does not divide is refused. ``all_gather_rows`` and ``mean_over`` are
the collectives the mesh forms of ``parallel/ensemble_parallel.py``,
``parallel/ensemble_fused.py`` and ``parallel/splat_parallel.py`` use.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from uncertainty_nerf_gs_torch.ops.backend import resolve_device

MESH_DIMS = ("data", "member")


def make_mesh(num_data: int | None = None, num_member: int = 1, device_type: str | None = None) -> DeviceMesh:
    """A ("data", "member") mesh over every rank of the initialised process
    group, rank ``d * num_member + m`` at (d, m). ``num_data`` defaults to
    the world size over ``num_member``. ``device_type`` None is the card,
    and raises when there is none; "cpu" for gloo."""
    device = resolve_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if num_data is None:
        num_data = world // num_member
    if num_data * num_member != world:
        raise ValueError(f"a {num_data}x{num_member} mesh needs {num_data * num_member} ranks; the group has {world}")
    layout = torch.arange(world).reshape(num_data, num_member)
    return DeviceMesh(device.type, layout, mesh_dim_names=MESH_DIMS)


def _dims(axes: str | Sequence[str]) -> tuple[str, ...]:
    dims = (axes,) if isinstance(axes, str) else tuple(axes)
    if not dims or any(d not in MESH_DIMS for d in dims):
        raise ValueError(f"mesh axes must name {MESH_DIMS}; got {axes!r}")
    return tuple(d for d in MESH_DIMS if d in dims)  # the mesh's row-major order


def coordinate(mesh: DeviceMesh, axes: str | Sequence[str]) -> tuple[int, int]:
    """(this rank's index, the number of ranks) along ``axes``, several dims
    taken row-major as one."""
    index, size = 0, 1
    for d in _dims(axes):
        index = index * mesh.size(MESH_DIMS.index(d)) + mesh.get_local_rank(d)
        size *= mesh.size(MESH_DIMS.index(d))
    return index, size


def _group(mesh: DeviceMesh, axes: str | Sequence[str]):
    dims = _dims(axes)
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    if mesh.mesh.flatten().tolist() != list(range(dist.get_world_size())):
        raise ValueError("the whole mesh as one axis needs make_mesh's layout over every rank")
    return dist.group.WORLD


def _tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def split_rows(x: torch.Tensor, index: int, size: int) -> torch.Tensor:
    """Shard ``index`` of ``size`` equal shards of ``x``'s leading axis."""
    if x.shape[0] % size:
        raise ValueError(f"{x.shape[0]} rows do not split into {size} equal shards")
    n = x.shape[0] // size
    return x[index * n:(index + 1) * n]


def shard_batch(batch: Any, mesh: DeviceMesh, axes: str | Sequence[str] = "data") -> Any:
    """This rank's rows of every (R, ...) tensor in ``batch``, split over
    ``axes`` ("data"; both dims for the fused render, which splits rays over
    the whole mesh)."""
    index, size = coordinate(mesh, axes)
    device = _device(mesh)
    return _tree_map(lambda x: split_rows(x, index, size).to(device), batch)


def shard_members(stacked_params: Any, mesh: DeviceMesh) -> Any:
    """This rank's members of every (M, ...) stacked tensor, split over
    "member"."""
    return shard_batch(stacked_params, mesh, "member")


def replicate(tree: Any, mesh: DeviceMesh) -> Any:
    """The whole tree on this rank's device, every tensor broadcast from the
    mesh's first rank so that all ranks hold the same values."""
    device = _device(mesh)
    src = int(mesh.mesh.flatten()[0])

    def broadcast(x):
        out = x.detach().to(device, copy=True).contiguous()
        dist.broadcast(out, src=src, group=_group(mesh, MESH_DIMS))
        return out

    return _tree_map(broadcast, tree)


def all_gather_rows(tree: Any, mesh: DeviceMesh, axes: str | Sequence[str]) -> Any:
    """Every rank's (n, ...) shards along ``axes`` joined in mesh order into
    (size * n, ...); a 0-dim tensor (a mean over this rank's rows) is
    averaged instead, which over equal shards is the mean over all rows."""
    group = _group(mesh, axes)
    _, size = coordinate(mesh, axes)

    def gather(x):
        x = x.contiguous()
        if x.dim() == 0:
            return mean_over(x, mesh, axes)
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=0)

    return _tree_map(gather, tree)


def mean_over(x: torch.Tensor, mesh: DeviceMesh, axes: str | Sequence[str]) -> torch.Tensor:
    """The mean of ``x`` over the ranks along ``axes``, on every rank (a sum
    all-reduced, then divided by their number)."""
    _, size = coordinate(mesh, axes)
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=_group(mesh, axes))
    return out.div_(size)
