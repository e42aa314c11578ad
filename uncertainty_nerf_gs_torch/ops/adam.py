"""Adam's update of every param group in one pass (K9).

Not a TPU kernel: the JAX package gets Adam from optax. On CUDA tensors
``adam_update`` launches ``csrc/adam.cu``'s ``adam_multi_tensor_apply_kernel``,
which reads p, g, m and v and writes p, m and v once an element, over every
group's tensors at once. ``engine/optimizers.py::ScheduledAdam`` calls it
where ``backend.use_kernel`` says so; its eight foreach passes are the plain
version, whose arithmetic the kernel repeats bit for bit.

A launch's table of tensors rides in the kernel's parameters (``_Table``, a
ctypes mirror of ``AdamTable`` in the source): at most ``MAX_TENSORS``
tensors of at most ``MAX_GROUPS`` groups. ``plan_launches`` cuts a longer
list into launches and gives each tensor its first block and its head (the
elements read as scalars before the first float4 of all four arrays).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from uncertainty_nerf_gs_torch.ops import backend

KERNEL = "adam"
MAX_TENSORS = 72
MAX_GROUPS = 16
BLOCK_VECS = 1024  # float4s a block
BLOCK_SCALARS = 4096  # elements a block where a tensor is read as scalars


@dataclasses.dataclass
class GroupUpdate:
    """One param group's tensors and the 0-dim float32 scalars its update
    reads on the device: ``decay`` 1 - lr * wd (None: no decay),
    ``bc2_sqrt`` sqrt(1 - b2^t), ``step_size`` lr / (1 - b1^t)."""

    params: list[torch.Tensor]
    grads: list[torch.Tensor]
    exp_avg: list[torch.Tensor]
    exp_avg_sq: list[torch.Tensor]
    decay: torch.Tensor | None
    bc2_sqrt: torch.Tensor
    step_size: torch.Tensor
    eps: float


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor as the planner sees it: the addresses of p, g, m and v, its
    element count and its group's index in the update."""

    addresses: tuple[int, int, int, int]
    numel: int
    group: int


@dataclasses.dataclass(frozen=True)
class Row:
    """A tensor's row in a launch's table: ``tensor`` indexes the specs,
    ``group`` the launch's ``groups``."""

    tensor: int
    group: int
    head: int
    first_block: int


@dataclasses.dataclass
class Launch:
    rows: list[Row] = dataclasses.field(default_factory=list)
    groups: list[int] = dataclasses.field(default_factory=list)  # the update's group indices
    blocks: int = 0


def head_of(addresses: tuple[int, ...], numel: int) -> int:
    """Elements read as scalars before the first float4 where all four
    addresses share their offset from 16 bytes and a float4 follows;
    otherwise -1: the tensor is read as scalars only."""
    offsets = {a % 16 for a in addresses}
    if len(offsets) != 1:
        return -1
    head = (16 - offsets.pop()) % 16 // 4
    return head if numel - head >= 4 else -1


def blocks_of(numel: int, head: int) -> int:
    if head < 0:
        return -(-numel // BLOCK_SCALARS)
    return -(-((numel - head) // 4) // BLOCK_VECS)


def plan_launches(specs: list[TensorSpec]) -> list[Launch]:
    """The launches over ``specs`` in order, each with at most MAX_TENSORS
    rows of at most MAX_GROUPS groups; empty tensors are left out."""
    launches: list[Launch] = []
    for i, spec in enumerate(specs):
        if spec.numel == 0:
            continue
        cur = launches[-1] if launches else None
        if cur is None or len(cur.rows) == MAX_TENSORS or (
                spec.group not in cur.groups and len(cur.groups) == MAX_GROUPS):
            cur = Launch()
            launches.append(cur)
        if spec.group not in cur.groups:
            cur.groups.append(spec.group)
        head = head_of(spec.addresses, spec.numel)
        cur.rows.append(Row(i, cur.groups.index(spec.group), head, cur.blocks))
        cur.blocks += blocks_of(spec.numel, head)
    return launches


class _Group(ctypes.Structure):
    _fields_ = [("decay", ctypes.c_void_p), ("bc2_sqrt", ctypes.c_void_p), ("step_size", ctypes.c_void_p),
                ("eps", ctypes.c_float)]


class _Tensor(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p), ("m", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("numel", ctypes.c_longlong), ("first_block", ctypes.c_int), ("group", ctypes.c_short),
                ("head", ctypes.c_short)]


class _Table(ctypes.Structure):
    _fields_ = [("groups", _Group * MAX_GROUPS), ("tensors", _Tensor * MAX_TENSORS), ("num_tensors", ctypes.c_int),
                ("one_minus_b1", ctypes.c_float), ("b2", ctypes.c_float), ("one_minus_b2", ctypes.c_float)]


def pack(launch: Launch, specs: list[TensorSpec], scalars: list[tuple[int | None, int, int, float]],
         b1: float, b2: float) -> _Table:
    """A launch's table; ``scalars[group]`` the addresses of its decay (or
    None), sqrt(1 - b2^t) and step size, and its eps. The constants are
    rounded to float32 as ATen rounds a foreach op's scalar."""
    table = _Table(num_tensors=len(launch.rows), one_minus_b1=1.0 - b1, b2=b2, one_minus_b2=1.0 - b2)
    for j, group in enumerate(launch.groups):
        decay, bc2_sqrt, step_size, eps = scalars[group]
        table.groups[j] = _Group(decay, bc2_sqrt, step_size, eps)
    for j, row in enumerate(launch.rows):
        spec = specs[row.tensor]
        table.tensors[j] = _Tensor(*spec.addresses, spec.numel, row.first_block, row.group, row.head)
    return table


def check_update(groups: list[GroupUpdate]) -> None:
    """Raises on what the kernel does not take: every tensor float32,
    contiguous and on the first parameter's device, each gradient and
    moment of its parameter's shape, each scalar a float32 element there."""
    device = groups[0].params[0].device
    for grp in groups:
        scalars = [("bc2_sqrt", grp.bc2_sqrt), ("step_size", grp.step_size)]
        if grp.decay is not None:
            scalars.append(("decay", grp.decay))
        for name, s in scalars:
            if s.dtype != torch.float32 or s.numel() != 1 or s.device != device:
                raise ValueError(f"{name} must be one float32 element on {device}")
        for p, *rest in zip(grp.params, grp.grads, grp.exp_avg, grp.exp_avg_sq):
            for name, t in zip(("parameter", "gradient", "exp_avg", "exp_avg_sq"), (p, *rest)):
                if t.dtype != torch.float32:
                    raise TypeError(f"the {name} must be float32, got {t.dtype}")
                if t.device != device:
                    raise ValueError(f"the {name} is on {t.device}, the first parameter on {device}")
                if t.shape != p.shape:
                    raise ValueError(f"the {name} has shape {tuple(t.shape)}, its parameter {tuple(p.shape)}")
                if not t.is_contiguous():
                    raise ValueError(f"the {name} must be contiguous, got strides {t.stride()}")


_layout_checked = False


def _check_layout() -> None:
    """The source's table against ``_Table`` and the planner's constants."""
    global _layout_checked
    if _layout_checked:
        return
    out = (ctypes.c_int * 5)()
    backend.entry(KERNEL, "adam_table_layout", [ctypes.c_void_p], restype=None)(out)
    want = [ctypes.sizeof(_Table), MAX_TENSORS, MAX_GROUPS, BLOCK_VECS, BLOCK_SCALARS]
    if list(out) != want:
        raise RuntimeError(f"csrc/adam.cu's table layout {list(out)} differs from ops/adam.py's {want}")
    _layout_checked = True


def adam_update(groups: list[GroupUpdate], b1: float, b2: float) -> None:
    """Every group's update in place, on the card: one launch a table of
    tensors, no host read, so a CUDA graph can capture it."""
    check_update(groups)
    specs = [TensorSpec((p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr()), p.numel(), i)
             for i, grp in enumerate(groups)
             for p, g, m, v in zip(grp.params, grp.grads, grp.exp_avg, grp.exp_avg_sq)]
    scalars = [(None if grp.decay is None else grp.decay.data_ptr(), grp.bc2_sqrt.data_ptr(),
                grp.step_size.data_ptr(), grp.eps) for grp in groups]
    _check_layout()
    fn = backend.entry(KERNEL, "adam_update_f32", [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    device = groups[0].params[0].device
    with torch.cuda.device(device):
        stream = backend.current_stream_handle(device)
        for launch in plan_launches(specs):
            table = pack(launch, specs, scalars, b1, b2)
            err = fn(ctypes.byref(table), launch.blocks, stream)
            if err != 0:
                raise RuntimeError(f"adam_update launch failed: CUDA error {err}")
            backend.count_launch("adam_update")
