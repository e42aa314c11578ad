"""Directional and positional encodings: spherical harmonics and the
cell-major multi-resolution hash grid.

Counterpart of ``uncertainty_nerf_gs_tpu/ops/encodings.py`` for the cell
layout, the default ``grid_layout``. ``CellHashEncoding.cells`` has the JAX
package's shape (L, n_rows, 128): cpr = 128 // (8F) cells per row, cell c at
lanes [(c % cpr) * 8F, ...), corner order c = 4x + 2y + z with F innermost.
Read row-major, that memory is (L, n_rows * cpr, 8, F), so the lookup
gathers one (8, F) block per sample and level and needs no one-hot selects.

``cell_lookup`` is the kernel pair's wrapper: on a CUDA tensor it launches
``csrc/hash_grid.cu`` (K4 forward: index, gather and trilerp of every level
in one launch, summing each cell's corners in ``corner_sum``'s tree, so that
it equals the plain version bit for bit; K5 backward: the lookups sorted by cell with a hand-written
stable radix sort of ``cell_keys_reference``'s keys, then each cell's sum
taken in a fixed order and stored once, with no float atomic, so that two
launches give the same bits), on a CPU tensor it runs
``cell_lookup_reference``, the plain version, and autograd through it.
``CellLookup`` records the forward's choice, so its backward follows it.

The ensemble's layout (``pack_member_cell_tables``) stores M members' cells
as (L, T, 8, M, F): one row of 8 corners x M members x F features a cell,
the JAX package's packed row without its pad lanes. ``packed_cell_lookup``
is K6's wrapper (``csrc/hash_grid.cu``: K4's cell location and corner tree
over the packed row, forward only; on a CPU tensor its plain version
``packed_cell_lookup_reference``), and ``packed_cell_lookup_strided`` the
JAX package's per-level anchor striding over it (K6's strided entry, which
looks up each level's anchors and lerps them in one launch; its plain
version ``packed_cell_lookup_strided_reference``).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch import nn

from uncertainty_nerf_gs_torch.ops import backend

# ---------------------------------------------------------------------------
# Spherical harmonics (degree <= 4, i.e. up to 16 components).
# ---------------------------------------------------------------------------


def sh_encoding(directions: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """Real SH basis values of (..., 3) unit directions: (..., levels**2)."""
    if not 1 <= levels <= 4:
        raise ValueError(f"SH levels must be in [1,4], got {levels}")
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z

    comps = [torch.full_like(x, 0.28209479177387814)]  # l=0
    if levels > 1:
        comps += [
            0.4886025119029199 * y,
            0.4886025119029199 * z,
            0.4886025119029199 * x,
        ]
    if levels > 2:
        comps += [
            1.0925484305920792 * xy,
            1.0925484305920792 * yz,
            0.9461746957575601 * zz - 0.31539156525252005,
            1.0925484305920792 * xz,
            0.5462742152960396 * (xx - yy),
        ]
    if levels > 3:
        comps += [
            0.5900435899266435 * y * (3.0 * xx - yy),
            2.890611442640554 * xy * z,
            0.4570457994644658 * y * (5.0 * zz - 1.0),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.4570457994644658 * x * (5.0 * zz - 1.0),
            1.445305721320277 * z * (xx - yy),
            0.5900435899266435 * x * (xx - 3.0 * yy),
        ]
    return torch.stack(comps, dim=-1)


# ---------------------------------------------------------------------------
# Multi-resolution hash grid, cell layout.
# ---------------------------------------------------------------------------

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def _hash_corner_indices(corners: torch.Tensor, table_size: int) -> torch.Tensor:
    """Spatial hash of non-negative integer grid coords (..., 3) to table
    slots, in the JAX package's wrapping uint32 arithmetic: each product is
    taken in int64 and masked to 32 bits, then XORed, then reduced."""
    c = corners.to(torch.int64)
    h = (c[..., 0] * _PRIMES[0]) & _U32
    h = h ^ ((c[..., 1] * _PRIMES[1]) & _U32)
    h = h ^ ((c[..., 2] * _PRIMES[2]) & _U32)
    return h % table_size


def cell_indices(
    positions: torch.Tensor, res: int, table_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cell index + trilinear corner weights for (n, 3) positions in [0, 1].

    Returns (idx (n,) int64, weights (n, 8)); corner order c = 4x + 2y + z.
    Dense indexing where the level's res**3 cells fit the table, the spatial
    hash of the cell's base corner otherwise.
    """
    scaled = positions * res
    base = torch.floor(torch.clamp(scaled, 0, res * (1 - 1e-7))).to(torch.int64)
    base = torch.clamp(base, max=res - 1)
    frac = scaled - base.to(scaled.dtype)
    if res**3 <= table_size:
        idx = base[..., 0] + res * (base[..., 1] + res * base[..., 2])
    else:
        idx = _hash_corner_indices(base, table_size)
    wx = torch.stack([1.0 - frac[..., 0], frac[..., 0]], -1)  # (n, 2)
    wy = torch.stack([1.0 - frac[..., 1], frac[..., 1]], -1)
    wz = torch.stack([1.0 - frac[..., 2], frac[..., 2]], -1)
    w = (
        wx[..., :, None, None] * wy[..., None, :, None] * wz[..., None, None, :]
    ).reshape(positions.shape[:-1] + (8,))
    return idx, w


def corner_sum(products: torch.Tensor) -> torch.Tensor:
    """(n, 8, F) weighted corners -> (n, F), summed in K4's tree
    ((c0 + c1) + (c2 + c3)) + ((c4 + c5) + (c6 + c7)): pairwise adds of the
    rounded products, the same association on every device."""
    pairs = products[:, 0::2] + products[:, 1::2]  # c0+c1, c2+c3, c4+c5, c6+c7
    quads = pairs[:, 0::2] + pairs[:, 1::2]
    return quads[:, 0] + quads[:, 1]


def cell_lookup_reference(
    cells: torch.Tensor,
    positions: torch.Tensor,
    resolutions,
    table_size: int,
    features_per_level: int = 2,
) -> torch.Tensor:
    """Plain version: cells (L, n_rows, 128), positions (n, 3) in [0, 1]
    -> (n, L * F) features, level-major. Differentiable by autograd."""
    levels = cells.shape[0]
    feats = features_per_level
    blocks = cells.reshape(levels, -1, 8, feats)  # (L, n_rows * cpr, 8, F)
    outs = []
    for lvl, res in enumerate(np.asarray(resolutions)):
        idx, w = cell_indices(positions, int(res), table_size)
        corner = blocks[lvl].index_select(0, idx)  # (n, 8, F): ONE gather
        outs.append(corner_sum(corner * w[..., None]))
    return torch.cat(outs, dim=-1)


def cell_lookup_vjp_reference(
    cells: torch.Tensor,
    positions: torch.Tensor,
    resolutions,
    table_size: int,
    features_per_level: int,
    g_out: torch.Tensor,
    need_positions: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain backward: autograd through ``cell_lookup_reference``. Returns
    (dense g_cells, g_positions or None)."""
    with torch.enable_grad():
        c = cells.detach().requires_grad_(True)
        p = positions.detach().requires_grad_(need_positions)
        out = cell_lookup_reference(c, p, resolutions, table_size, features_per_level)
        grads = torch.autograd.grad(out, [c, p] if need_positions else [c], g_out)
    return grads[0], (grads[1] if need_positions else None)


def key_bits(num_levels: int, table_size: int) -> tuple[int, int]:
    """(bits of the cell index, bits of the whole key) of the keys K5 sorts:
    the level above the cell index."""
    cell = max(int(table_size) - 1, 0).bit_length()
    return cell, cell + max(int(num_levels) - 1, 0).bit_length()


def cell_keys_reference(positions: torch.Tensor, resolutions, table_size: int) -> torch.Tensor:
    """Plain version of K5's keys: (n * L,) int64, lookup (i, l) at i * L + l,
    key = l << cell_bits | cell index. Sorting them orders the lookups
    level-major, then by cell."""
    resolutions = np.asarray(resolutions)
    cell_bits, _ = key_bits(len(resolutions), table_size)
    keys = [
        cell_indices(positions, int(res), table_size)[0] | (lvl << cell_bits)
        for lvl, res in enumerate(resolutions)
    ]
    return torch.stack(keys, dim=1).reshape(-1)


KERNEL = "hash_grid"
MAX_LEVELS = 32  # csrc/hash_grid.cu's per-level constants
MAX_KEY_BITS = 31  # csrc/hash_grid.cu's keys leave the top bit free


def _check(cells, positions, resolutions, table_size, features_per_level) -> None:
    """Raises on what the kernels do not take, on every device."""
    for name, t in (("cells", cells), ("positions", positions)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides {t.stride()}")
    if positions.device != cells.device:
        raise ValueError(f"positions are on {positions.device}, cells on {cells.device}")
    if positions.dim() != 2 or positions.shape[1] != 3:
        raise ValueError(f"positions must be (n, 3), got {tuple(positions.shape)}")
    if cells.dim() != 3 or cells.shape[2] != 128:
        raise ValueError(f"cells must be (L, n_rows, 128), got {tuple(cells.shape)}")
    if features_per_level not in (1, 2, 4, 8, 16):
        raise ValueError(f"features_per_level must divide 16, got {features_per_level}")
    levels = cells.shape[0]
    if len(resolutions) != levels or not 1 <= levels <= MAX_LEVELS:
        raise ValueError(
            f"{len(resolutions)} resolutions for {levels} levels (at most {MAX_LEVELS})"
        )
    cpr = 128 // (8 * features_per_level)
    if not 1 <= table_size <= cells.shape[1] * cpr:
        raise ValueError(f"table_size {table_size} exceeds the {cells.shape[1] * cpr} cells a level")
    if key_bits(levels, table_size)[1] > MAX_KEY_BITS:
        raise ValueError(f"{levels} levels of {table_size} cells need more than {MAX_KEY_BITS} key bits")
    if positions.shape[0] * levels >= 2**31:
        raise ValueError(f"{positions.shape[0]} positions x {levels} levels is too many lookups")
    if cells.data_ptr() % 16:  # K4 reads each cell as float4s
        raise ValueError(f"cells must be 16-byte aligned, got address {cells.data_ptr():#x}")


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "cell_lookup_fwd_f32": [_P, _P, _P, _I, _I, _L, _I, _I, _P, _P],
    "cell_lookup_bwd_f32": [_P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _P, _P, _L, _P],
    "cell_lookup_sort_u32": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _L, _P],
    "cell_lookup_bwd_scratch_bytes": [_I, _I, _I, _I],
}


def _entry(name: str):
    """A C entry point of the kernel library, built and loaded at first use."""
    restype = _L if name == "cell_lookup_bwd_scratch_bytes" else _I
    return backend.entry(KERNEL, name, _ARGTYPES[name], restype)


def _level_args(cells, resolutions, table_size, features_per_level):
    res = (ctypes.c_int * len(resolutions))(*resolutions)
    return (cells.shape[0], cells.shape[1] * 128, table_size, features_per_level, res)


def _scratch(n, levels, table_size, features_per_level, device) -> torch.Tensor:
    """K5's scratch buffer (keys, ids, the sort's counts, the partial sums of
    cells whose lookups cross a chunk boundary), as its source sizes it."""
    nbytes = _entry("cell_lookup_bwd_scratch_bytes")(n, levels, table_size, features_per_level)
    if nbytes < 0:
        raise ValueError(f"K5 takes no {n} x {levels} lookups into {table_size} cells")
    return torch.empty(max(nbytes, 1), dtype=torch.uint8, device=device)


def cell_lookup_fwd(cells, positions, resolutions, table_size, features_per_level):
    """K4: one launch for every level. Inputs as ``_check`` takes them."""
    out = torch.empty(
        (positions.shape[0], cells.shape[0] * features_per_level),
        dtype=torch.float32, device=cells.device,
    )
    with torch.cuda.device(cells.device):
        err = _entry("cell_lookup_fwd_f32")(
            positions.data_ptr(), cells.data_ptr(), out.data_ptr(), positions.shape[0],
            *_level_args(cells, resolutions, table_size, features_per_level),
            backend.current_stream_handle(cells.device),
        )
    if err != 0:
        raise RuntimeError(f"cell_lookup_fwd launch failed: CUDA error {err}")
    backend.count_launch("cell_lookup_fwd")
    return out


def cell_lookup_bwd(cells, positions, resolutions, table_size, features_per_level,
                    g_out, need_positions=True):
    """K5: dense g_cells (zero-filled, the cells' shape) and, when asked,
    g_positions (n, 3), from g_out (n, L * F) contiguous float32."""
    n = positions.shape[0]
    want = (n, cells.shape[0] * features_per_level)
    if g_out.dtype != torch.float32 or tuple(g_out.shape) != want or not g_out.is_contiguous():
        raise ValueError(f"g_out must be contiguous float32 {want}, got {g_out.dtype} "
                         f"{tuple(g_out.shape)} strides {g_out.stride()}")
    if g_out.device != cells.device:
        raise ValueError(f"g_out is on {g_out.device}, cells on {cells.device}")
    g_cells = torch.zeros_like(cells)  # cells no lookup touches keep their zero
    g_pos = torch.empty_like(positions) if need_positions else None  # written in full
    scratch = _scratch(n, cells.shape[0], table_size, features_per_level, cells.device)
    with torch.cuda.device(cells.device):
        err = _entry("cell_lookup_bwd_f32")(
            positions.data_ptr(), cells.data_ptr(), g_out.data_ptr(), g_cells.data_ptr(),
            None if g_pos is None else g_pos.data_ptr(), n,
            *_level_args(cells, resolutions, table_size, features_per_level),
            scratch.data_ptr(), scratch.numel(), backend.current_stream_handle(cells.device),
        )
    if err != 0:
        raise RuntimeError(f"cell_lookup_bwd launch failed: CUDA error {err}")
    backend.count_launch("cell_lookup_bwd")
    return g_cells, g_pos


def cell_lookup_sort(positions, resolutions, table_size):
    """K5's keys and its hand-written stable sort of them, on the card, for
    checks (not counted as a K5 launch): (keys in lookup order, sorted keys,
    the sorting permutation), (n * L,) int32 each. The keys equal
    ``cell_keys_reference``'s; the permutation is the stable one."""
    resolutions = tuple(int(r) for r in np.asarray(resolutions))
    n, levels = positions.shape[0], len(resolutions)
    outs = [torch.empty(n * levels, dtype=torch.int32, device=positions.device) for _ in range(3)]
    scratch = _scratch(n, levels, table_size, 1, positions.device)
    with torch.cuda.device(positions.device):
        err = _entry("cell_lookup_sort_u32")(
            positions.data_ptr(), n, levels, table_size,
            (ctypes.c_int * levels)(*resolutions), *(o.data_ptr() for o in outs),
            scratch.data_ptr(), scratch.numel(), backend.current_stream_handle(positions.device),
        )
    if err != 0:
        raise RuntimeError(f"cell_lookup_sort launch failed: CUDA error {err}")
    return tuple(outs)


class CellLookup(torch.autograd.Function):
    """K4 forward and K5 backward on the card, the plain version and autograd
    through it elsewhere; the backward follows the forward's choice."""

    @staticmethod
    def forward(ctx, cells, positions, resolutions, table_size, features_per_level):
        ctx.kernel = backend.use_kernel(cells)
        ctx.args = (resolutions, table_size, features_per_level)
        ctx.save_for_backward(cells, positions)
        if ctx.kernel:
            return cell_lookup_fwd(cells, positions, *ctx.args)
        return cell_lookup_reference(cells, positions, *ctx.args)

    @staticmethod
    def backward(ctx, g_out):
        cells, positions = ctx.saved_tensors
        need_positions = ctx.needs_input_grad[1]
        bwd = cell_lookup_bwd if ctx.kernel else cell_lookup_vjp_reference
        g_cells, g_pos = bwd(cells, positions, *ctx.args, g_out.contiguous(), need_positions)
        return g_cells, g_pos, None, None, None


def cell_lookup(
    cells: torch.Tensor,
    positions: torch.Tensor,
    resolutions,
    table_size: int,
    features_per_level: int = 2,
) -> torch.Tensor:
    """Cell-major lookup: cells (L, n_rows, 128) float32 contiguous,
    positions (n, 3) float32 contiguous, in [0, 1] -> (n, L * F) features,
    level-major. Raises on other dtypes and layouts rather than copy."""
    resolutions = tuple(int(r) for r in np.asarray(resolutions))
    _check(cells, positions, resolutions, table_size, features_per_level)
    return CellLookup.apply(cells, positions, resolutions, table_size, features_per_level)


# ---------------------------------------------------------------------------
# The ensemble's layout: M members' cells packed into one row a cell.
# ---------------------------------------------------------------------------

MAX_MEMBERS = 8  # csrc/hash_grid.cu's K6
PACKED_FEATURES = (1, 2, 4)  # K6's F


def pack_member_cell_tables(
    stacked_rows: torch.Tensor, table_size: int, features_per_level: int = 2
) -> torch.Tensor:
    """M stacked member tables (M, L, n_rows, 128), the training layout ->
    (L, table_size, 8, M, F) float32 contiguous: one row of 8 corners x M
    members x F features a cell, so that one cell index serves the whole
    ensemble. Corner c owns the contiguous [c M F, (c + 1) M F) of the row,
    as in the JAX package, which pads each row to a multiple of 128 lanes
    for the TPU; this layout has no pad (``interop.packed_tables_from_jax``)."""
    m, levels, n_rows, _ = stacked_rows.shape
    cells = stacked_rows.reshape(m, levels, n_rows * 128 // (8 * features_per_level), 8,
                                 features_per_level)[:, :, :table_size]
    return cells.permute(1, 2, 3, 0, 4).contiguous()


def packed_cell_lookup_reference(
    packed: torch.Tensor, positions: torch.Tensor, resolutions, table_size: int
) -> torch.Tensor:
    """Plain version of K6: packed (L, T, 8, M, F), positions (n, 3) in
    [0, 1] -> (M, n, L * F). Gathers each lookup's row with index_select,
    weighs it with ``cell_indices``' weights and sums the corners in
    ``corner_sum``'s tree, so that member m's slice equals
    ``cell_lookup_reference`` on member m's own table bit for bit."""
    levels, _, _, m, feats = packed.shape
    outs = []
    for lvl, res in enumerate(np.asarray(resolutions)):
        idx, w = cell_indices(positions, int(res), table_size)
        rows = packed[lvl].index_select(0, idx)  # (n, 8, M, F): ONE gather
        outs.append(corner_sum(rows * w[:, :, None, None]))  # (n, M, F)
    out = torch.stack(outs, dim=2)  # (n, M, L, F)
    return out.permute(1, 0, 2, 3).reshape(m, positions.shape[0], levels * feats)


def _check_packed(packed, positions, resolutions, table_size, num_members, features_per_level) -> None:
    """Raises on what K6 does not take, on every device."""
    for name, t in (("packed", packed), ("positions", positions)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides {t.stride()}")
    if positions.device != packed.device:
        raise ValueError(f"positions are on {positions.device}, packed on {packed.device}")
    if positions.dim() != 2 or positions.shape[1] != 3:
        raise ValueError(f"positions must be (n, 3), got {tuple(positions.shape)}")
    if packed.dim() != 5 or packed.shape[2] != 8:
        raise ValueError(f"packed must be (L, T, 8, M, F), got {tuple(packed.shape)}")
    levels, rows, _, m, feats = packed.shape
    if not 1 <= m <= MAX_MEMBERS or m != num_members:
        raise ValueError(f"packed holds {m} members, {num_members} asked; K6 takes 1 to {MAX_MEMBERS}")
    if feats not in PACKED_FEATURES or feats != features_per_level:
        raise ValueError(f"packed holds F = {feats}, F = {features_per_level} asked; "
                         f"K6 takes F in {PACKED_FEATURES}")
    if len(resolutions) != levels or not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"{len(resolutions)} resolutions for {levels} levels (at most {MAX_LEVELS})")
    if rows != table_size:
        raise ValueError(f"packed holds {rows} cells a level, table_size is {table_size}")
    if positions.shape[0] * levels >= 2**31:
        raise ValueError(f"{positions.shape[0]} positions x {levels} levels are too many lookups for K6")
    if packed.data_ptr() % 16:  # K6 copies whole rows, 16-byte aligned
        raise ValueError(f"packed must be 16-byte aligned, got address {packed.data_ptr():#x}")


_ARGTYPES["packed_cell_lookup_fwd_f32"] = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P]


def packed_cell_lookup_fwd(packed, positions, resolutions, table_size):
    """K6: one launch for every level and member. Inputs as
    ``_check_packed`` takes them."""
    levels, _, _, m, feats = packed.shape
    n = positions.shape[0]
    out = torch.empty((m, n, levels * feats), dtype=torch.float32, device=packed.device)
    with torch.cuda.device(packed.device):
        err = _entry("packed_cell_lookup_fwd_f32")(
            positions.data_ptr(), packed.data_ptr(), out.data_ptr(), n, levels, table_size, m,
            feats, (ctypes.c_int * levels)(*resolutions),
            backend.current_stream_handle(packed.device),
        )
    if err != 0:
        raise RuntimeError(f"packed_cell_lookup_fwd launch failed: CUDA error {err}")
    backend.count_launch("packed_cell_lookup_fwd")
    return out


def packed_cell_lookup(
    packed: torch.Tensor,
    positions: torch.Tensor,
    resolutions,
    table_size: int,
    num_members: int,
    features_per_level: int = 2,
) -> torch.Tensor:
    """Ensemble lookup, one row read serving all M members: packed (L, T,
    8, M, F) from ``pack_member_cell_tables``, positions (n, 3) float32
    contiguous in [0, 1] -> (M, n, L * F). K6 on the card, its plain
    version on the CPU; forward only (the JAX package never differentiates
    it). Raises on other dtypes and layouts rather than copy."""
    resolutions = tuple(int(r) for r in np.asarray(resolutions))
    _check_packed(packed, positions, resolutions, table_size, num_members, features_per_level)
    if backend.use_kernel(packed):
        return packed_cell_lookup_fwd(packed, positions, resolutions, table_size)
    return packed_cell_lookup_reference(packed, positions, resolutions, table_size)


def anchor_stride(num_samples: int, res: int, stride_scale: float = 1.0, max_stride: int = 8) -> int:
    """K_l of ``packed_cell_lookup_strided``: clamp(stride_scale S // (2 R_l),
    1, max_stride), with ``int(stride_scale * S)`` as the JAX package
    takes it."""
    return int(np.clip(int(stride_scale * num_samples) // (2 * int(res)), 1, max_stride))


def packed_cell_lookup_strided_reference(
    packed: torch.Tensor,
    norm_positions: torch.Tensor,
    t_mid: torch.Tensor,
    resolutions,
    table_size: int,
    strides,
) -> torch.Tensor:
    """Plain version of K6's strided entry, the JAX package's per-level
    anchor striding: level l is looked up (``packed_cell_lookup_reference``)
    only at every K_l-th sample (``strides``) and its features are lerped
    along the ray in ``t_mid`` between the bracketing anchors (static
    anchors 0, K, ..., the last clamped to S - 1); a level with K_l = 1 is
    looked up at every sample. norm_positions (R, S, 3), t_mid (R, S) ->
    (M, R, S, L * F)."""
    _, _, _, m, feats = packed.shape
    r, s, _ = norm_positions.shape
    # each level written into its slice of the output (in place of a
    # concatenation of F-wide pieces, which the card copies slowly)
    out = torch.empty((m, r, s, len(resolutions) * feats), dtype=torch.float32,
                      device=norm_positions.device)
    for lvl, (res, k) in enumerate(zip(resolutions, strides)):
        level = packed[lvl:lvl + 1]
        dst = out[..., lvl * feats:(lvl + 1) * feats]
        if k == 1:
            f = packed_cell_lookup_reference(level, norm_positions.reshape(-1, 3), [int(res)], table_size)
            dst.copy_(f.reshape(m, r, s, feats))
            continue
        # anchors at 0, k, ...; one always lies past s - 1 (clamped back), so
        # every sample has a right bracket, where a repeated last anchor gives
        # w = 0 through the max(t_right - t_left, 1e-12) guard
        pad = (-(s - 1)) % k or k
        na = (s - 1 + pad) // k + 1
        idx = torch.from_numpy(np.minimum(np.arange(na) * k, s - 1)).to(norm_positions.device)
        pos_a = norm_positions[:, idx]  # (R, A, 3)
        t_a = t_mid[:, idx]  # (R, A)
        f_a = packed_cell_lookup_reference(level, pos_a.reshape(-1, 3), [int(res)], table_size)
        f_a = f_a.reshape(m, r, na, feats)
        left = torch.repeat_interleave(f_a[:, :, :-1], k, dim=2)[:, :, :s]
        right = torch.repeat_interleave(f_a[:, :, 1:], k, dim=2)[:, :, :s]
        t_left = torch.repeat_interleave(t_a[:, :-1], k, dim=1)[:, :s]
        t_right = torch.repeat_interleave(t_a[:, 1:], k, dim=1)[:, :s]
        w = (t_mid - t_left) / torch.clamp(t_right - t_left, min=1e-12)
        w = torch.clamp(w, 0.0, 1.0)[None, :, :, None]
        torch.add(left * (1.0 - w), right * w, out=dst)
    return out


_ARGTYPES["packed_cell_lookup_strided_fwd_f32"] = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P]
_ARGTYPES["packed_cell_lookup_shared_bytes"] = [_I, _I, _I]


def packed_cell_lookup_strided_fwd(packed, norm_positions, t_mid, resolutions, table_size, strides):
    """K6's strided entry: one launch for every level and member, the
    anchors looked up and lerped in it. Inputs as ``packed_cell_lookup_strided``
    takes them."""
    levels, _, _, m, feats = packed.shape
    r, s, _ = norm_positions.shape
    out = torch.empty((m, r, s, levels * feats), dtype=torch.float32, device=packed.device)
    with torch.cuda.device(packed.device):
        err = _entry("packed_cell_lookup_strided_fwd_f32")(
            norm_positions.data_ptr(), t_mid.data_ptr(), packed.data_ptr(), out.data_ptr(), r, s, levels,
            table_size, m, feats, (ctypes.c_int * levels)(*resolutions), (ctypes.c_int * levels)(*strides),
            backend.current_stream_handle(packed.device),
        )
    if err != 0:
        raise RuntimeError(f"packed_cell_lookup_strided_fwd launch failed: CUDA error {err}")
    backend.count_launch("packed_cell_lookup_strided")
    return out


def packed_cell_lookup_strided(
    packed: torch.Tensor,
    norm_positions: torch.Tensor,
    t_mid: torch.Tensor,
    resolutions,
    table_size: int,
    num_members: int,
    features_per_level: int = 2,
    max_stride: int = 8,
    stride_scale: float = 1.0,
) -> torch.Tensor:
    """Ensemble lookup with per-level anchor striding along the ray, as the
    JAX package's: level l is looked up only at every K_l-th sample
    (``anchor_stride``) and lerped along the ray in ``t_mid`` between the
    bracketing anchors. norm_positions (R, S, 3), t_mid (R, S) float32
    contiguous -> (M, R, S, L * F). K6's strided entry on the card (one
    launch), its plain version ``packed_cell_lookup_strided_reference`` on
    the CPU. Raises on other dtypes and layouts rather than copy."""
    resolutions = tuple(int(r) for r in np.asarray(resolutions))
    for name, t in (("norm_positions", norm_positions), ("t_mid", t_mid)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides {t.stride()}")
    if norm_positions.dim() != 3 or norm_positions.shape[2] != 3:
        raise ValueError(f"norm_positions must be (R, S, 3), got {tuple(norm_positions.shape)}")
    if tuple(t_mid.shape) != tuple(norm_positions.shape[:2]) or t_mid.device != packed.device:
        raise ValueError(f"t_mid must be {tuple(norm_positions.shape[:2])} on {packed.device}, "
                         f"got {tuple(t_mid.shape)} on {t_mid.device}")
    _check_packed(packed, norm_positions.view(-1, 3), resolutions, table_size, num_members, features_per_level)
    s = norm_positions.shape[1]
    strides = tuple(anchor_stride(s, r, stride_scale, max_stride) for r in resolutions)
    if backend.use_kernel(packed):
        return packed_cell_lookup_strided_fwd(packed, norm_positions, t_mid, resolutions, table_size, strides)
    return packed_cell_lookup_strided_reference(packed, norm_positions, t_mid, resolutions, table_size, strides)


def hash_grid_resolutions(num_levels: int, min_res: int, max_res: int) -> np.ndarray:
    """Per-level resolutions N_l = floor(N_min * b^l) with tcnn's growth
    factor, on the host: they select dense or hashed indexing per level."""
    if num_levels > 1:
        growth = math.exp((math.log(max_res) - math.log(min_res)) / (num_levels - 1))
    else:
        growth = 1.0
    return np.array(
        [int(math.floor(min_res * growth**lvl)) for lvl in range(num_levels)],
        dtype=np.int32,
    )


class CellHashEncoding(nn.Module):
    """Cell-major multi-resolution hash grid (one gather per sample-level).

    Owns ``cells`` of shape (num_levels, n_rows, 128), as the JAX package
    stores it, initialised uniform in [-init_scale, init_scale).
    """

    def __init__(
        self,
        num_levels: int = 16,
        min_res: int = 16,
        max_res: int = 2048,
        log2_hashmap_size: int = 19,
        features_per_level: int = 2,
        init_scale: float = 1e-4,
        *,
        device: torch.device | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if 128 % (8 * features_per_level):
            raise ValueError("8 * features_per_level must divide 128")
        self.features_per_level = features_per_level
        self.table_size = 2**log2_hashmap_size
        cpr = 128 // (8 * features_per_level)
        n_rows = (self.table_size + cpr - 1) // cpr
        self.resolutions = hash_grid_resolutions(num_levels, min_res, max_res)
        cells = torch.empty((num_levels, n_rows, 128), device=device)
        self.cells = nn.Parameter(
            cells.uniform_(-init_scale, init_scale, generator=generator)
        )

    @property
    def output_dim(self) -> int:
        return len(self.resolutions) * self.features_per_level

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        flat = positions.reshape(-1, 3)
        out = cell_lookup(
            self.cells, flat, self.resolutions, self.table_size,
            self.features_per_level,
        )
        return out.reshape(*positions.shape[:-1], self.output_dim)
