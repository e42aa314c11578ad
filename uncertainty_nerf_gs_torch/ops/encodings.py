"""Directional and positional encodings: spherical harmonics, the NeRF
frequency encoding and the multi-resolution hash grid in its cell, hybrid
and corner layouts.

Counterpart of ``uncertainty_nerf_gs_tpu/ops/encodings.py``.
``CellHashEncoding.cells`` has the JAX package's shape (L, n_rows, 128): cpr = 128 // (8F) cells per row, cell c at
lanes [(c % cpr) * 8F, ...), corner order c = 4x + 2y + z with F innermost.
Read row-major, that memory is (L, n_rows * cpr, 8, F), so the lookup
gathers one (8, F) block per sample and level and needs no one-hot selects.
``HybridHashEncoding`` keeps the coarse levels as canonical corner grids
(``corners_{lvl}``, exact corner sharing), expanded each call into res^3
cell rows by ``dense_corner_to_cell_rows`` (8 static slices), and the fine
levels hashed in ``cells``: every level has a table of its own, and the
lookups take per-level tables and sizes (``_per_level_tables``).
``HashEncoding`` is the corner layout, tcnn's semantics: a ``table`` (L, T,
F) whose entries are the grid's corners, each lookup reading its 8 corners
on their own (``hash_encoding_lookup``: K7 forward, K8 backward on the card,
``hash_encoding_lookup_reference`` on the CPU).

``cell_lookup`` is the kernel pair's wrapper: on a CUDA tensor it launches
``csrc/hash_grid.cu`` (K4 forward: index, gather and trilerp of every level
in one launch, each level's table reached through its own base pointer,
summing each cell's corners in ``corner_sum``'s tree, so that it equals the
plain version bit for bit; K5 backward: the lookups sorted by (level, cell)
with a hand-written stable radix sort of ``cell_keys_reference``'s keys,
then each cell's sum taken in a fixed order and stored once, with no float
atomic, so that two launches give the same bits), on a CPU tensor it runs
``cell_lookup_reference``, the plain version, and autograd through it.
``CellLookup`` records the forward's choice, so its backward follows it.

The ensemble's layout (``pack_member_cell_tables``) stores M members' cells
as (L, T, 8, M, F): one row of 8 corners x M members x F features a cell,
the JAX package's packed row without its pad lanes, in float32, bf16 or
int8 (``quantize_cell_tables_int8``: per-level scales). ``packed_cell_lookup``
is K6's wrapper (``csrc/hash_grid.cu``: K4's cell location and corner tree
over the packed row, forward only; on a CPU tensor its plain version
``packed_cell_lookup_reference``), and ``packed_cell_lookup_strided`` the
JAX package's per-level anchor striding over it (K6's strided entry, which
looks up each level's anchors and lerps them in one launch; its plain
version ``packed_cell_lookup_strided_reference``). Both take a stacked
tensor, a per-level list (hybrid) or the ``{"tables", "scales"}`` dict form,
folded (``fold_packed_tables``) or split (``split_packed_tables``) levels
included: those two are the JAX package's exact relayouts for XLA's gather
on a TPU; here each is a view of the same memory, and K6 reads the same
rows through it.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F
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


def nerf_encoding(
    x: torch.Tensor,
    num_frequencies: int = 6,
    min_freq_exp: float = 0.0,
    max_freq_exp: float = 5.0,
    include_input: bool = False,
) -> torch.Tensor:
    """Classic NeRF sin/cos frequency encoding of (..., d) inputs:
    (..., [d +] 2 d num_frequencies), sines before cosines, frequency
    innermost, as the JAX package lays it out."""
    freqs = 2.0 ** torch.linspace(min_freq_exp, max_freq_exp, num_frequencies, device=x.device)
    scaled = (x[..., None] * freqs).reshape(*x.shape[:-1], -1) * 2.0 * math.pi
    out = torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)
    if include_input:
        out = torch.cat([x, out], dim=-1)
    return out


# ---------------------------------------------------------------------------
# Multi-resolution hash grid: cell and hybrid layouts.
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


def _cell_index(base: torch.Tensor, res: int, table_size: int) -> torch.Tensor:
    """Index of the cell with base corner ``base`` (..., 3): dense where the
    level's res**3 cells fit the table, the spatial hash otherwise."""
    if res**3 <= table_size:
        return base[..., 0] + res * (base[..., 1] + res * base[..., 2])
    return _hash_corner_indices(base, table_size)


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
    idx = _cell_index(base, res, table_size)
    wx = torch.stack([1.0 - frac[..., 0], frac[..., 0]], -1)  # (n, 2)
    wy = torch.stack([1.0 - frac[..., 1], frac[..., 1]], -1)
    wz = torch.stack([1.0 - frac[..., 2], frac[..., 2]], -1)
    w = (
        wx[..., :, None, None] * wy[..., None, :, None] * wz[..., None, None, :]
    ).reshape(positions.shape[:-1] + (8,))
    return idx, w


def corner_sum(products: torch.Tensor) -> torch.Tensor:
    """(n, 8, ...) weighted corners -> (n, ...), summed in K4's tree
    ((c0 + c1) + (c2 + c3)) + ((c4 + c5) + (c6 + c7)): pairwise adds of the
    rounded products, the same association on every device."""
    pairs = products[:, 0::2] + products[:, 1::2]  # c0+c1, c2+c3, c4+c5, c6+c7
    quads = pairs[:, 0::2] + pairs[:, 1::2]
    return quads[:, 0] + quads[:, 1]


def _per_level_tables(table_rows, table_size, levels: int) -> tuple[list, list[int]]:
    """(tables, sizes) as per-level lists, from a stacked (L, ...) tensor and
    one size (the cell layout) or from per-level lists of tables and sizes
    (the hybrid layout: dense levels of res^3 cells beside hashed levels of
    ``table_size``), as the JAX package's ``_per_level_tables``."""
    if not isinstance(table_rows, (list, tuple)) and table_rows.shape[0] != levels:
        raise ValueError(f"{table_rows.shape[0]} stacked tables for {levels} levels")
    tables = list(table_rows) if isinstance(table_rows, (list, tuple)) else [table_rows[l] for l in range(levels)]
    if isinstance(table_size, (list, tuple, np.ndarray)):
        sizes = [int(s) for s in table_size]
    else:
        sizes = [int(table_size)] * levels
    if len(tables) != levels or len(sizes) != levels:
        raise ValueError(f"{len(tables)} tables and {len(sizes)} sizes for {levels} levels")
    return tables, sizes


def hybrid_is_dense(res: int, table_size: int) -> bool:
    """The hybrid layout's dense criterion: canonical corner storage of
    (res + 1)^3 F params is no bigger than a hashed cell level's table_size
    * 8F as long as (res + 1)^3 <= 8 table_size."""
    return (int(res) + 1) ** 3 <= 8 * table_size


def dense_corner_to_cell_rows(grid: torch.Tensor, res: int, features_per_level: int = 2) -> torch.Tensor:
    """A canonical corner grid (res + 1, res + 1, (res + 1) F), axes (z, y,
    x F), expanded to cell-major rows (n_rows, 128): cell x + res (y + res z)
    holds its 8 corners in the order c = 4x + 2y + z, the rows padded with
    zeros to whole rows. Eight static slices stacked (copies, no gather), so
    neighbouring cells hold the same corner values; the backward is
    autograd's slice transpose, which adds in a fixed order."""
    feats = features_per_level
    block = 8 * feats
    cpr = 128 // block
    g = grid.reshape(res + 1, res + 1, res + 1, feats)  # (z, y, x, F)
    slices = []
    for corner in range(8):
        a, b, c = (corner >> 2) & 1, (corner >> 1) & 1, corner & 1
        slices.append(g[c:c + res, b:b + res, a:a + res])
    cells = torch.stack(slices, dim=3).reshape(res**3, block)  # C-order (z, y, x): x + res (y + res z)
    pad = (-(res**3)) % cpr
    if pad:
        cells = F.pad(cells, (0, 0, 0, pad))
    return cells.reshape(-1, 128)


def cell_lookup_reference(
    cells,
    positions: torch.Tensor,
    resolutions,
    table_size,
    features_per_level: int = 2,
) -> torch.Tensor:
    """Plain version: cells (L, n_rows, 128) or a per-level list of (n_rows_l,
    128) tables with ``table_size`` a per-level list of cell counts, positions
    (n, 3) in [0, 1] -> (n, L * F) features, level-major. Differentiable by
    autograd."""
    resolutions = np.asarray(resolutions)
    feats = features_per_level
    tables, sizes = _per_level_tables(cells, table_size, len(resolutions))
    outs = []
    for lvl, res in enumerate(resolutions):
        idx, w = cell_indices(positions, int(res), sizes[lvl])
        corner = tables[lvl].reshape(-1, 8, feats).index_select(0, idx)  # (n, 8, F): ONE gather
        outs.append(corner_sum(corner * w[..., None]))
    return torch.cat(outs, dim=-1)


def cell_lookup_vjp_reference(
    cells,
    positions: torch.Tensor,
    resolutions,
    table_size,
    features_per_level: int,
    g_out: torch.Tensor,
    need_positions: bool = True,
):
    """Plain backward: autograd through ``cell_lookup_reference``. Returns
    (g_cells in the cells' form, dense, g_positions or None)."""
    stacked = isinstance(cells, torch.Tensor)
    leaves = [cells] if stacked else list(cells)
    with torch.enable_grad():
        leaves = [c.detach().requires_grad_(True) for c in leaves]
        p = positions.detach().requires_grad_(need_positions)
        out = cell_lookup_reference(leaves[0] if stacked else leaves, p, resolutions, table_size,
                                    features_per_level)
        grads = torch.autograd.grad(out, leaves + ([p] if need_positions else []), g_out, allow_unused=True)
    g_cells = [torch.zeros_like(c) if g is None else g for c, g in zip(leaves, grads)]
    return g_cells[0] if stacked else g_cells, (grads[-1] if need_positions else None)


def key_offsets(sizes) -> list[int]:
    """K5's first key of each level: the cells of the levels before it."""
    return [int(x) for x in np.concatenate([[0], np.cumsum(np.asarray(sizes, np.int64))[:-1]])]


def key_bits(num_levels: int, table_size) -> tuple[int, int]:
    """(bits of the largest level's cell index, bits of the whole key) of the
    keys K5 sorts: the level's first key (``key_offsets``) plus the cell
    index, which for equal power-of-two tables is the level above the cell
    index."""
    sizes = table_size if isinstance(table_size, (list, tuple, np.ndarray)) else [table_size] * num_levels
    cell = max(int(max(sizes)) - 1, 0).bit_length()
    return cell, max(int(sum(int(x) for x in sizes)) - 1, 0).bit_length()


def cell_keys_reference(positions: torch.Tensor, resolutions, table_size) -> torch.Tensor:
    """Plain version of K5's keys: (n * L,) int64, lookup (i, l) at i * L + l,
    key = key_offsets[l] + cell index. Sorting them orders the lookups
    level-major, then by cell."""
    resolutions = np.asarray(resolutions)
    _, sizes = _per_level_tables([None] * len(resolutions), table_size, len(resolutions))
    keys = [
        cell_indices(positions, int(res), sizes[lvl])[0] + first
        for lvl, (res, first) in enumerate(zip(resolutions, key_offsets(sizes)))
    ]
    return torch.stack(keys, dim=1).reshape(-1)


KERNEL = "hash_grid"
MAX_LEVELS = 32  # csrc/hash_grid.cu's per-level constants
MAX_KEY_BITS = 31  # csrc/hash_grid.cu's keys leave the top bit free


def _check(tables, positions, resolutions, sizes, features_per_level) -> None:
    """Raises on what the kernels do not take, on every device: ``tables``
    one (n_rows, 128) tensor a level."""
    if positions.dtype != torch.float32:
        raise TypeError(f"positions must be float32, got {positions.dtype}")
    if not positions.is_contiguous():
        raise ValueError(f"positions must be contiguous, got strides {positions.stride()}")
    if positions.dim() != 2 or positions.shape[1] != 3:
        raise ValueError(f"positions must be (n, 3), got {tuple(positions.shape)}")
    if features_per_level not in (1, 2, 4, 8, 16):
        raise ValueError(f"features_per_level must divide 16, got {features_per_level}")
    levels = len(tables)
    if len(resolutions) != levels or len(sizes) != levels or not 1 <= levels <= MAX_LEVELS:
        raise ValueError(
            f"{len(resolutions)} resolutions and {len(sizes)} sizes for {levels} levels (at most {MAX_LEVELS})"
        )
    cpr = 128 // (8 * features_per_level)
    for lvl, (t, size) in enumerate(zip(tables, sizes)):
        if t.dtype != torch.float32:
            raise TypeError(f"cells must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"cells must be contiguous, got strides {t.stride()}")
        if t.device != positions.device:
            raise ValueError(f"positions are on {positions.device}, cells on {t.device}")
        if t.dim() != 2 or t.shape[1] != 128:
            raise ValueError(f"level {lvl}'s cells must be (n_rows, 128), got {tuple(t.shape)}")
        if not 1 <= size <= t.shape[0] * cpr:
            raise ValueError(f"table_size {size} exceeds the {t.shape[0] * cpr} cells of level {lvl}")
        if t.data_ptr() % 16:  # K4 reads each cell as float4s
            raise ValueError(f"cells must be 16-byte aligned, got address {t.data_ptr():#x}")
    if key_bits(levels, sizes)[1] > MAX_KEY_BITS:
        raise ValueError(f"{levels} levels of {max(sizes)} cells need more than {MAX_KEY_BITS} key bits")
    if positions.shape[0] * levels >= 2**31:
        raise ValueError(f"{positions.shape[0]} positions x {levels} levels is too many lookups")


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "cell_lookup_fwd_f32": [_P, _P, _P, _I, _I, _P, _I, _P, _P],
    "cell_lookup_bwd_f32": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _P, _L, _P],
    "cell_lookup_sort_u32": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _L, _P],
    "cell_lookup_bwd_scratch_bytes": [_I, _I, _P, _I],
}


def _entry(name: str):
    """A C entry point of the kernel library, built and loaded at first use."""
    restype = _L if name == "cell_lookup_bwd_scratch_bytes" else _I
    return backend.entry(KERNEL, name, _ARGTYPES[name], restype)


def _ints(values):
    return (ctypes.c_int * len(values))(*(int(v) for v in values))


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _scratch(n, sizes, features_per_level, device) -> torch.Tensor:
    """K5's scratch buffer (keys, ids, the sort's counts, the partial sums of
    cells whose lookups cross a chunk boundary), as its source sizes it."""
    nbytes = _entry("cell_lookup_bwd_scratch_bytes")(n, len(sizes), _ints(sizes), features_per_level)
    if nbytes < 0:
        raise ValueError(f"K5 takes no {n} x {len(sizes)} lookups into {list(sizes)} cells")
    return torch.empty(max(nbytes, 1), dtype=torch.uint8, device=device)


def _sources(cells, levels: int) -> tuple[tuple, tuple]:
    """(sources, level_map) of a stacked (L, n_rows, 128) tensor or a
    per-level list: level l is ``sources[s][j]`` for (s, j) = level_map[l]
    (j None: the source itself)."""
    if isinstance(cells, torch.Tensor):
        if cells.dim() < 1 or cells.shape[0] != levels:
            raise ValueError(f"cells stack {cells.shape[0] if cells.dim() else 0} levels, {levels} resolutions")
        return (cells,), tuple((0, lvl) for lvl in range(levels))
    return tuple(cells), tuple((lvl, None) for lvl in range(len(cells)))


def _views(sources, level_map) -> list[torch.Tensor]:
    return [sources[s] if j is None else sources[s][j] for s, j in level_map]


def _fwd(sources, level_map, positions, resolutions, sizes, features_per_level):
    """K4: one launch for every level. Inputs as ``_check`` takes them."""
    tables = _views(sources, level_map)
    out = torch.empty((positions.shape[0], len(tables) * features_per_level),
                      dtype=torch.float32, device=positions.device)
    with torch.cuda.device(positions.device):
        err = _entry("cell_lookup_fwd_f32")(
            positions.data_ptr(), _pointers(tables), out.data_ptr(), positions.shape[0], len(tables),
            _ints(sizes), features_per_level, _ints(resolutions),
            backend.current_stream_handle(positions.device),
        )
    if err != 0:
        raise RuntimeError(f"cell_lookup_fwd launch failed: CUDA error {err}")
    backend.count_launch("cell_lookup_fwd")
    return out


def _bwd(sources, level_map, positions, resolutions, sizes, features_per_level, g_out, need_positions,
         need_tables=True):
    """K5: (dense zero-filled gradient of each source, g_positions or None).
    Without ``need_tables`` (no table needs a gradient: the pose gradient)
    K5 runs its positions-only mode, the keys kernel's position gradient
    alone, with no zero-fill, sort or reduction: (None for each source,
    g_positions), the full backward's g_positions bit for bit."""
    n = positions.shape[0]
    tables = _views(sources, level_map)
    want = (n, len(tables) * features_per_level)
    if g_out.dtype != torch.float32 or tuple(g_out.shape) != want or not g_out.is_contiguous():
        raise ValueError(f"g_out must be contiguous float32 {want}, got {g_out.dtype} "
                         f"{tuple(g_out.shape)} strides {g_out.stride()}")
    if g_out.device != positions.device:
        raise ValueError(f"g_out is on {g_out.device}, positions on {positions.device}")
    if not need_tables:
        if not need_positions:
            return [None] * len(sources), None
        g_pos = torch.empty_like(positions)
        with torch.cuda.device(positions.device):
            err = _entry("cell_lookup_bwd_f32")(
                positions.data_ptr(), _pointers(tables), g_out.data_ptr(), None, g_pos.data_ptr(), n,
                len(tables), _ints(sizes), features_per_level, _ints(resolutions), None, 0,
                backend.current_stream_handle(positions.device),
            )
        if err != 0:
            raise RuntimeError(f"cell_lookup_bwd (positions only) launch failed: CUDA error {err}")
        backend.count_launch("cell_lookup_bwd_positions")
        return [None] * len(sources), g_pos
    g_sources = [torch.zeros_like(s) for s in sources]  # cells no lookup touches keep their zero
    g_pos = torch.empty_like(positions) if need_positions else None  # written in full
    scratch = _scratch(n, sizes, features_per_level, positions.device)
    with torch.cuda.device(positions.device):
        err = _entry("cell_lookup_bwd_f32")(
            positions.data_ptr(), _pointers(tables), g_out.data_ptr(), _pointers(_views(g_sources, level_map)),
            None if g_pos is None else g_pos.data_ptr(), n, len(tables), _ints(sizes), features_per_level,
            _ints(resolutions), scratch.data_ptr(), scratch.numel(),
            backend.current_stream_handle(positions.device),
        )
    if err != 0:
        raise RuntimeError(f"cell_lookup_bwd launch failed: CUDA error {err}")
    backend.count_launch("cell_lookup_bwd")
    return g_sources, g_pos


def _level_spec(cells, resolutions, table_size):
    resolutions = tuple(int(r) for r in np.asarray(resolutions))
    _, sizes = _per_level_tables([None] * len(resolutions), table_size, len(resolutions))
    sources, level_map = _sources(cells, len(resolutions))
    return resolutions, tuple(sizes), sources, level_map


def cell_lookup_fwd(cells, positions, resolutions, table_size, features_per_level):
    """K4 on a stacked tensor or a per-level list of tables."""
    resolutions, sizes, sources, level_map = _level_spec(cells, resolutions, table_size)
    return _fwd(sources, level_map, positions, resolutions, sizes, features_per_level)


def cell_lookup_bwd(cells, positions, resolutions, table_size, features_per_level,
                    g_out, need_positions=True, need_cells=True):
    """K5: dense g_cells (zero-filled, in the cells' form; None without
    ``need_cells``, the positions-only mode) and, when asked, g_positions
    (n, 3), from g_out (n, L * F) contiguous float32."""
    resolutions, sizes, sources, level_map = _level_spec(cells, resolutions, table_size)
    g_sources, g_pos = _bwd(sources, level_map, positions, resolutions, sizes, features_per_level,
                            g_out, need_positions, need_cells)
    if not need_cells:
        return None, g_pos
    return g_sources[0] if isinstance(cells, torch.Tensor) else g_sources, g_pos


def cell_lookup_sort(positions, resolutions, table_size):
    """K5's keys and its hand-written stable sort of them, on the card, for
    checks (not counted as a K5 launch): (keys in lookup order, sorted keys,
    the sorting permutation), (n * L,) int32 each. The keys equal
    ``cell_keys_reference``'s; the permutation is the stable one."""
    resolutions = tuple(int(r) for r in np.asarray(resolutions))
    n, levels = positions.shape[0], len(resolutions)
    _, sizes = _per_level_tables([None] * levels, table_size, levels)
    outs = [torch.empty(n * levels, dtype=torch.int32, device=positions.device) for _ in range(3)]
    scratch = _scratch(n, sizes, 1, positions.device)
    with torch.cuda.device(positions.device):
        err = _entry("cell_lookup_sort_u32")(
            positions.data_ptr(), n, levels, _ints(sizes), _ints(resolutions), *(o.data_ptr() for o in outs),
            scratch.data_ptr(), scratch.numel(), backend.current_stream_handle(positions.device),
        )
    if err != 0:
        raise RuntimeError(f"cell_lookup_sort launch failed: CUDA error {err}")
    return tuple(outs)


class CellLookup(torch.autograd.Function):
    """K4 forward and K5 backward on the card, the plain version and autograd
    through it elsewhere; the backward follows the forward's choice, and
    where no table needs a gradient K5 runs its positions-only mode. The
    tables come as ``sources`` (each a stacked (k, n_rows, 128) tensor or one
    level's (n_rows, 128)) and ``level_map``, so that a stacked parameter's
    gradient is written in one piece, not through a view a level."""

    @staticmethod
    def forward(ctx, positions, spec, *sources):
        resolutions, sizes, feats, level_map = spec
        ctx.kernel = backend.use_kernel(positions)
        ctx.spec = spec
        ctx.save_for_backward(positions, *sources)
        if ctx.kernel:
            return _fwd(sources, level_map, positions, resolutions, sizes, feats)
        return cell_lookup_reference(_views(sources, level_map), positions, resolutions, list(sizes), feats)

    @staticmethod
    def backward(ctx, g_out):
        positions, *sources = ctx.saved_tensors
        resolutions, sizes, feats, level_map = ctx.spec
        need_positions = ctx.needs_input_grad[0]
        if ctx.kernel:
            g_sources, g_pos = _bwd(sources, level_map, positions, resolutions, sizes, feats,
                                    g_out.contiguous(), need_positions, any(ctx.needs_input_grad[2:]))
        else:
            with torch.enable_grad():
                leaves = [s.detach().requires_grad_(True) for s in sources]
                p = positions.detach().requires_grad_(need_positions)
                out = cell_lookup_reference(_views(leaves, level_map), p, resolutions, list(sizes), feats)
                grads = torch.autograd.grad(out, leaves + ([p] if need_positions else []), g_out,
                                            allow_unused=True)
            g_sources = [torch.zeros_like(s) if g is None else g for s, g in zip(leaves, grads)]
            g_pos = grads[-1] if need_positions else None
        return (g_pos, None, *g_sources)


def _lookup(sources, level_map, positions, resolutions, sizes, features_per_level) -> torch.Tensor:
    """``cell_lookup`` on tables given as ``CellLookup``'s sources."""
    resolutions = tuple(int(r) for r in np.asarray(resolutions))
    sizes = tuple(int(s) for s in sizes)
    _check(_views(sources, level_map), positions, resolutions, sizes, features_per_level)
    return CellLookup.apply(positions, (resolutions, sizes, features_per_level, tuple(level_map)), *sources)


def cell_lookup(
    cells,
    positions: torch.Tensor,
    resolutions,
    table_size,
    features_per_level: int = 2,
) -> torch.Tensor:
    """Cell-major lookup: cells (L, n_rows, 128) float32 contiguous, or a
    per-level list of (n_rows_l, 128) tables with ``table_size`` a matching
    list of cell counts (the hybrid layout); positions (n, 3) float32
    contiguous, in [0, 1] -> (n, L * F) features, level-major. Raises on
    other dtypes and layouts rather than copy."""
    resolutions, sizes, sources, level_map = _level_spec(cells, resolutions, table_size)
    return _lookup(sources, level_map, positions, resolutions, sizes, features_per_level)


# ---------------------------------------------------------------------------
# The corner layout: tcnn's eight corner reads a lookup (K7 / K8).
# ---------------------------------------------------------------------------


def _mul_u32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 of uint32 values held in int64, without an int64
    overflow: the high and low 16 bits of ``a`` multiplied apart."""
    hi = (((a >> 16) * (b & 0xFFFF)) & 0xFFFF) << 16
    return (hi + (a & 0xFFFF) * b) & _U32


def corner_is_dense(res: int, table_size: int) -> bool:
    """The corner layout's dense criterion, in the JAX package's float32:
    (float32(res) + 1)^3 <= table_size."""
    f = np.float32(res) + np.float32(1.0)
    return bool(f * f * f <= np.float32(table_size))


def corner_dense_mask(resolutions, table_size: int) -> int:
    """Bit l set where level l indexes densely (K7/K8's ``dense_mask``)."""
    return sum(1 << lvl for lvl, r in enumerate(np.asarray(resolutions)) if corner_is_dense(int(r), table_size))


def hash_corner_slots(positions: torch.Tensor, res: int, table_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Table slots and trilinear weights of one level's 8 corners for (n, 3)
    positions, as the JAX package's ``_hash_corner_indices``: no clamp;
    corner k = 4 kx + 2 ky + kz at floor(pos * res) + (kx, ky, kz), in
    wrapping uint32 (each product and sum masked to 32 bits in int64), then
    % table_size; dense x + res (y + res z) where ``corner_is_dense``, the
    spatial hash otherwise. Returns (slots (n, 8) int64, weights (n, 8)),
    w_k = (wx[kx] wy[ky]) wz[kz] with wx = (1 - fx, fx)."""
    scaled = positions * res
    base = torch.floor(scaled)
    frac = scaled - base
    b = base.to(torch.int64) & _U32
    k = torch.arange(8, device=positions.device)
    off = torch.stack([(k >> 2) & 1, (k >> 1) & 1, k & 1], dim=-1)  # (8, 3)
    c = (b[:, None, :] + off) & _U32  # (n, 8, 3)
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    if corner_is_dense(res, table_size):
        h = (x + _mul_u32((y + _mul_u32(z, res)) & _U32, res)) & _U32
    else:
        h = x ^ _mul_u32(y, _PRIMES[1]) ^ _mul_u32(z, _PRIMES[2])
    wx = torch.stack([1.0 - frac[:, 0], frac[:, 0]], -1)
    wy = torch.stack([1.0 - frac[:, 1], frac[:, 1]], -1)
    wz = torch.stack([1.0 - frac[:, 2], frac[:, 2]], -1)
    w = (wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]).reshape(-1, 8)
    return h % table_size, w


def hash_encoding_lookup_reference(table: torch.Tensor, positions: torch.Tensor, resolutions,
                                   features_per_level: int = 2) -> torch.Tensor:
    """Plain version of K7: table (L, T, F), positions (n, 3) -> (n, L * F)
    features, level-major; each corner's entry read on its own
    (``hash_corner_slots``), weighted, and summed in ``corner_sum``'s tree.
    Differentiable by autograd (the plain version of K8)."""
    levels, size, feats = table.shape
    if feats != features_per_level:
        raise ValueError(f"the table holds F = {feats}, F = {features_per_level} asked")
    outs = []
    for lvl, res in enumerate(np.asarray(resolutions)):
        slots, w = hash_corner_slots(positions, int(res), size)
        vals = table[lvl].index_select(0, slots.reshape(-1)).reshape(-1, 8, feats)
        outs.append(corner_sum(vals * w[..., None]))
    return torch.cat(outs, dim=-1)


def hash_encoding_vjp_reference(table, positions, resolutions, features_per_level, g_out, need_table=True,
                                need_positions=True):
    """Plain backward: autograd through ``hash_encoding_lookup_reference``,
    only the gradients asked for. Returns (g_table or None, g_positions or
    None)."""
    with torch.enable_grad():
        t = table.detach().requires_grad_(need_table)
        p = positions.detach().requires_grad_(need_positions)
        out = hash_encoding_lookup_reference(t, p, resolutions, features_per_level)
        grads = iter(torch.autograd.grad(out, [x for x in (t, p) if x.requires_grad], g_out))
    return next(grads) if need_table else None, next(grads) if need_positions else None


def _check_corner(table, positions, resolutions, features_per_level) -> None:
    """Raises on what K7/K8 do not take, on every device."""
    if positions.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError(f"positions and table must be float32, got {positions.dtype} and {table.dtype}")
    if not positions.is_contiguous() or not table.is_contiguous():
        raise ValueError("positions and table must be contiguous")
    if positions.dim() != 2 or positions.shape[1] != 3:
        raise ValueError(f"positions must be (n, 3), got {tuple(positions.shape)}")
    if table.device != positions.device:
        raise ValueError(f"positions are on {positions.device}, the table on {table.device}")
    if table.dim() != 3 or table.shape[2] != features_per_level or features_per_level not in (1, 2, 4, 8):
        raise ValueError(f"the table must be (L, T, F) with F = {features_per_level} in (1, 2, 4, 8), "
                         f"got {tuple(table.shape)}")
    levels, size, _ = table.shape
    if len(resolutions) != levels or not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"{len(resolutions)} resolutions for {levels} levels (at most {MAX_LEVELS})")
    if levels * size > 2**31:
        raise ValueError(f"{levels} levels of {size} entries need more than 31 key bits")
    if 8 * positions.shape[0] * levels >= 2**31:
        raise ValueError(f"{positions.shape[0]} positions x {levels} levels x 8 corners is too many for K8")
    if table.data_ptr() % 16:
        raise ValueError(f"the table must be 16-byte aligned, got address {table.data_ptr():#x}")


_ARGTYPES["hash_lookup_fwd_f32"] = [_P, _P, _P, _I, _I, _I, _I, _P, ctypes.c_uint, _P]
_ARGTYPES["hash_lookup_bwd_f32"] = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, ctypes.c_uint, _P, _L, _P]
_ARGTYPES["hash_lookup_bwd_scratch_bytes"] = [_I, _I, _I]


def hash_lookup_fwd(table, positions, resolutions, features_per_level):
    """K7: one launch for every level."""
    levels, size, feats = table.shape
    out = torch.empty((positions.shape[0], levels * feats), dtype=torch.float32, device=positions.device)
    with torch.cuda.device(positions.device):
        err = _entry("hash_lookup_fwd_f32")(
            positions.data_ptr(), table.data_ptr(), out.data_ptr(), positions.shape[0], levels, size, feats,
            _ints(resolutions), corner_dense_mask(resolutions, size),
            backend.current_stream_handle(positions.device),
        )
    if err != 0:
        raise RuntimeError(f"hash_lookup_fwd launch failed: CUDA error {err}")
    backend.count_launch("hash_lookup_fwd")
    return out


def hash_lookup_bwd(table, positions, resolutions, features_per_level, g_out, need_table=True,
                    need_positions=True):
    """K8: (g_table (L, T, F) zero-filled where no lookup touched it, or None;
    g_positions (n, 3) or None) from g_out (n, L * F) contiguous float32.
    Without ``need_table`` only the position gradient runs: no zero-fill, no
    sort, the same bits."""
    levels, size, feats = table.shape
    n = positions.shape[0]
    want = (n, levels * feats)
    if g_out.dtype != torch.float32 or tuple(g_out.shape) != want or not g_out.is_contiguous():
        raise ValueError(f"g_out must be contiguous float32 {want}, got {g_out.dtype} "
                         f"{tuple(g_out.shape)} strides {g_out.stride()}")
    if not (need_table or need_positions):
        return None, None
    g_table = torch.zeros_like(table) if need_table else None
    g_pos = torch.empty_like(positions) if need_positions else None
    scratch = None
    if need_table:
        nbytes = _entry("hash_lookup_bwd_scratch_bytes")(n, levels, feats)
        if nbytes < 0:
            raise ValueError(f"K8 takes no {n} x {levels} lookups")
        scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=positions.device)
    with torch.cuda.device(positions.device):
        err = _entry("hash_lookup_bwd_f32")(
            positions.data_ptr(), table.data_ptr(), g_out.data_ptr(),
            None if g_table is None else g_table.data_ptr(), None if g_pos is None else g_pos.data_ptr(),
            n, levels, size, feats, _ints(resolutions), corner_dense_mask(resolutions, size),
            None if scratch is None else scratch.data_ptr(), 0 if scratch is None else scratch.numel(),
            backend.current_stream_handle(positions.device),
        )
    if err != 0:
        raise RuntimeError(f"hash_lookup_bwd launch failed: CUDA error {err}")
    backend.count_launch("hash_lookup_bwd" if need_table else "hash_lookup_bwd_positions")
    return g_table, g_pos


class HashLookup(torch.autograd.Function):
    """K7 forward and K8 backward on the card, the plain version and autograd
    through it elsewhere; the backward follows the forward's choice, and
    computes only the gradients autograd asks for."""

    @staticmethod
    def forward(ctx, positions, table, resolutions, feats):
        ctx.kernel = backend.use_kernel(positions)
        ctx.spec = (resolutions, feats)
        ctx.save_for_backward(positions, table)
        if ctx.kernel:
            return hash_lookup_fwd(table, positions, resolutions, feats)
        return hash_encoding_lookup_reference(table, positions, resolutions, feats)

    @staticmethod
    def backward(ctx, g_out):
        positions, table = ctx.saved_tensors
        resolutions, feats = ctx.spec
        need_pos, need_table = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        backward = hash_lookup_bwd if ctx.kernel else hash_encoding_vjp_reference
        g_table, g_pos = backward(table, positions, resolutions, feats, g_out.contiguous(), need_table, need_pos)
        return g_pos, g_table, None, None


def hash_encoding_lookup(table: torch.Tensor, positions: torch.Tensor, resolutions,
                         features_per_level: int = 2) -> torch.Tensor:
    """Corner-layout lookup, tcnn's semantics: table (L, T, F) float32
    contiguous (the JAX package's (L, F, T) transposed, so that a corner's F
    features are one read), positions (n, 3) float32 contiguous -> (n, L *
    F) features, level-major. K7 / K8 on the card, the plain version on the
    CPU. Raises on other dtypes and layouts rather than copy."""
    resolutions = tuple(int(r) for r in np.asarray(resolutions))
    _check_corner(table, positions, resolutions, features_per_level)
    return HashLookup.apply(positions, table, resolutions, features_per_level)


# ---------------------------------------------------------------------------
# The ensemble's layout: M members' cells packed into one row a cell.
# ---------------------------------------------------------------------------

MAX_MEMBERS = 8  # csrc/hash_grid.cu's K6
PACKED_FEATURES = (1, 2, 4)  # K6's F
# K6's row types and their codes in csrc/hash_grid.cu (K6Type)
PACKED_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def pack_member_cell_tables(
    stacked_rows: torch.Tensor, table_size: int, features_per_level: int = 2, dtype=None
) -> torch.Tensor:
    """M stacked member tables (M, L, n_rows, 128), the training layout ->
    (L, table_size, 8, M, F) contiguous: one row of 8 corners x M members x
    F features a cell, so that one cell index serves the whole ensemble.
    Corner c owns the contiguous [c M F, (c + 1) M F) of the row, as in the
    JAX package, which pads each row to a multiple of 128 lanes for the TPU;
    this layout has no pad (``interop.packed_tables_from_jax``). ``dtype``
    (bf16) converts the packed float32 rows, to nearest with ties to even as
    the JAX package's ``astype``."""
    m, levels, n_rows, _ = stacked_rows.shape
    cells = stacked_rows.reshape(m, levels, n_rows * 128 // (8 * features_per_level), 8,
                                 features_per_level)[:, :, :table_size]
    packed = cells.permute(1, 2, 3, 0, 4).contiguous()
    return packed if dtype is None else packed.to(dtype)


def quantize_cell_tables_int8(packed):
    """Per-level symmetric int8 quantization of packed eval rows, as the JAX
    package's: scale = max(max |t|, 1e-12) / 127 in float32, q = clip(round(t
    / scale), -127, 127) with ties to even. ``packed``: a stacked (L, T, 8,
    M, F) tensor or a per-level list. Returns ``{"tables": int8 rows in the
    same form, "scales": (L,) float32}``, the dict form the lookups take;
    the scale rides on the trilerp weights at lookup."""

    def one(t):
        t = t.to(torch.float32)
        s = torch.clamp(t.abs().max(), min=1e-12) / 127.0
        return torch.clamp(torch.round(t / s), -127, 127).to(torch.int8), s

    if isinstance(packed, (list, tuple)):
        qs = [one(t) for t in packed]
        return {"tables": [q for q, _ in qs], "scales": torch.stack([s for _, s in qs])}
    qs = [one(packed[lvl]) for lvl in range(packed.shape[0])]
    return {"tables": torch.stack([q for q, _ in qs]), "scales": torch.stack([s for _, s in qs])}


def _unpack_quantized(packed):
    """(tables, scales-or-None) from raw tables or the dict form."""
    if isinstance(packed, dict):
        return packed["tables"], packed["scales"]
    return packed, None


def fold_packed_tables(packed, fold: int, levels: int | None = None):
    """``fold`` cells a row: each level (T, 8, M, F) viewed as (T / fold,
    fold, 8, M, F), the JAX package's exact relayout (its rows fold ``fold``
    cells into one wider row for XLA's gather on a TPU). Here it is a view
    of the same memory: the lookups read a folded level through its
    unfolded view, so a fold changes no byte that K6 reads and no value.
    Levels whose cell count ``fold`` does not divide keep fold 1. Takes a
    stacked tensor, a per-level list or the dict form; returns the dict form
    (``scales`` None for unquantized tables)."""
    tables, scales = _unpack_quantized(packed)
    levels = len(tables) if levels is None else levels
    tables, _ = _per_level_tables(tables, 0, levels)
    out = []
    for t in tables:
        rows = t.shape[0]
        f = fold if fold > 1 and t.dim() == 4 and rows % fold == 0 else 1
        out.append(t.view(rows // f, f, *t.shape[1:]) if f > 1 else t)
    return {"tables": out, "scales": scales}


def split_packed_tables(packed, levels: int | None = None, real_lanes: int | None = None,
                        max_bytes: float = 32.0e6, max_parts: int = 2):
    """Each level's rows cut lane-wise into at most ``max_parts`` parts of at
    most ``max_bytes``, the JAX package's exact relayout (sub-gathers each
    under XLA's operand-size cliff on a TPU), with its rules: a level that
    fits whole, or would need more than ``max_parts`` parts, stays whole;
    parts are 8-lane multiples. A split level is a tuple of (T, w_i) column
    views of the same rows; the lookups read it through the whole rows'
    view, so a split changes no byte that K6 reads and no value. The port's
    rows have no pad lanes, so ``real_lanes`` is at most the row. Folded
    levels stay whole. Returns the dict form."""
    tables, scales = _unpack_quantized(packed)
    levels = len(tables) if levels is None else levels
    tables, _ = _per_level_tables(tables, 0, levels)
    out = []
    for t in tables:
        if isinstance(t, tuple) or t.dim() != 4:
            out.append(t)
            continue
        rows = t.shape[0]
        lanes = t[0].numel()
        w = min(real_lanes, lanes) if real_lanes else lanes
        parts = max(1, -(-int(rows * w * t.element_size()) // int(max_bytes)))
        if parts == 1 or parts > max_parts:
            out.append(t)
            continue
        pw = -(-w // parts)
        pw = ((pw + 7) // 8) * 8
        bounds = list(range(0, w, pw))
        bounds = bounds + [w] if bounds[-1] != w else bounds
        flat = t.view(rows, lanes)
        out.append(tuple(flat[:, a:b] for a, b in zip(bounds[:-1], bounds[1:])))
    return {"tables": out, "scales": scales}


def _whole_rows(parts: tuple, row_shape) -> torch.Tensor:
    """The (T, 8, M, F) rows a split level's column parts were cut from, as
    a view of their memory; raises if the parts do not tile one row-major
    buffer (8 M F elements a row, ``row_shape``)."""
    first = parts[0]
    rows, width = first.shape[0], int(np.prod(row_shape))
    at = first.storage_offset()
    for part in parts:
        if (part.dim() != 2 or part.shape[0] != rows or part.stride() != (width, 1) or part.dtype != first.dtype
                or part.untyped_storage().data_ptr() != first.untyped_storage().data_ptr()
                or part.storage_offset() != at):
            raise ValueError("a split level's parts must be column views of one level's rows")
        at += part.shape[1]
    if at - first.storage_offset() != width:
        raise ValueError(f"a split level's parts cover {at - first.storage_offset()} of {width} columns")
    strides = (width,) + tuple(int(np.prod(row_shape[i + 1:])) for i in range(len(row_shape)))
    return first.as_strided((rows, *row_shape), strides, first.storage_offset())


def _packed_levels(packed, table_size, levels: int, num_members: int, features_per_level: int):
    """(per-level (T_l, 8, M, F) rows, sizes, scales or None) of any form the
    lookups take: folded levels viewed unfolded, split levels as their
    whole rows."""
    tables, scales = _unpack_quantized(packed)
    tables, sizes = _per_level_tables(tables, table_size, levels)
    row_shape = (8, num_members, features_per_level)
    out = []
    for t in tables:
        if isinstance(t, tuple):
            t = _whole_rows(t, row_shape)
        elif t.dim() == 5:  # folded: (T / f, f, 8, M, F)
            t = t.reshape(-1, *t.shape[2:])
        out.append(t)
    return out, sizes, scales


def _weigh(rows: torch.Tensor, w: torch.Tensor, scale) -> torch.Tensor:
    """(n, 8, M, F) gathered rows and (n, 8) weights -> (n, M, F) float32,
    in K6's arithmetic for the rows' type: float32, corner_sum of the
    rounded products; bf16, weights and products rounded to bf16, summed in
    float32, the sum rounded to bf16; int8, w * scale rounded once, times the
    value, summed as float32."""
    if rows.dtype == torch.bfloat16:
        wb = w.to(torch.bfloat16).to(torch.float32)
        prod = (rows.to(torch.float32) * wb[:, :, None, None]).to(torch.bfloat16).to(torch.float32)
        return corner_sum(prod).to(torch.bfloat16).to(torch.float32)
    if rows.dtype == torch.int8:
        return corner_sum(rows.to(torch.float32) * (w * scale)[:, :, None, None])
    return corner_sum(rows * w[:, :, None, None])


def packed_cell_lookup_reference(
    packed, positions: torch.Tensor, resolutions, table_size, scales=None
) -> torch.Tensor:
    """Plain version of K6: packed (L, T, 8, M, F) or a per-level list of
    (T_l, 8, M, F) rows (float32, bf16, or int8 with ``scales``, (L,)),
    positions (n, 3) in [0, 1] -> (M, n, L * F) float32. Gathers each
    lookup's row with index_select and weighs it in K6's arithmetic for the
    rows' type (``_weigh``), so that member m's float32 slice equals
    ``cell_lookup_reference`` on member m's own table bit for bit."""
    resolutions = np.asarray(resolutions)
    tables, sizes = _per_level_tables(packed, table_size, len(resolutions))
    m, feats = tables[0].shape[2:]
    outs = []
    for lvl, res in enumerate(resolutions):
        idx, w = cell_indices(positions, int(res), sizes[lvl])
        rows = tables[lvl].index_select(0, idx)  # (n, 8, M, F): ONE gather
        outs.append(_weigh(rows, w, None if scales is None else scales[lvl]))  # (n, M, F)
    out = torch.stack(outs, dim=2)  # (n, M, L, F)
    return out.permute(1, 0, 2, 3).reshape(m, positions.shape[0], len(resolutions) * feats)


def _check_packed(tables, positions, resolutions, sizes, scales, num_members, features_per_level) -> None:
    """Raises on what K6 does not take, on every device: ``tables`` one
    (T_l, 8, M, F) tensor a level."""
    if positions.dtype != torch.float32:
        raise TypeError(f"positions must be float32, got {positions.dtype}")
    if not positions.is_contiguous():
        raise ValueError(f"positions must be contiguous, got strides {positions.stride()}")
    if positions.dim() != 2 or positions.shape[1] != 3:
        raise ValueError(f"positions must be (n, 3), got {tuple(positions.shape)}")
    levels = len(tables)
    if len(resolutions) != levels or not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"{len(resolutions)} resolutions for {levels} levels (at most {MAX_LEVELS})")
    dtype = tables[0].dtype
    if dtype not in PACKED_DTYPES:
        raise TypeError(f"packed rows must be one of {list(PACKED_DTYPES)}, got {dtype}")
    if (dtype == torch.int8) != (scales is not None):
        raise ValueError("int8 rows take their per-level scales, and only they do")
    if scales is not None and (scales.dtype != torch.float32 or tuple(scales.shape) != (levels,)
                               or scales.device != positions.device or not scales.is_contiguous()):
        raise ValueError(f"scales must be contiguous float32 ({levels},) on {positions.device}")
    for lvl, (t, size) in enumerate(zip(tables, sizes)):
        if t.dtype != dtype:
            raise TypeError(f"level {lvl}'s rows are {t.dtype}, level 0's {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"packed must be contiguous, got strides {t.stride()}")
        if t.device != positions.device:
            raise ValueError(f"positions are on {positions.device}, packed on {t.device}")
        if t.dim() != 4 or t.shape[1] != 8:
            raise ValueError(f"level {lvl}'s packed rows must be (T, 8, M, F), got {tuple(t.shape)}")
        _, _, m, feats = t.shape
        if not 1 <= m <= MAX_MEMBERS or m != num_members:
            raise ValueError(f"packed holds {m} members, {num_members} asked; K6 takes 1 to {MAX_MEMBERS}")
        if feats not in PACKED_FEATURES or feats != features_per_level:
            raise ValueError(f"packed holds F = {feats}, F = {features_per_level} asked; "
                             f"K6 takes F in {PACKED_FEATURES}")
        if t.shape[0] != size:
            raise ValueError(f"packed holds {t.shape[0]} cells at level {lvl}, table_size is {size}")
        if t.data_ptr() % 16:  # K6 copies whole rows from 16-byte aligned tables
            raise ValueError(f"packed must be 16-byte aligned, got address {t.data_ptr():#x}")
    if positions.shape[0] * levels >= 2**31:
        raise ValueError(f"{positions.shape[0]} positions x {levels} levels are too many lookups for K6")


_ARGTYPES["packed_cell_lookup_fwd"] = [_P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _P, _P]
_ARGTYPES["packed_cell_lookup_strided_fwd"] = [_P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P]
_ARGTYPES["packed_cell_lookup_shared_bytes"] = [_I, _I, _I, _I]


def packed_cell_lookup_fwd(packed, positions, resolutions, table_size, scales=None):
    """K6: one launch for every level and member. ``packed`` stacked or a
    per-level list of (T_l, 8, M, F) rows, as ``_check_packed`` takes
    them."""
    resolutions = tuple(int(r) for r in np.asarray(resolutions))
    tables, sizes = _per_level_tables(packed, table_size, len(resolutions))
    _, _, m, feats = tables[0].shape
    n = positions.shape[0]
    out = torch.empty((m, n, len(tables) * feats), dtype=torch.float32, device=positions.device)
    with torch.cuda.device(positions.device):
        err = _entry("packed_cell_lookup_fwd")(
            positions.data_ptr(), _pointers(tables), None if scales is None else scales.data_ptr(),
            out.data_ptr(), n, len(tables), _ints(sizes), m, feats, PACKED_DTYPES[tables[0].dtype],
            _ints(resolutions), backend.current_stream_handle(positions.device),
        )
    if err != 0:
        raise RuntimeError(f"packed_cell_lookup_fwd launch failed: CUDA error {err}")
    backend.count_launch("packed_cell_lookup_fwd")
    return out


def packed_cell_lookup(
    packed,
    positions: torch.Tensor,
    resolutions,
    table_size,
    num_members: int,
    features_per_level: int = 2,
) -> torch.Tensor:
    """Ensemble lookup, one row read serving all M members: packed (L, T,
    8, M, F) from ``pack_member_cell_tables``, a per-level list of (T_l, 8,
    M, F) rows with ``table_size`` a matching list (the hybrid layout), or
    the ``{"tables", "scales"}`` dict form (int8 rows, folded or split
    levels); float32, bf16 or int8 rows. positions (n, 3) float32
    contiguous in [0, 1] -> (M, n, L * F) float32. K6 on the card, its plain
    version on the CPU; forward only (the JAX package never differentiates
    it). Raises on other dtypes and layouts rather than copy."""
    resolutions = tuple(int(r) for r in np.asarray(resolutions))
    tables, sizes, scales = _packed_levels(packed, table_size, len(resolutions), num_members,
                                           features_per_level)
    _check_packed(tables, positions, resolutions, sizes, scales, num_members, features_per_level)
    if backend.use_kernel(positions):
        return packed_cell_lookup_fwd(tables, positions, resolutions, sizes, scales)
    return packed_cell_lookup_reference(tables, positions, resolutions, sizes, scales)


def anchor_stride(num_samples: int, res: int, stride_scale: float = 1.0, max_stride: int = 8) -> int:
    """K_l of ``packed_cell_lookup_strided``: clamp(stride_scale S // (2 R_l),
    1, max_stride), with ``int(stride_scale * S)`` as the JAX package
    takes it."""
    return int(np.clip(int(stride_scale * num_samples) // (2 * int(res)), 1, max_stride))


def packed_cell_lookup_strided_reference(
    packed,
    norm_positions: torch.Tensor,
    t_mid: torch.Tensor,
    resolutions,
    table_size,
    strides,
    scales=None,
) -> torch.Tensor:
    """Plain version of K6's strided entry, the JAX package's per-level
    anchor striding: level l is looked up (``packed_cell_lookup_reference``)
    only at every K_l-th sample (``strides``) and its features are lerped
    along the ray in ``t_mid`` between the bracketing anchors (static
    anchors 0, K, ..., the last clamped to S - 1); a level with K_l = 1 is
    looked up at every sample. ``packed`` stacked or per-level, as
    ``packed_cell_lookup_reference`` takes it; norm_positions (R, S, 3),
    t_mid (R, S) -> (M, R, S, L * F)."""
    tables, sizes = _per_level_tables(packed, table_size, len(resolutions))
    m, feats = tables[0].shape[2:]
    r, s, _ = norm_positions.shape
    # each level written into its slice of the output (in place of a
    # concatenation of F-wide pieces, which the card copies slowly)
    out = torch.empty((m, r, s, len(resolutions) * feats), dtype=torch.float32,
                      device=norm_positions.device)
    for lvl, (res, k) in enumerate(zip(resolutions, strides)):
        level = [tables[lvl]], [int(res)], [sizes[lvl]], None if scales is None else scales[lvl:lvl + 1]
        dst = out[..., lvl * feats:(lvl + 1) * feats]
        if k == 1:
            f = packed_cell_lookup_reference(level[0], norm_positions.reshape(-1, 3), *level[1:])
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
        f_a = packed_cell_lookup_reference(level[0], pos_a.reshape(-1, 3), *level[1:])
        f_a = f_a.reshape(m, r, na, feats)
        left = torch.repeat_interleave(f_a[:, :, :-1], k, dim=2)[:, :, :s]
        right = torch.repeat_interleave(f_a[:, :, 1:], k, dim=2)[:, :, :s]
        t_left = torch.repeat_interleave(t_a[:, :-1], k, dim=1)[:, :s]
        t_right = torch.repeat_interleave(t_a[:, 1:], k, dim=1)[:, :s]
        w = (t_mid - t_left) / torch.clamp(t_right - t_left, min=1e-12)
        w = torch.clamp(w, 0.0, 1.0)[None, :, :, None]
        torch.add(left * (1.0 - w), right * w, out=dst)
    return out


def packed_cell_lookup_strided_fwd(packed, norm_positions, t_mid, resolutions, table_size, strides,
                                   scales=None):
    """K6's strided entry: one launch for every level and member, the
    anchors looked up and lerped in it. Inputs as ``packed_cell_lookup_strided``
    takes them, ``packed`` stacked or per-level."""
    resolutions = tuple(int(r) for r in np.asarray(resolutions))
    tables, sizes = _per_level_tables(packed, table_size, len(resolutions))
    _, _, m, feats = tables[0].shape
    r, s, _ = norm_positions.shape
    out = torch.empty((m, r, s, len(tables) * feats), dtype=torch.float32, device=norm_positions.device)
    with torch.cuda.device(norm_positions.device):
        err = _entry("packed_cell_lookup_strided_fwd")(
            norm_positions.data_ptr(), t_mid.data_ptr(), _pointers(tables),
            None if scales is None else scales.data_ptr(), out.data_ptr(), r, s, len(tables), _ints(sizes), m,
            feats, PACKED_DTYPES[tables[0].dtype], _ints(resolutions), _ints(strides),
            backend.current_stream_handle(norm_positions.device),
        )
    if err != 0:
        raise RuntimeError(f"packed_cell_lookup_strided_fwd launch failed: CUDA error {err}")
    backend.count_launch("packed_cell_lookup_strided")
    return out


def packed_cell_lookup_strided(
    packed,
    norm_positions: torch.Tensor,
    t_mid: torch.Tensor,
    resolutions,
    table_size,
    num_members: int,
    features_per_level: int = 2,
    max_stride: int = 8,
    stride_scale: float = 1.0,
) -> torch.Tensor:
    """Ensemble lookup with per-level anchor striding along the ray, as the
    JAX package's: level l is looked up only at every K_l-th sample
    (``anchor_stride``) and lerped along the ray in ``t_mid`` between the
    bracketing anchors. ``packed`` in any form ``packed_cell_lookup`` takes;
    norm_positions (R, S, 3), t_mid (R, S) float32 contiguous -> (M, R, S,
    L * F). K6's strided entry on the card (one launch), its plain version
    ``packed_cell_lookup_strided_reference`` on the CPU. Raises on other
    dtypes and layouts rather than copy."""
    resolutions = tuple(int(r) for r in np.asarray(resolutions))
    for name, t in (("norm_positions", norm_positions), ("t_mid", t_mid)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides {t.stride()}")
    if norm_positions.dim() != 3 or norm_positions.shape[2] != 3:
        raise ValueError(f"norm_positions must be (R, S, 3), got {tuple(norm_positions.shape)}")
    if tuple(t_mid.shape) != tuple(norm_positions.shape[:2]) or t_mid.device != norm_positions.device:
        raise ValueError(f"t_mid must be {tuple(norm_positions.shape[:2])} on {norm_positions.device}, "
                         f"got {tuple(t_mid.shape)} on {t_mid.device}")
    tables, sizes, scales = _packed_levels(packed, table_size, len(resolutions), num_members,
                                           features_per_level)
    _check_packed(tables, norm_positions.view(-1, 3), resolutions, sizes, scales, num_members,
                  features_per_level)
    s = norm_positions.shape[1]
    strides = tuple(anchor_stride(s, r, stride_scale, max_stride) for r in resolutions)
    if backend.use_kernel(norm_positions):
        return packed_cell_lookup_strided_fwd(tables, norm_positions, t_mid, resolutions, sizes, strides, scales)
    return packed_cell_lookup_strided_reference(tables, norm_positions, t_mid, resolutions, sizes, strides,
                                                scales)


# ---------------------------------------------------------------------------
# Encoders and the face-consistency penalty.
# ---------------------------------------------------------------------------


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


def face_vertices(resolutions, num_vertices: int, generator: torch.Generator) -> list[torch.Tensor]:
    """The penalty's random interior vertices, (num_vertices, 3) int64 in [1,
    res) for each of ``resolutions``, drawn from ``generator`` on its device
    (a captured training step replays them)."""
    return [torch.randint(1, max(int(res), 2), (num_vertices, 3), generator=generator, device=generator.device)
            for res in resolutions]


def face_lanes(vertices: torch.Tensor, res: int, table_size: int, features_per_level: int) -> torch.Tensor:
    """(8, K, F) int64: where, in a level's flattened cells, each of the 8
    cells adjoining vertex v keeps the F features of its corner at v (cell o
    has v as its corner o)."""
    feats = features_per_level
    corners = torch.arange(8, device=vertices.device)
    off = torch.stack([(corners >> 2) & 1, (corners >> 1) & 1, corners & 1], dim=-1)  # (8, 3)
    idx = _cell_index(vertices[None] - off[:, None], res, table_size)  # (8, K)
    lane0 = idx * (8 * feats) + corners[:, None] * feats  # cell idx's corner o: row-major (cell, 8, F)
    return lane0[..., None] + torch.arange(feats, device=vertices.device)


def face_consistency_loss(
    rows: torch.Tensor,
    res: int,
    table_size: int,
    vertices,
    num_vertices: int = 1024,
    features_per_level: int = 2,
) -> torch.Tensor:
    """Stochastic cross-face corner-consistency penalty of one cell-layout
    level, as the JAX package's: the population variance, over the 8 cells
    adjoining each sampled interior vertex, of the feature each assigns to
    it, averaged. rows (n_rows, 128) the level's cells; ``vertices`` (K, 3)
    integer in [1, res), or a ``torch.Generator`` that draws
    ``num_vertices`` of them (``face_vertices``). The features are read by
    one index into the flattened cells (F floats a vertex and cell), whose
    backward is index_put's sorted accumulation: it adds in a fixed order on
    the card, unlike a row gather's scatter-add."""
    if res < 2:
        return rows.new_zeros(())
    if isinstance(vertices, torch.Generator):
        vertices = face_vertices([res], num_vertices, vertices)[0]
    vals = rows.reshape(-1)[face_lanes(vertices.to(rows.device), res, table_size, features_per_level)]
    return torch.mean(torch.var(vals, dim=0, correction=0))  # jnp.var: the population variance


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

    @property
    def level_sizes(self) -> list[int]:
        """Cells of each level's table."""
        return [self.table_size] * len(self.resolutions)

    def cell_levels(self) -> list[int]:
        """The levels stored as cells in ``cells`` (every level), in order:
        the levels the face-consistency penalty reads."""
        return list(range(len(self.resolutions)))

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        flat = positions.reshape(-1, 3)
        out = cell_lookup(
            self.cells, flat, self.resolutions, self.table_size,
            self.features_per_level,
        )
        return out.reshape(*positions.shape[:-1], self.output_dim)


class HashEncoding(nn.Module):
    """Corner-major multi-resolution hash grid, tcnn's semantics (the JAX
    package's ``HashEncoding``): each lookup reads its 8 corners on their
    own, and adjacent cells share their corner entries.

    Owns ``table`` of shape (num_levels, table_size, features_per_level),
    the JAX package's (L, F, T) transposed (``interop.py`` converts both
    ways), initialised uniform in [-init_scale, init_scale).
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
        self.features_per_level = features_per_level
        self.table_size = 2**log2_hashmap_size
        self.resolutions = hash_grid_resolutions(num_levels, min_res, max_res)
        table = torch.empty((num_levels, self.table_size, features_per_level), device=device)
        self.table = nn.Parameter(table.uniform_(-init_scale, init_scale, generator=generator))

    @property
    def output_dim(self) -> int:
        return len(self.resolutions) * self.features_per_level

    @property
    def level_sizes(self) -> list[int]:
        """Entries of each level's table."""
        return [self.table_size] * len(self.resolutions)

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        flat = positions.reshape(-1, 3)
        out = hash_encoding_lookup(self.table, flat, self.resolutions, self.features_per_level)
        return out.reshape(*positions.shape[:-1], self.output_dim)


class HybridHashEncoding(nn.Module):
    """Dense-corner / hashed-cell hybrid grid, as the JAX package's.

    Levels with (res + 1)^3 <= 8 table_size (``hybrid_is_dense``) own a
    canonical corner grid ``corners_{lvl}`` of shape (res + 1, res + 1,
    (res + 1) F), exact corner sharing and no collisions, expanded each call
    to res^3 cell rows (``dense_corner_to_cell_rows``); the finer levels keep
    hashed cells, stacked in ``cells`` (n_hashed, n_rows, 128). Every level
    is then one row gather a lookup (``cell_lookup`` on per-level tables).
    Both initialised uniform in [-init_scale, init_scale), ``cells`` first.
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
        feats = self.features_per_level = features_per_level
        self.table_size = 2**log2_hashmap_size
        self.resolutions = hash_grid_resolutions(num_levels, min_res, max_res)
        self.is_dense = [hybrid_is_dense(int(r), self.table_size) for r in self.resolutions]
        cpr = 128 // (8 * feats)
        n_hashed = sum(not d for d in self.is_dense)
        if n_hashed:
            n_rows = (self.table_size + cpr - 1) // cpr
            cells = torch.empty((n_hashed, n_rows, 128), device=device)
            self.cells = nn.Parameter(cells.uniform_(-init_scale, init_scale, generator=generator))
        for lvl, res in enumerate(int(r) for r in self.resolutions):
            if self.is_dense[lvl]:
                grid = torch.empty((res + 1, res + 1, (res + 1) * feats), device=device)
                self.register_parameter(
                    f"corners_{lvl}", nn.Parameter(grid.uniform_(-init_scale, init_scale, generator=generator)))

    @property
    def output_dim(self) -> int:
        return len(self.resolutions) * self.features_per_level

    def level_plan(self) -> tuple[np.ndarray, list[bool]]:
        """(resolutions, is_dense per level)."""
        return self.resolutions, list(self.is_dense)

    @property
    def level_sizes(self) -> list[int]:
        """Cells of each level's table: res^3 dense, table_size hashed."""
        return [int(r) ** 3 if d else self.table_size for r, d in zip(self.resolutions, self.is_dense)]

    def cell_levels(self) -> list[int]:
        """The levels stored as cells in ``cells`` (the hashed ones), in
        order: the levels the face-consistency penalty reads."""
        return [lvl for lvl, d in enumerate(self.is_dense) if not d]

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        feats = self.features_per_level
        sources, level_map = [], []
        if any(not d for d in self.is_dense):
            sources.append(self.cells)
        hi = 0
        for lvl, res in enumerate(int(r) for r in self.resolutions):
            if self.is_dense[lvl]:
                level_map.append((len(sources), None))
                sources.append(dense_corner_to_cell_rows(getattr(self, f"corners_{lvl}"), res, feats))
            else:
                level_map.append((0, hi))
                hi += 1
        flat = positions.reshape(-1, 3)
        out = _lookup(tuple(sources), level_map, flat, self.resolutions, self.level_sizes, feats)
        return out.reshape(*positions.shape[:-1], self.output_dim)

