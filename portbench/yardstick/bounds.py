"""Least times of the hash-grid kernels on given inputs: the larger of the
bytes they must move at the HBM rate and their float32 operations at the
float32 rate. Frozen copies of the arithmetic the port's kernel checks use.

Bytes count each input once and each output once: a lookup's positions, each
distinct cell (K6: each distinct packed row) that its lookups read, the
features written; K5 adds into the cells it touched and writes the
positions' gradient.
"""

from __future__ import annotations

import torch

from portbench.reference.nerfacto import cell_indices
from portbench.yardstick.peaks import F32_FLOPS, HBM_BYTES_PER_S

# float32 operations a lookup: locating the cell and its 8 weights (25), then
# 8 F multiply-adds (K4); K5's 8 F scatter products and, with the positions'
# gradient, its dots and weight derivatives
K4_OPS = lambda f: 25 + 16 * f  # noqa: E731
K5_OPS = lambda f, pos: 25 + 8 * f + ((16 * f + 75) if pos else 0)  # noqa: E731
# K6 a (sample, level): 8 corners x F features x M members; a strided
# level's lerp: its weight, then two products and an add a member and feature
K6_OPS = lambda f, m: 25 + 16 * f * m  # noqa: E731
K6_LERP_OPS = lambda f, m: 6 + 3 * f * m  # noqa: E731


def _ms(nbytes: float, ops: float) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)


def distinct_cells(positions: torch.Tensor, resolutions, table_size: int) -> int:
    """Distinct (level, cell) pairs that lookups at (n, 3) positions read."""
    return sum(int(torch.unique(cell_indices(positions, int(r), table_size)[0]).numel()) for r in resolutions)


def grid_bound_ms(n: int, levels: int, features: int, unique_cells: int, backward: bool,
                  positions_grad: bool = True) -> float:
    """One K4 (forward) or K5 (backward) call over n positions."""
    lookups = n * levels
    cell_bytes = unique_cells * 8 * features * 4
    nbytes = 12 * n + cell_bytes + 4 * features * lookups
    ops = lookups * K4_OPS(features)
    if backward:
        nbytes += cell_bytes + (12 * n if positions_grad else 0)
        ops = lookups * K5_OPS(features, positions_grad)
    return _ms(nbytes, ops)


def k6_bound_ms(n: int, levels: int, members: int, features: int, lookups: int, unique_rows: int,
                elem_bytes: int, strided_levels: int = 0) -> float:
    """One K6 call over n samples making ``lookups`` lookups (a strided
    level's at its anchors only): positions (and the strided entry's t_mid)
    read once, each distinct packed row (8 M F elements) once, the (M, n, L
    F) float32 output written once; the lookups' and lerps' operations."""
    strided = strided_levels > 0
    nbytes = (12 + 4 * strided) * n + unique_rows * 8 * members * features * elem_bytes \
        + 4 * members * n * levels * features
    ops = lookups * K6_OPS(features, members) + n * strided_levels * K6_LERP_OPS(features, members)
    return _ms(nbytes, ops)
