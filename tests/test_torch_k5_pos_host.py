"""K5's positions-only mode, its CUDA source run on the CPU, bit for bit.

Where no table needs a gradient (the pose gradient's backward through K4),
``uncertainty_nerf_gs_torch/csrc/hash_grid.cu::cell_lookup_bwd_f32`` runs
``cell_lookup_bwd_pos_kernel`` alone: a warp on 32 samples walking the
levels, cells read shared or own by the runs of equal cells the warp sees,
each level's term in the arithmetic of K5's keys kernel (the full
backward's first stage) and the levels summed in the tree of that kernel's
xor butterfly. The source is compiled with g++ against
``tests/host_cuda/cuda_shim.h`` (every launch run block by block, a block's
threads as fibers, each warp's shuffles and ballots a meeting of its 32
lanes, IEEE single precision with nothing fused and ``fmaf`` rounded once)
with ``tests/host_cuda/k7_main.inc``'s ``k5`` mode, which runs the keys
kernel with keys and the positions-only mode through the entry point. The
two g_pos must be equal bit for bit, and equal to
``cell_lookup_positions_vjp_reference`` (the plain version in the kernels'
arithmetic), with the source as it is, with each read forced for every
level (``kK5PosOwnMaxRuns`` rewritten to 0: shared reads only; to 32: own
reads only) and with the next level's reads issued first on every table
(``kK5PosPrefetchBytes`` rewritten to 0), at 5 and 16 levels and at F = 1,
2, 4 and 8 (F = 8 reads its own cells in every build), on uniform positions
and on runs of samples along short rays (neighbours share the coarse
levels' cells). The plain version
is held against autograd through ``cell_lookup_reference`` within
GRID_GRAD_TOL. What this cannot show: that nvcc builds the source, that the
card rounds the same (``chip_smoke.py::k5_positions_only_times``), and its
speed. Skips where there is no g++.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import GRID_GRAD_TOL, grad_mismatch, host_launches
from uncertainty_nerf_gs_torch.ops import encodings as enc

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "uncertainty_nerf_gs_torch" / "csrc" / "hash_grid.cu"
SHIM = REPO / "tests" / "host_cuda"
# build -> constants rewritten: the reads forced for every level (shared
# only, own only), and the next level's reads issued first on every table
# (the host cases' tables are far below kK5PosPrefetchBytes)
BUILDS = {"as_built": {}, "shared_only": {"kK5PosOwnMaxRuns": "0"}, "own_only": {"kK5PosOwnMaxRuns": "32"},
          "prefetch": {"kK5PosPrefetchBytes": "0"}}


@pytest.fixture(scope="module")
def k5_host(tmp_path_factory) -> dict:
    """build -> hash_grid.cu's host build with k7_main.inc, its constants
    rewritten as BUILDS says; built in parallel."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build K5's source for the host")
    text = SOURCE.read_text()
    assert "#include <cuda_runtime.h>" in text
    text = host_launches(text.replace("#include <cuda_runtime.h>", '#include "cuda_shim.h"'))
    out = tmp_path_factory.mktemp("k5_pos_host")
    procs = {}
    for name, constants in BUILDS.items():
        src = text
        for constant, value in constants.items():
            src, count = re.subn(rf"(constexpr \w+(?: \w+)? {constant} = )[^;]+;", rf"\g<1>{value};", src)
            assert count == 1, constant
        (out / f"{name}.cpp").write_text(src + '\n#include "k7_main.inc"\n')
        procs[name] = subprocess.Popen([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-w",
                                        f"-I{SHIM}", str(out / f"{name}.cpp"), "-o", str(out / name)])
    for name, proc in procs.items():
        assert proc.wait(timeout=300) == 0, f"g++ failed on the {name} build"
    return {name: out / name for name in BUILDS}


def _positions(rng, n, res, along_rays):
    """Uniform in [0, 1]^3, or in runs of 32 samples along short rays; the
    first rows on the cube's corners, a little outside it and on cell faces
    k / res of every level."""
    if along_rays:
        start = rng.uniform(0, 1, (n // 32 + 1, 1, 3))
        step = rng.normal(size=(n // 32 + 1, 1, 3)) * 2e-3
        pos = np.clip(start + step * np.arange(32)[None, :, None], 0, 1).reshape(-1, 3)[:n]
    else:
        pos = rng.uniform(0, 1, (n, 3))
    rows = [[0, 0, 0], [1, 1, 1], [1, 0, 1], [-1e-7, 0.5, 1 + 1e-7]]
    for r in res:
        rows += (rng.integers(0, int(r) + 1, (1, 3)) / np.float32(r)).tolist()
    pos = pos.astype(np.float32)
    pos[:len(rows)] = np.float32(rows)
    return np.ascontiguousarray(pos)


# name, levels, F, along rays; n = 150 samples: four whole warps and a ragged one
CASES = [
    ("5_levels", 5, 2, False),
    ("5_levels_rays", 5, 2, True),
    ("16_levels", 16, 2, False),
    ("16_levels_rays", 16, 2, True),
    ("f1_rays", 4, 1, True),
    ("f4", 3, 4, False),
    ("f8_rays", 6, 8, True),
]


@pytest.mark.parametrize("build", list(BUILDS))
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_k5_positions_only_source_matches_keys_kernel_and_plain(k5_host, tmp_path, rng, case, build):
    _, levels, feats, along_rays = case
    n, size = 150, 2**13  # the first level dense (16^3 cells), the last hashed
    res = enc.hash_grid_resolutions(levels, 16, 512)
    cells = rng.uniform(-2, 2, (levels, size * 8 * feats // 128, 128)).astype(np.float32)
    pos = _positions(rng, n, res, along_rays)
    g_out = rng.normal(size=(n, levels * feats)).astype(np.float32)
    pos.tofile(tmp_path / "positions.bin")
    np.asarray(res, np.int32).tofile(tmp_path / "resolutions.bin")
    cells.tofile(tmp_path / "cells.bin")
    g_out.tofile(tmp_path / "g_out.bin")
    subprocess.run([str(k5_host[build]), str(tmp_path), "k5", str(n), str(levels), str(size), str(feats)],
                   check=True, timeout=300)
    full = np.fromfile(tmp_path / "g_pos_full.bin", np.float32).reshape(n, 3)
    only = np.fromfile(tmp_path / "g_pos.bin", np.float32).reshape(n, 3)
    plain = enc.cell_lookup_positions_vjp_reference(torch.from_numpy(cells), torch.from_numpy(pos), res, size,
                                                    feats, torch.from_numpy(g_out)).numpy()
    assert np.array_equal(only.view(np.int32), full.view(np.int32)), \
        f"{int((only != full).sum())} of {only.size} entries differ from the keys kernel's"
    assert np.array_equal(only.view(np.int32), plain.view(np.int32)), \
        f"{int((only != plain).sum())} of {only.size} entries differ from the plain version's"
    p = torch.from_numpy(pos).requires_grad_(True)
    want = torch.autograd.grad(enc.cell_lookup_reference(torch.from_numpy(cells), p, res, size, feats), [p],
                               torch.from_numpy(g_out))[0]
    assert not grad_mismatch(torch.from_numpy(plain), want, GRID_GRAD_TOL).any()
