"""K4's CUDA source run on the CPU, against its plain version bit for bit.

``uncertainty_nerf_gs_torch/csrc/hash_grid.cu`` is compiled with g++
against ``tests/host_cuda/cuda_shim.h``, which stands in for the CUDA
builtins K4 uses: each warp runs as 32 host threads that meet at a barrier
for every shuffle, ballot and ``__syncwarp``, so the kernel's lane layout,
its shuffles, its choice between shared and own reads and its staged output
run as written, and its float arithmetic is IEEE single precision with
nothing fused (``-ffp-contract=off``, as ``__fmul_rn``/``__fadd_rn`` are on
the card). The output must equal ``cell_lookup_reference`` bit for bit, as
``chip_smoke.py`` requires on the card, with the source as it is and with
each read forced for every level (``kK4OwnMaxRuns`` rewritten to 0: shared
reads only; to 32: own reads only). What this cannot show: that nvcc builds
the source, and anything about the card's memory system or speed
(``chip_smoke.py``). Skips where there is no g++.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from uncertainty_nerf_gs_torch.ops import encodings as enc

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "uncertainty_nerf_gs_torch" / "csrc" / "hash_grid.cu"
SHIM = REPO / "tests" / "host_cuda"
THRESHOLD = "constexpr int kK4OwnMaxRuns = 16;"
READS = {"as_built": None, "shared_only": 0, "own_only": 32}


def _host_source(own_max_runs) -> str:
    """hash_grid.cu for g++: the shim for the CUDA runtime header, launches
    written as plain calls, the harness appended; the read threshold
    rewritten where asked."""
    import re

    text = SOURCE.read_text()
    assert "#include <cuda_runtime.h>" in text and THRESHOLD in text
    text = text.replace("#include <cuda_runtime.h>", '#include "cuda_shim.h"')
    if own_max_runs is not None:
        text = text.replace(THRESHOLD, f"constexpr int kK4OwnMaxRuns = {own_max_runs};")
    return re.sub(r"<<<[^>]*>>>", "", text) + '\n#include "k4_main.inc"\n'


@pytest.fixture(scope="module")
def k4_host(tmp_path_factory) -> dict:
    """read mode -> the K4 host executable built for it."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build K4's source for the host")
    out = tmp_path_factory.mktemp("k4_host")
    exes = {}
    for name, runs in READS.items():
        cpp = out / f"{name}.cpp"
        cpp.write_text(_host_source(runs))
        exe = out / name
        subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-w",
                        f"-I{SHIM}", str(cpp), "-o", str(exe)], check=True, timeout=300)
        exes[name] = exe
    return exes


def _inputs(rng, levels, max_res, table, n, features, along_rays):
    """Cells uniform in +-2; positions uniform, or in runs of 64 samples
    along short rays (neighbours share the coarse levels' cells), with the
    first rows on the cube's corners, just outside it and on cell faces."""
    res = enc.hash_grid_resolutions(levels, 16, max_res)
    n_rows = -(-table * 8 * features // 128)
    cells = rng.uniform(-2, 2, (levels, n_rows, 128)).astype(np.float32)
    if along_rays:
        start = rng.uniform(0, 1, (n // 64 + 1, 1, 3))
        step = rng.normal(size=(n // 64 + 1, 1, 3)) * 2e-3
        pos = np.clip(start + step * np.arange(64)[None, :, None], 0, 1).reshape(-1, 3)[:n]
    else:
        pos = rng.uniform(0, 1, (n, 3))
    rows = [[0, 0, 0], [1, 1, 1], [1, 0, 1], [-1e-7, 0.5, 1 + 1e-7]]
    for r in res:
        rows += (rng.integers(0, int(r) + 1, (2, 3)) / np.float32(r)).tolist()
    pos = pos.astype(np.float32)
    pos[: min(len(rows), n)] = np.float32(rows)[:n]
    return cells, np.ascontiguousarray(pos), res


CASES = [
    # name, levels, max_res, table, n, features, along rays
    ("proposal_f2", 5, 128, 2**12, 300, 2, False),
    ("field_f2_rays", 16, 2048, 2**14, 200, 2, True),
    ("f1_rays", 4, 512, 2**12, 150, 1, True),
    ("f4", 4, 512, 2**12, 100, 4, False),
    ("f8_two_passes", 16, 512, 2**13, 70, 8, True),
    ("f16", 5, 256, 2**12, 40, 16, False),
    ("f2_32_levels", 32, 4096, 2**14, 40, 2, False),
    ("table_not_pow2", 6, 256, 3000, 100, 2, False),
    ("ragged_warp", 5, 128, 2**12, 33, 2, True),
]


@pytest.mark.parametrize("reads", list(READS))
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_k4_source_matches_plain_version(k4_host, tmp_path, rng, case, reads):
    _, levels, max_res, table, n, features, along_rays = case
    cells, pos, res = _inputs(rng, levels, max_res, table, n, features, along_rays)
    pos.tofile(tmp_path / "positions.bin")
    cells.tofile(tmp_path / "cells.bin")
    np.asarray(res, np.int32).tofile(tmp_path / "resolutions.bin")
    subprocess.run([str(k4_host[reads]), str(tmp_path), str(n), str(levels), str(cells.shape[1]),
                    str(table), str(features)], check=True, timeout=120)
    got = np.fromfile(tmp_path / "out.bin", np.float32).reshape(n, levels * features)
    want = enc.cell_lookup_reference(torch.from_numpy(cells), torch.from_numpy(pos),
                                     tuple(int(r) for r in res), table, features).numpy()
    assert np.array_equal(got, want), f"{int((got != want).sum())} of {got.size} features differ"
