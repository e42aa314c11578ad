"""Parity of the port's deep ensemble against the JAX package, on the CPU:
the member-packed layout and lookup (K6's plain version, and K6's CUDA
source run on the host), the strided lookup, ``combine_ensemble_outputs``,
the fused and per-member ensemble renders of a tiny active-nerfacto, the
JAX package's ensemble oracles, and the eval chunk functions.

Inputs are numpy-seeded; member weights are ``interop.draw_params`` with
three seeds. Tolerances and the rule for rays whose samples crossed a
hash-grid cell face between the packages are tests/torch_parity.py's.
"""

import contextlib
import re
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    MAX_FLIPPED_RAY_SHARE,
    MOMENT_TOL,
    OUTPUT_TOLS,
    TOL,
    draw_params,
    lookup_cells_jax,
    ray_mismatch,
)

from uncertainty_nerf_gs_tpu.models import ensemble as jens
from uncertainty_nerf_gs_tpu.models.nerfacto import NerfactoConfig as JConfig, NerfactoModel as JModel
from uncertainty_nerf_gs_tpu.ops import encodings as jenc
from uncertainty_nerf_gs_tpu.ops.sampling import RayBundle as JBundle
from uncertainty_nerf_gs_tpu.parallel import ensemble_fused as jef

from uncertainty_nerf_gs_torch import interop
from uncertainty_nerf_gs_torch.models import ensemble as tens
from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig as TConfig, NerfactoModel as TModel
from uncertainty_nerf_gs_torch.ops import encodings as tenc
from uncertainty_nerf_gs_torch.ops.sampling import RayBundle as TBundle
from uncertainty_nerf_gs_torch.parallel import ensemble_fused as tef
from uncertainty_nerf_gs_torch.scripts import eval_uncertainty as tscript

REPO = Path(__file__).resolve().parents[1]
NUM_MEMBERS = 3


def _stacked_rows(rng, m, levels, table, feats):
    n_rows = -(-table * 8 * feats // 128)
    return rng.uniform(-2, 2, (m, levels, n_rows, 128)).astype(np.float32)


# ------------------------------------------------------------ packed layout


@pytest.mark.parametrize("m", [3, 5])
def test_pack_matches_jax(rng, m):
    """The port's packed tables are JAX's with the pad lanes dropped,
    exactly; ``packed_tables_from_jax``/``_to_jax`` convert both ways
    exactly."""
    feats, table = 2, 512
    rows = _stacked_rows(rng, m, 3, table, feats)
    want = np.asarray(jenc.pack_member_cell_tables(jnp.asarray(rows), table, feats))
    got = tenc.pack_member_cell_tables(torch.from_numpy(rows), table, feats)
    assert got.shape == (3, table, 8, m, feats) and got.is_contiguous()
    assert np.array_equal(got.numpy().reshape(3, table, -1), want[:, :, :8 * m * feats])
    assert np.array_equal(interop.packed_tables_from_jax(want, m, feats).numpy(), got.numpy())
    assert np.array_equal(interop.packed_tables_to_jax(got), want)


LOOKUP_CASES = [
    # name, members, features, levels, min_res, max_res, table, n
    ("oracle_case", 3, 2, 3, 4, 32, 512, 50),  # tests/test_ensemble_fused.py:123
    ("five_members", 5, 2, 5, 16, 128, 2**12, 333),
    ("f4", 2, 4, 3, 4, 32, 512, 77),
    ("f1_one_member", 1, 1, 4, 4, 64, 2**10, 41),
    ("table_not_pow2", 4, 2, 3, 8, 64, 1000, 65),
]


@pytest.mark.parametrize("case", LOOKUP_CASES, ids=[c[0] for c in LOOKUP_CASES])
def test_packed_lookup_matches_jax_and_members(rng, case):
    """The plain packed lookup against JAX's at TOL (its lane matmuls sum in
    another order), and bit for bit against M ``cell_lookup_reference``
    calls on the members' own tables; dense and hashed levels, ragged n."""
    _, m, feats, levels, min_res, max_res, table, n = case
    res = jenc.hash_grid_resolutions(levels, min_res, max_res)
    assert any(int(r) ** 3 <= table for r in res) and any(int(r) ** 3 > table for r in res)
    rows = _stacked_rows(rng, m, levels, table, feats)
    pts = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    pts[:3] = [[0, 0, 0], [1, 1, 1], [-1e-7, 0.5, 1 + 1e-7]]
    jpacked = jenc.pack_member_cell_tables(jnp.asarray(rows), table, feats)
    want = np.asarray(jenc.packed_cell_lookup(jpacked, jnp.asarray(pts), res, table, m, feats))
    packed = tenc.pack_member_cell_tables(torch.from_numpy(rows), table, feats)
    got = tenc.packed_cell_lookup(packed, torch.from_numpy(pts), res, table, m, feats)
    assert got.shape == (m, n, levels * feats)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for j in range(m):
        single = tenc.cell_lookup_reference(torch.from_numpy(rows[j]), torch.from_numpy(pts), res, table, feats)
        assert torch.equal(got[j], single), f"member {j}"


def _rays_in_cube(rng, r, s, t0=0.05, t1=0.95):
    t = np.repeat(np.linspace(t0, t1, s, dtype=np.float32)[None], r, 0)
    origins = rng.uniform(0.1, 0.3, (r, 3)).astype(np.float32)
    dirs = rng.uniform(0.3, 0.7, (r, 3)).astype(np.float32)
    pos = origins[:, None] + dirs[:, None] * t[..., None] * np.float32(0.7)
    return pos.astype(np.float32), t


@pytest.mark.parametrize("case", [
    ("scale_1", 64, [4, 8, 64], 1.0),
    ("scale_4", 48, [4, 8, 32], 4.0),
    ("anchor_divisible_65", 65, [4], 1.0),  # tests/test_ensemble_fused.py:614
    ("anchor_divisible_121", 121, [20], 1.0),
], ids=lambda c: c[0])
def test_strided_lookup_matches_jax(rng, case):
    """``packed_cell_lookup_strided`` against JAX's at TOL: strides that
    engage (K > 1) and levels looked up at every sample, stride_scale 1 and
    4, and S - 1 divisible by K."""
    _, s, res, scale = case
    m, feats, table = 2, 2, 512
    rows = _stacked_rows(rng, m, len(res), table, feats)
    pos, t = _rays_in_cube(rng, 6, s)
    want = np.asarray(jenc.packed_cell_lookup_strided(
        jenc.pack_member_cell_tables(jnp.asarray(rows), table, feats), jnp.asarray(pos),
        jnp.asarray(t), res, table, m, feats, stride_scale=scale))
    got = tenc.packed_cell_lookup_strided(
        tenc.pack_member_cell_tables(torch.from_numpy(rows), table, feats), torch.from_numpy(pos),
        torch.from_numpy(t), res, table, m, feats, stride_scale=scale)
    assert got.shape == want.shape == (m, 6, s, len(res) * feats)
    assert any(tenc.anchor_stride(s, r, scale) > 1 for r in res)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ----------------------------------------------------------------- K6 source


HASH_GRID_CU = REPO / "uncertainty_nerf_gs_torch" / "csrc" / "hash_grid.cu"
SHIM = REPO / "tests" / "host_cuda"
COPY_THRESHOLD = "constexpr int kK6CopyRunsMax = 32;"
# K6's row copies: each run of equal cells once (the source as built), or
# every lookup's row (the threshold rewritten to 0)
COPIES = {"runs_once": None, "every_row": 0}


@pytest.fixture(scope="module")
def k6_host(tmp_path_factory):
    """copy mode -> K6's CUDA source built for the host with g++ against the
    shim of tests/host_cuda (each warp as 32 host threads)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build K6's source for the host")
    out = tmp_path_factory.mktemp("k6_host")
    text = HASH_GRID_CU.read_text()
    assert COPY_THRESHOLD in text
    text = re.sub(r"<<<[^>]*>>>", "", text.replace("#include <cuda_runtime.h>", '#include "cuda_shim.h"'))
    exes = {}
    for mode, runs in COPIES.items():
        src = text if runs is None else text.replace(COPY_THRESHOLD, f"constexpr int kK6CopyRunsMax = {runs};")
        (out / f"{mode}.cpp").write_text(src + '\n#include "k6_main.inc"\n')
        subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-w", f"-I{SHIM}",
                        str(out / f"{mode}.cpp"), "-o", str(out / mode)], check=True, timeout=300)
        exes[mode] = out / mode
    return exes


K6_CASES = [
    # name, members, features, levels, max_res, table, n
    ("proposal_m5", 5, 2, 5, 128, 2**12, 300),
    ("field_m5", 5, 2, 16, 2048, 2**14, 130),
    ("m3_f4", 3, 4, 4, 512, 2**12, 100),
    ("m1_f1", 1, 1, 4, 512, 2**12, 129),
    ("m8_ragged", 8, 2, 6, 256, 3000, 33),
]


K6_DTYPES = {np.float32: 0, "bf16": 1, np.int8: 2}  # csrc/hash_grid.cu's K6Type


def _run_k6_host(exe, tmp_path, packed, pos, res, t_mid=None, strides=None, scales=None, dtype=np.float32):
    """K6's host build on these inputs: (M, n, L * F). ``packed`` a stacked
    (L, T, 8, M, F) array or a per-level list (the hybrid layout's), of
    ``dtype`` (bf16 given as its uint16 bits), int8 with its ``scales``;
    the strided entry's arguments where ``t_mid`` (R, S) and ``strides`` are
    given."""
    tables = list(packed)
    _, _, m, feats = tables[0].shape
    levels, n = len(tables), pos.size // 3
    pos.tofile(tmp_path / "positions.bin")
    np.asarray(res, np.int32).tofile(tmp_path / "resolutions.bin")
    np.asarray([t.shape[0] for t in tables], np.int32).tofile(tmp_path / "sizes.bin")
    for lvl, t in enumerate(tables):
        np.ascontiguousarray(t).tofile(tmp_path / f"level_{lvl}.bin")
    if scales is not None:
        np.asarray(scales, np.float32).tofile(tmp_path / "scales.bin")
    args = [str(exe), str(tmp_path), str(n), str(levels), str(m), str(feats), str(K6_DTYPES[dtype])]
    if t_mid is not None:
        t_mid.tofile(tmp_path / "t_mid.bin")
        np.asarray(strides, np.int32).tofile(tmp_path / "strides.bin")
        args.append(str(t_mid.shape[1]))
    subprocess.run(args, check=True, timeout=120)
    return np.fromfile(tmp_path / "out.bin", np.float32).reshape(m, n, levels * feats)


@pytest.mark.parametrize("copies", list(COPIES))
@pytest.mark.parametrize("case", K6_CASES, ids=[c[0] for c in K6_CASES])
def test_k6_source_matches_plain_version(k6_host, tmp_path, rng, case, copies):
    """K6's CUDA source, run on the CPU, equals ``packed_cell_lookup_reference``
    bit for bit, as chip_smoke.py requires on the card, with each run's row
    copied once and with every lookup's row copied."""
    _, m, feats, levels, max_res, table, n = case
    res = tenc.hash_grid_resolutions(levels, 16, max_res)
    packed = rng.uniform(-2, 2, (levels, table, 8, m, feats)).astype(np.float32)
    pos = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    pos[:4] = [[0, 0, 0], [1, 1, 1], [1, 0, 1], [-1e-7, 0.5, 1 + 1e-7]]
    got = _run_k6_host(k6_host[copies], tmp_path, packed, pos, res)
    want = tenc.packed_cell_lookup_reference(torch.from_numpy(packed), torch.from_numpy(pos),
                                             tuple(int(r) for r in res), table).numpy()
    assert np.array_equal(got, want), f"{int((got != want).sum())} of {got.size} features differ"


STRIDED_CASES = [
    # name, members, features, resolutions, table, rays, samples, stride_scale, max_stride
    ("proposal_0_s256", 5, 2, (16, 26, 45, 76, 127), 2**12, 3, 256, 1.0, 8),  # strides 8/4/2/1/1
    ("proposal_1_s96", 5, 2, (16, 32, 64, 128, 256), 2**12, 4, 96, 1.0, 8),  # 3/1/1/1/1
    ("s65_k4", 2, 2, (8,), 512, 6, 65, 1.0, 8),  # S - 1 divisible by K
    ("s121_k20", 2, 2, (3,), 512, 5, 121, 1.0, 32),
    ("field_s48_scale4", 5, 2, (16, 22, 30, 42, 58, 80, 111, 2048), 2**12, 3, 48, 4.0, 8),  # warps span rays
    ("m1", 1, 2, (16, 26, 45, 76, 127), 2**12, 2, 256, 1.0, 8),
    ("m8_f4", 8, 4, (16, 45, 127), 2**11, 2, 96, 2.0, 8),
    ("m3_f1_rounds", 3, 1, (3, 5), 512, 40, 3, 4.0, 8),  # more than 32 anchors a warp: two rounds
]


def _rays(rng, r, s):
    """Sorted t_mid along rays through the unit cube, and their positions."""
    t = np.sort(rng.uniform(0.05, 0.95, (r, s)), axis=1).astype(np.float32)
    t[0, 1] = t[0, 0]  # a repeated sample: t_right - t_left may be 0 at an anchor pair
    origins = rng.uniform(0.1, 0.3, (r, 1, 3))
    dirs = rng.uniform(0.3, 0.7, (r, 1, 3))
    return np.ascontiguousarray((origins + dirs * t[..., None] * 0.7).astype(np.float32)), t


@pytest.mark.parametrize("copies", list(COPIES))
@pytest.mark.parametrize("case", STRIDED_CASES, ids=[c[0] for c in STRIDED_CASES])
def test_k6_strided_source_matches_plain_version(k6_host, tmp_path, rng, case, copies):
    """K6's strided entry, its CUDA source run on the CPU, equals
    ``packed_cell_lookup_strided_reference`` bit for bit: the proposals'
    strides at S = 256 and 96, S - 1 divisible by K, the field's S = 48
    with stride_scale > 0 (a warp spans two rays), M = 1 and 8, and warps
    whose anchors take two rounds."""
    _, m, feats, res, table, r, s, scale, max_stride = case
    strides = [tenc.anchor_stride(s, x, scale, max_stride) for x in res]
    assert any(k > 1 for k in strides)
    packed = rng.uniform(-2, 2, (len(res), table, 8, m, feats)).astype(np.float32)
    pos, t = _rays(rng, r, s)
    got = _run_k6_host(k6_host[copies], tmp_path, packed, pos, res, t, strides)
    want = tenc.packed_cell_lookup_strided_reference(
        torch.from_numpy(packed), torch.from_numpy(pos), torch.from_numpy(t), res, table, strides).numpy()
    want = want.reshape(m, r * s, -1)
    assert np.array_equal(got, want), f"{int((got != want).sum())} of {got.size} features differ"


def test_strided_lookup_plain_versions_on_the_cpu(rng):
    """On a CPU tensor ``packed_cell_lookup_strided`` runs its plain version
    inside ``plain_versions()`` and outside it alike, bit for bit: the
    function the CPU tests hold against JAX is the one the card's checks
    hold K6's strided entry against."""
    from uncertainty_nerf_gs_torch.ops import backend

    _, m, feats, res, table, r, s, scale, max_stride = STRIDED_CASES[0]
    packed = torch.from_numpy(rng.uniform(-2, 2, (len(res), table, 8, m, feats)).astype(np.float32))
    pos, t = (torch.from_numpy(a) for a in _rays(rng, r, s))
    outside = tenc.packed_cell_lookup_strided(packed, pos, t, res, table, m, feats)
    with backend.plain_versions():
        inside = tenc.packed_cell_lookup_strided(packed, pos, t, res, table, m, feats)
    strides = [tenc.anchor_stride(s, x) for x in res]
    assert torch.equal(outside, inside)
    assert torch.equal(outside, tenc.packed_cell_lookup_strided_reference(packed, pos, t, res, table, strides))


# ---------------------------------------------------------------- combining


def _member_outputs(rng, m, r, alea=True, splat=False):
    shape = (m, 6, 5) if splat else (m, r)
    out = {
        "rgb": rng.uniform(size=shape + (() if splat else (3,))).astype(np.float32),
        "depth": rng.uniform(0.5, 4, shape).astype(np.float32),
        "accumulation": rng.uniform(size=shape).astype(np.float32),
    }
    if not splat:
        out["expected_depth"] = rng.uniform(0.5, 4, shape).astype(np.float32)
    if alea:
        for k in ("rgb", "depth"):
            out[k + "_var"] = rng.uniform(0, 0.1, shape).astype(np.float32)
            out[k + "_std"] = np.sqrt(out[k + "_var"])
    return out


@pytest.mark.parametrize("case", [("alea_parity", True, True, False), ("alea_combined", True, False, False),
                                  ("no_alea", False, True, False), ("splat_hw", True, False, True)],
                         ids=lambda c: c[0])
def test_combine_ensemble_outputs_matches_jax(rng, case):
    """Members with aleatoric heads in both parity modes, members without
    (``*_std`` by std(ddof=1)), and (H, W)-shaped maps whose trailing axis
    is spatial, not a channel."""
    _, alea, parity, splat = case
    stacked = _member_outputs(rng, 4, 10, alea, splat)
    want = jens.combine_ensemble_outputs({k: jnp.asarray(v) for k, v in stacked.items()}, parity_mode=parity)
    got = tens.combine_ensemble_outputs({k: torch.from_numpy(v) for k, v in stacked.items()}, parity_mode=parity)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), err_msg=k, **TOL)


def test_ensemble_params_from_jax(rng):
    """A stacked flax tree -> the stacked state dict: member j's slices are
    ``params_from_jax`` of member j's tree, exactly."""
    trees = _member_trees(2)
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)
    got = interop.ensemble_params_from_jax(stacked)
    for j, tree in enumerate(trees):
        single = interop.params_from_jax(tree)
        assert set(single) == set(got)
        for k, v in single.items():
            assert torch.equal(got[k][j], v), k
    with pytest.raises(KeyError):
        interop.stack_params([single, {"x": torch.zeros(1)}])


# ------------------------------------------------------------------ renders


def tiny_config_kwargs(**over) -> dict:
    """tests/test_ensemble_fused.py's ``_tiny_config`` with the aleatoric
    head."""
    kw = dict(
        num_images=2, near_plane=0.5, far_plane=6.0, background_color="white",
        use_appearance_embedding=False, num_proposal_samples=(24, 12), num_nerf_samples=8,
        num_levels=4, max_res=64, log2_hashmap_size=10, uncertainty_channels=1,
        proposal_net_args=(
            dict(num_levels=2, max_res=32, log2_hashmap_size=9, hidden_dim=16),
            dict(num_levels=2, max_res=64, log2_hashmap_size=9, hidden_dim=16),
        ),
    )
    kw.update(over)
    return kw


def _member_trees(m, **over):
    """m flax param trees of the tiny model, ``draw_params`` with seeds 0..m-1
    (the tree's structure from the port's own state dict)."""
    like = interop.params_to_jax(TModel(TConfig(**tiny_config_kwargs(**over)), device="cpu").state_dict())
    return [draw_params(like, np.random.default_rng(seed)) for seed in range(m)]


def ensemble_pair(m=NUM_MEMBERS, **over):
    """(JAX model, port model, stacked flax tree, the port's stacked
    params) of an m-member tiny active-nerfacto."""
    kw = tiny_config_kwargs(**over)
    trees = _member_trees(m, **over)
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)
    return JModel(JConfig(**kw)), TModel(TConfig(**kw), device="cpu"), stacked, interop.ensemble_params_from_jax(stacked)


def bundles(rng, n=64):
    """tests/test_ensemble_fused.py's ray bundle, for both packages."""
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
    jb = JBundle(jnp.asarray(o), jnp.asarray(d), jnp.full((n,), 0.5), jnp.full((n,), 6.0),
                 jnp.zeros((n,), jnp.int32))
    tb = TBundle(torch.from_numpy(o), torch.from_numpy(d), torch.full((n,), 0.5), torch.full((n,), 6.0),
                 torch.zeros(n, dtype=torch.int64))
    return jb, tb


@contextlib.contextmanager
def recorded_edges(module):
    """The spacing edges of every ``sample_uniform``/``sample_pdf`` call a
    render in ``module`` makes, in call order: the fused chain's sdist list."""
    edges = []
    saved = module.sample_uniform, module.sample_pdf

    def record(fn):
        def call(*args, **kwargs):
            rs = fn(*args, **kwargs)
            edges.append(rs.spacing_edges)
            return rs
        return call

    module.sample_uniform, module.sample_pdf = record(saved[0]), record(saved[1])
    try:
        yield edges
    finally:
        module.sample_uniform, module.sample_pdf = saved


def fused_pair(jmodel, tmodel, stacked, tstacked, jb, tb, table_dtype=None, jit=True, **kw):
    """Both packages' fused renders of one chunk (JAX's jitted unless
    ``jit`` is False) on ``table_dtype`` tables ("bf16", "int8"; float32 by
    default) with their shared chains' edges: (want, got, JAX sdist, port
    sdist)."""
    jdtype = {None: None, "bf16": jnp.bfloat16, "int8": jnp.int8}[table_dtype]
    with recorded_edges(jef) as j_edges:
        render = jef.build_fused_ensemble_render(jmodel, **kw).__wrapped__
        jstacked = jax.tree_util.tree_map(jnp.asarray, stacked)
        packed = jef.pack_ensemble_tables(jmodel, jstacked, table_dtype=jdtype)

        def run(p, t, rb):
            j_edges.clear()
            return render(p, t, rb), list(j_edges)

        want, j_sdist = (jax.jit(run) if jit else run)(jstacked, packed, jb)
    with recorded_edges(tef) as t_edges:
        got = tef.build_fused_ensemble_render(tmodel, **kw)(
            tstacked, tef.pack_ensemble_tables(tmodel, tstacked, table_dtype=table_dtype), tb)
    return ({k: np.asarray(v) for k, v in want.items()}, {k: v.numpy() for k, v in got.items()},
            j_sdist, list(t_edges))


def per_member_pair(jmodel, tmodel, stacked, tstacked, jb, tb):
    """Both packages' per-member renders of one chunk and each member's
    sdist list: (want, got, [JAX sdist per member], [port sdist per member])."""
    def run(p, rb):
        # the members' sample edges from the same forward, vmapped, in the
        # same program
        edges = jax.vmap(lambda q: jmodel.apply({"params": q}, rb, train=True)["sdist_list"])(p)
        return jens.ensemble_render(jmodel, p, rb), edges

    want, edges = jax.jit(run)(jax.tree_util.tree_map(jnp.asarray, stacked), jb)
    got = tens.ensemble_render(tmodel, tstacked, tb)
    m = next(iter(tstacked.values())).shape[0]
    j_sdist = [[e[j] for e in edges] for j in range(m)]
    t_sdist = [tens.member_apply(tmodel, tens.member_params(tstacked, j),
                                 lambda mdl, rb: mdl(rb, return_intermediates=True)["sdist_list"], tb)
               for j in range(m)]
    return ({k: np.asarray(v) for k, v in want.items()}, {k: v.numpy() for k, v in got.items()},
            j_sdist, t_sdist)


def flipped_rays(jmodel, tmodel, jb, tb, j_sdists, t_sdists) -> np.ndarray:
    """(R,) bool: rays with a lookup in another cell in the two packages,
    over every sdist list given (one a member, or the shared chain's)."""
    out = None
    for js, ts in zip(j_sdists, t_sdists):
        f = (lookup_cells_jax(jmodel.config, jb, js) != tmodel.lookup_cells(tb, ts).numpy()).any(axis=1)
        out = f if out is None else out | f
    return out


def output_tols(keys) -> dict:
    """OUTPUT_TOLS for the member outputs, MOMENT_TOL for the combined
    variances and deviations."""
    tols = {}
    for k in keys:
        if k in OUTPUT_TOLS:
            tols[k] = OUTPUT_TOLS[k]
        elif k.startswith(("rgb_var", "rgb_std", "depth_var", "depth_std")):
            tols[k] = MOMENT_TOL
    return tols


def _compare(want, got, flipped):
    assert set(got) == set(want)
    n = flipped.shape[0]
    assert flipped.mean() <= MAX_FLIPPED_RAY_SHARE, f"{flipped.sum()} of {n} rays flipped"
    for k in want:
        assert got[k].shape == want[k].shape and np.isfinite(got[k]).all(), k
    tols = output_tols(want)
    assert set(tols) | {"density_mean"} >= set(want), set(want) - set(tols)
    bad = ray_mismatch(want, got, tols)
    assert not (bad & ~flipped).any(), (
        f"{(bad & ~flipped).sum()} unflipped rays differ ({flipped.sum()} of {n} excluded as flipped)")
    if "density_mean" in want:
        np.testing.assert_allclose(got["density_mean"], want["density_mean"], rtol=1e-3)


@pytest.mark.parametrize("anchor_stride,parity", [(True, True), (False, False)],
                         ids=["anchor_stride-parity", "exact-combined"])
def test_fused_render_matches_jax(rng, anchor_stride, parity):
    """``build_fused_ensemble_render`` against JAX's jitted one on three
    members: every output within its tolerance on the rays none of whose
    lookups (the shared chain's) crossed a cell face between the packages;
    both ``proposal_anchor_stride`` values and both ``parity_mode``s."""
    jmodel, tmodel, stacked, tstacked = ensemble_pair(
        num_proposal_samples=(64, 24),
        proposal_net_args=(dict(num_levels=2, max_res=8, log2_hashmap_size=9, hidden_dim=16),
                           dict(num_levels=2, max_res=16, log2_hashmap_size=9, hidden_dim=16)))
    # the stride engages at the proposals: S = 64 at res 8 gives K = 4
    assert tenc.anchor_stride(64, 8) == 4
    jb, tb = bundles(rng)
    want, got, j_sdist, t_sdist = fused_pair(jmodel, tmodel, stacked, tstacked, jb, tb,
                                             proposal_anchor_stride=anchor_stride, parity_mode=parity)
    assert want["accumulation"].mean() > 0.05  # not an empty field
    _compare(want, got, flipped_rays(jmodel, tmodel, jb, tb, [j_sdist], [t_sdist]))


def test_per_member_render_matches_jax(rng):
    """``ensemble_render`` (each member's own forward) against JAX's jitted
    one, with the rays that flipped a cell in any member excluded."""
    jmodel, tmodel, stacked, tstacked = ensemble_pair()
    jb, tb = bundles(rng)
    want, got, j_sdist, t_sdist = per_member_pair(jmodel, tmodel, stacked, tstacked, jb, tb)
    _compare(want, got, flipped_rays(jmodel, tmodel, jb, tb, j_sdist, t_sdist))


# The JAX package's own oracles (tests/test_ensemble_fused.py:306, 333,
# 350), held by the port alone.


def test_fused_identical_members_give_the_standard_render(rng):
    """Identical members: the shared chain is each member's own, so the
    fused render equals the single model's and the epistemic variance
    vanishes."""
    _, tmodel, _, tstacked = ensemble_pair(1)
    same = {k: v.repeat((3,) + (1,) * (v.dim() - 1)) for k, v in tstacked.items()}
    _, tb = bundles(rng)
    fused = tef.build_fused_ensemble_render(tmodel)(same, tef.pack_ensemble_tables(tmodel, same), tb)
    ref = tens.member_apply(tmodel, tens.member_params(tstacked, 0),
                            lambda mdl, rb: mdl(rb, use_average_appearance=True), tb)
    for k in ("rgb", "depth"):
        np.testing.assert_allclose(fused[k].numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
    assert float(fused["rgb_var_epi"].max()) < 1e-9


def test_fused_distinct_members_have_epistemic_variance(rng):
    _, tmodel, _, tstacked = ensemble_pair()
    _, tb = bundles(rng)
    out = tef.build_fused_ensemble_render(tmodel)(tstacked, tef.pack_ensemble_tables(tmodel, tstacked), tb)
    for k, v in out.items():
        assert torch.isfinite(v).all(), k
    assert float(out["rgb_var_epi"].mean()) > 0
    # parity mode: rgb_var stays the member-mean aleatoric variance
    assert float(out["rgb_var_combined"].mean()) >= float(out["rgb_var_epi"].mean())
    assert torch.equal(out["rgb_var"], out["rgb_var_alea"])


def test_fused_render_close_to_per_member(rng):
    """The shared proposal chain's deviation: the fused and the per-member
    renders of the same members agree closely on the mean rgb."""
    _, tmodel, _, tstacked = ensemble_pair()
    _, tb = bundles(rng)
    fused = tef.build_fused_ensemble_render(tmodel)(tstacked, tef.pack_ensemble_tables(tmodel, tstacked), tb)
    ref = tens.ensemble_render(tmodel, tstacked, tb)
    assert float((fused["rgb"] - ref["rgb"]).abs().mean()) < 0.05


@pytest.mark.parametrize("option", ["table_dtype", "table_fold", "table_split", "hybrid"])
def test_fused_refuses_what_is_not_ported(rng, option):
    """The table options and the hybrid layout, refused before they were
    ported, now render: bf16 tables within a few bf16 steps of float32
    (tests/test_torch_eval_tables.py holds them against the JAX package),
    folded (4 cells a row) and split tables bit for bit equal to the
    unfolded float32 render, and a hybrid ensemble's fused render finite
    with an epistemic variance."""
    _, tmodel, _, tstacked = ensemble_pair(grid_layout="hybrid") if option == "hybrid" else ensemble_pair()
    _, tb = bundles(rng)
    render = tef.build_fused_ensemble_render(tmodel)
    base = render(tstacked, tef.pack_ensemble_tables(tmodel, tstacked), tb)
    if option == "hybrid":
        assert any(k.startswith("field.encoding.corners_") for k in tstacked)
        assert all(torch.isfinite(v).all() for v in base.values())
        assert float(base["rgb_var_epi"].mean()) > 0
        return
    args = {"table_dtype": dict(table_dtype="bf16"), "table_fold": dict(table_fold=4),
            "table_split": dict(table_split=True)}[option]
    if option == "table_split":  # levels past max_bytes, in at most two parts
        packed = tef.pack_ensemble_tables(tmodel, tstacked)
        packed = {k: None if v is None else tenc.split_packed_tables(v, real_lanes=None, max_bytes=
                  0.6 * max(t[0].numel() * t.element_size() * t.shape[0] for t in v))
                  for k, v in packed.items()}
        assert any(isinstance(t, tuple) for v in packed.values() for t in v["tables"])
    else:
        packed = tef.pack_ensemble_tables(tmodel, tstacked, **args)
    got = render(tstacked, packed, tb)
    for k, v in base.items():
        if option == "table_dtype":
            assert torch.isfinite(got[k]).all(), k
        else:
            assert torch.equal(got[k], v), k
    if option == "table_dtype":
        assert float((got["rgb"] - base["rgb"]).abs().max()) < 0.05
        with pytest.raises(ValueError, match="table_dtype"):
            tef.pack_ensemble_tables(tmodel, tstacked, table_dtype="fp8")


@pytest.mark.parametrize("mode", ["fused", "per_member"])
def test_eval_chunk_and_image_functions(rng, mode):
    """``build_ensemble_chunk_fn`` renders what the render it wraps renders,
    bit for bit, and ``_nerfacto_full_image_renderer`` puts the chunks
    together (the last chunk padded with pixel (0, 0) and cut)."""
    from uncertainty_nerf_gs_torch.cameras.cameras import generate_rays, pixel_grid
    from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras

    _, tmodel, _, tstacked = ensemble_pair()
    chunk_fn = tscript.build_ensemble_chunk_fn(tmodel, tstacked, ensemble_mode=mode)  # bf16 tables
    cams = hemisphere_cameras(2, 6, 7, seed=1)
    cfg = TConfig(**tiny_config_kwargs(eval_num_rays_per_chunk=16))
    image = tscript._nerfacto_full_image_renderer(cfg, chunk_fn, cams, device="cpu")(1)
    px, py = pixel_grid(6, 7, torch.device("cpu"))
    px, py = torch.cat([px, torch.zeros(6)]), torch.cat([py, torch.zeros(6)])
    packed = tef.pack_ensemble_tables(tmodel, tstacked, table_dtype="bf16")  # the default, as in JAX
    chunks = []
    for s in range(0, 48, 16):
        rb = generate_rays(cams, torch.ones(16, dtype=torch.int64), px[s:s + 16], py[s:s + 16])
        if mode == "fused":
            chunks.append(tef.build_fused_ensemble_render(tmodel)(tstacked, packed, rb))
        else:
            chunks.append(tens.ensemble_render(tmodel, tstacked, rb))
    direct = {k: torch.cat([c[k] for c in chunks])[:42] for k in chunks[0] if k != "density_mean"}
    assert set(image) == set(direct)
    for k, v in image.items():
        assert v.shape == (6, 7) + direct[k].shape[1:], k
        assert torch.equal(v.reshape(direct[k].shape), direct[k]), k
    with pytest.raises(ValueError, match="table_dtype"):
        tscript.build_ensemble_chunk_fn(tmodel, tstacked, table_dtype="f16")
