"""Parity of the port's corner (tcnn) grid layout against the JAX package, on
the CPU: the corner slots (dense against hashed, the dense stride's alias,
the wrapping uint32 arithmetic), ``hash_encoding_lookup`` and
``HashEncoding`` (forward, and the table and position gradients against
``jax.vjp``), a corner ``NerfactoModel``'s eval forward, one corner training
batch against the jitted JAX trainer, the ``table`` leaf's interop both
ways, the optimizer's groups, the corner ensemble's per-member route, and
the CUDA source of K7 and K8 (and K5's positions-only mode) run on the host
against the plain versions.

Inputs are drawn with numpy from a seed; the tolerances are
tests/torch_parity.py's, named at each test.
"""

import re
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import train_loss_and_grads
from torch_parity import (
    CPU_TRAIN_GRAD_L2,
    GRID_GRAD_TOL,
    MAX_FLIPPED_RAY_SHARE,
    TOL,
    TRAIN_LOSS_RTOL,
    draw_params,
    grad_l2_error,
    grad_mismatch,
    lookup_cells_jax,
    ray_mismatch,
    rays,
    small_config_kwargs,
)

from uncertainty_nerf_gs_tpu.models.nerfacto import NerfactoConfig as JConfig, NerfactoModel as JModel
from uncertainty_nerf_gs_tpu.ops import encodings as jenc
from uncertainty_nerf_gs_tpu.ops.sampling import RayBundle as JBundle

from uncertainty_nerf_gs_torch import interop
from uncertainty_nerf_gs_torch.engine.optimizers import label_params
from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig as TConfig, NerfactoModel as TModel
from uncertainty_nerf_gs_torch.ops import encodings as tenc
from uncertainty_nerf_gs_torch.ops.sampling import RayBundle as TBundle

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _jitted_jax_init():
    """The JAX ``NerfactoModel.init`` under ``jax.jit`` for this module (the
    JAX trainer calls it too): the corner lookup's eager init takes half a
    minute on the CPU, the jitted one a few seconds, and the parameters are
    the same function of the key. Restored after the module."""
    eager = JModel.init

    def init(self, rngs, *args, **kwargs):
        return jax.jit(lambda r, *a: eager(self, r, *a, **kwargs))(rngs, *args)

    JModel.init = init
    yield
    JModel.init = eager


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _positions(rng, n, res):
    """Positions uniform in [0, 1]^3, the first rows at exactly 0 and 1, on
    cell faces k / res of every level and a little outside the cube (the
    corner layout does not clamp)."""
    pos = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    edge = [[0, 0, 0], [1, 1, 1], [1, 0, 1], [0.5, 1, 0], [-1e-7, 0.5, 1 + 1e-7], [-0.3, 1.2, 0.5]]
    for r in res:
        edge += (rng.integers(0, int(r) + 1, (2, 3)) / np.float32(r)).tolist()
    pos[:len(edge)] = np.float32(edge)[:n]
    return pos


# name -> (levels, min_res, max_res, log2 table size, F): each mixes dense
# and hashed levels; "boundary" has a level where (res + 1)^3 equals T
LOOKUP_CASES = {
    "mixed_f2": (5, 4, 64, 9, 2),
    "boundary": (3, 7, 20, 9, 2),
    "f1": (4, 16, 128, 13, 1),
    "f4": (4, 8, 96, 10, 4),
}


def test_corner_dense_criterion_matches_jax():
    """``corner_is_dense`` is the JAX package's float32 (res + 1)^3 <= T,
    equality included (res 7 at T = 512)."""
    for res in (1, 4, 7, 8, 15, 31, 63, 80, 81, 1289, 1290, 2048):
        for log2 in (9, 12, 17, 19):
            want = bool((np.float32(res) + np.float32(1.0)) ** 3 <= 2**log2)
            assert tenc.corner_is_dense(res, 2**log2) == want, (res, log2)
    assert tenc.corner_is_dense(7, 512) and not tenc.corner_is_dense(8, 512)


@pytest.mark.parametrize("case", list(LOOKUP_CASES))
def test_hash_corner_slots_match_jax(rng, case):
    """The 8 corners' slots of every level equal the JAX package's
    ``_hash_corner_indices`` exactly: dense where the criterion holds (with
    the stride res, so that x = res aliases the next row as in JAX), the
    hash otherwise, in wrapping uint32, positions outside the cube
    included."""
    levels, lo, hi, log2, _ = LOOKUP_CASES[case]
    res = jenc.hash_grid_resolutions(levels, lo, hi)
    pos = _positions(rng, 300, res)
    offsets = np.array([[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)], np.int32)
    kinds = set()
    for r in res:
        base = np.floor(pos * np.float32(r)).astype(np.int32)
        corners = base[:, None, :] + offsets[None]
        want = np.asarray(jenc._hash_corner_indices(jnp.asarray(corners), jnp.int32(r), 2**log2))
        got, _ = tenc.hash_corner_slots(_t(pos), int(r), 2**log2)
        assert np.array_equal(got.numpy(), want), int(r)
        kinds.add(tenc.corner_is_dense(int(r), 2**log2))
    assert kinds == {True, False}


@pytest.mark.parametrize("case", list(LOOKUP_CASES))
def test_hash_encoding_lookup_matches_jax(rng, case):
    """``hash_encoding_lookup`` (its plain version on the CPU) against the
    JAX package's on the same table ((L, F, T) there, (L, T, F) here) at
    TOL, positions at 0, 1, on faces and outside the cube included."""
    levels, lo, hi, log2, feats = LOOKUP_CASES[case]
    res = jenc.hash_grid_resolutions(levels, lo, hi)
    table = rng.uniform(-2, 2, (levels, feats, 2**log2)).astype(np.float32)
    pos = _positions(rng, 300, res)
    want = np.asarray(jenc.hash_encoding_lookup(jnp.asarray(table), jnp.asarray(pos), jnp.asarray(res), feats))
    got = tenc.hash_encoding_lookup(_t(table.transpose(0, 2, 1)).contiguous(), _t(pos), res, feats).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_hash_encoding_matches_dense_trilinear(rng):
    """tests/test_ops.py:88 on the port: on one dense level the lookup is the
    direct trilinear interpolation, with the JAX package's stride res."""
    res, feats = 4, 2
    size = (res + 1) ** 3
    table = rng.normal(size=(1, size, feats)).astype(np.float32)
    pts = rng.uniform(0, 1, size=(40, 3)).astype(np.float32)
    got = tenc.hash_encoding_lookup(_t(table), _t(pts), [res], feats).numpy()
    want = []
    for p in pts:
        scaled = p * res
        base = np.floor(scaled).astype(int)
        frac = scaled - base
        acc = np.zeros(feats, np.float32)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    cx, cy, cz = base + np.array([dx, dy, dz])
                    w = ((frac[0] if dx else 1 - frac[0]) * (frac[1] if dy else 1 - frac[1])
                         * (frac[2] if dz else 1 - frac[2]))
                    acc += w * table[0, (cx + res * (cy + res * cz)) % size]
        want.append(acc)
    np.testing.assert_allclose(got, np.stack(want), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("feats", [1, 2, 4])
def test_hash_encoding_forward_and_grads_match_jax(rng, feats):
    """tests/test_ops.py:126 on the port: ``HashEncoding`` with the JAX
    module's table (transposed by ``interop``), forward at TOL, the table's
    gradient level by level and the positions' against ``jax.vjp`` at
    GRID_GRAD_TOL relative to each one's largest entry (a corner entry sums
    up to eight lookups' contributions, in another order)."""
    jmod = jenc.HashEncoding(num_levels=4, min_res=4, max_res=32, log2_hashmap_size=8, features_per_level=feats)
    tree = _np(jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))["params"])
    tree = {"table": rng.uniform(-2, 2, tree["table"].shape).astype(np.float32)}
    tmod = tenc.HashEncoding(num_levels=4, min_res=4, max_res=32, log2_hashmap_size=8, features_per_level=feats,
                             device="cpu")
    tmod.load_state_dict(interop.params_from_jax(tree), strict=True)
    pos = rng.uniform(0.1, 0.9, (200, 3)).astype(np.float32)
    g_out = rng.normal(size=(200, 4 * feats)).astype(np.float32)

    def f(params, p):
        return jmod.apply({"params": params}, p)

    want, vjp = jax.vjp(f, jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(pos))
    want_g, want_gp = vjp(jnp.asarray(g_out))
    p = _t(pos).requires_grad_(True)
    got = tmod(p)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got.backward(_t(g_out))
    g_table = interop.params_to_jax({"table": tmod.table.grad})["table"]
    for g, w in zip(g_table, np.asarray(want_g["table"])):
        np.testing.assert_allclose(g, w, atol=GRID_GRAD_TOL["atol"] * np.abs(w).max(), rtol=GRID_GRAD_TOL["rtol"])
    wp = np.asarray(want_gp)
    np.testing.assert_allclose(p.grad.numpy(), wp, atol=GRID_GRAD_TOL["atol"] * np.abs(wp).max(),
                               rtol=GRID_GRAD_TOL["rtol"])


def test_positions_only_backward_matches_full(rng):
    """The lookup's backward computes only what autograd asks for: with the
    table frozen (the pose gradient) the positions' gradient equals the
    full backward's bit for bit, and the table gets none."""
    res = tenc.hash_grid_resolutions(4, 8, 96)
    table = _t(rng.uniform(-2, 2, (4, 1024, 2)).astype(np.float32))
    pos = _t(rng.uniform(0, 1, (100, 3)).astype(np.float32))
    g = _t(rng.normal(size=(100, 8)).astype(np.float32))
    t1, p1 = table.clone().requires_grad_(True), pos.clone().requires_grad_(True)
    tenc.hash_encoding_lookup(t1, p1, res, 2).backward(g)
    p2 = pos.clone().requires_grad_(True)
    tenc.hash_encoding_lookup(table, p2, res, 2).backward(g)
    assert torch.equal(p1.grad, p2.grad) and table.grad is None


# the corner layout in every field, each mixing a dense level (res 16: 17^3
# entries fit 2^13) and hashed ones; fewer levels than the small config's,
# as the JAX package's corner lookup (8 one-hot row gathers a level) is slow
# to compile on the CPU
CORNER = dict(grid_layout="corner", num_levels=3, max_res=128, log2_hashmap_size=13, proposal_net_args=(
    dict(num_levels=2, max_res=32, log2_hashmap_size=13, hidden_dim=16),
    dict(num_levels=2, max_res=64, log2_hashmap_size=13, hidden_dim=16),
))


@pytest.fixture(scope="module")
def corner_pair():
    """(JAX model, port model, the flax tree drawn by ``draw_params``, JAX
    and port ray bundles of 128 rays, JAX's eval outputs and spacing
    edges), built once for the module."""
    rng = np.random.default_rng(11)
    kw = small_config_kwargs(**CORNER)
    o, d, ci = rays(rng, 128)
    n = o.shape[0]
    jb = JBundle(jnp.asarray(o), jnp.asarray(d), jnp.zeros(n), jnp.ones(n), jnp.asarray(ci))
    tb = TBundle(_t(o), _t(d), torch.zeros(n), torch.ones(n), _t(ci).long())
    jmodel = JModel(JConfig(**kw))
    tree = draw_params(_np(jmodel.init(jax.random.PRNGKey(0), jb)["params"]), rng)
    tmodel = TModel(TConfig(**kw), device="cpu")
    tmodel.load_state_dict(interop.params_from_jax(tree), strict=True)
    out = jmodel.apply({"params": tree}, jb, train=True)
    want = {k: np.asarray(v) for k, v in out.items() if k not in ("weights_list", "sdist_list")}
    return jmodel, tmodel, tree, jb, tb, want, out["sdist_list"]


def test_corner_model_eval_matches_jax(corner_pair):
    """A corner ``NerfactoModel`` (the main field and both proposals on
    ``HashEncoding``, each mixing dense and hashed levels): the eval
    forward's outputs within OUTPUT_TOLS on rays that flipped no cell (the
    flipped ones bounded by MAX_FLIPPED_RAY_SHARE; JAX's train-mode forward
    without draws samples as its eval does), the same parameter shapes as
    the JAX tree with the tables transposed."""
    jmodel, tmodel, tree, jb, tb, want, j_sdist = corner_pair
    enc = tmodel.field.encoding
    assert isinstance(enc, tenc.HashEncoding) and isinstance(tmodel.proposal_0.encoding, tenc.HashEncoding)
    dense = [tenc.corner_is_dense(int(r), enc.table_size) for r in enc.resolutions]
    assert any(dense) and not all(dense)
    jt = np.asarray(tree["field"]["encoding"]["table"])  # (L, F, T)
    assert tuple(enc.table.shape) == (jt.shape[0], jt.shape[2], jt.shape[1])
    t_all = tmodel(tb, return_intermediates=True)
    got = {k: v.numpy() for k, v in tmodel(tb).items()}
    assert set(got) == set(want)
    assert (want["accumulation"] > 0.05).mean() > 0.5  # not a near-empty field
    flipped = (lookup_cells_jax(jmodel.config, jb, j_sdist) != tmodel.lookup_cells(tb, t_all["sdist_list"]).numpy()
               ).any(axis=1)
    assert flipped.mean() <= MAX_FLIPPED_RAY_SHARE, f"{flipped.sum()} of 128 rays flipped"
    bad = ray_mismatch(want, got)
    assert not (bad & ~flipped).any(), f"{(bad & ~flipped).sum()} unflipped rays differ"


def test_corner_training_batch_matches_jax(rng):
    """``NerfactoTrainer._loss_fn`` on the corner layout against the jitted
    JAX trainer's, JAX's forward draws replayed: every loss term within
    TRAIN_LOSS_RTOL and every gradient (the tables whole) within
    CPU_TRAIN_GRAD_L2, on rays that flipped no cell. With
    ``face_consistency_mult`` 1.0 neither package adds the face-consistency
    loss: the corner layout shares its corners by construction.

    The jitted JAX gradient of ``camera_opt`` holds NaN in some entries on
    this batch (XLA's CPU compile of the corner lookup's backward, ROADMAP
    section 3), so ``camera_opt``'s is held whole, all 18 entries, against
    JAX's eager evaluation of the same loss and batch, within
    CPU_TRAIN_GRAD_L2."""
    eager: dict = {}
    want_terms, got_terms, want, got, replaced = train_loss_and_grads(
        rng, "random", "white", config=dict(CORNER, face_consistency_mult=1.0), eager_grads=eager)
    assert "face_consistency_loss" not in got_terms
    assert "field.encoding.table" in got and "proposal_0.encoding.table" in got
    assert replaced <= MAX_FLIPPED_RAY_SHARE * 96 * 2 and set(got_terms) == set(want_terms)
    for k, w in want_terms.items():
        assert np.isclose(got_terms[k], w, rtol=TRAIN_LOSS_RTOL, atol=0), (k, got_terms[k], w)
    assert set(got) == set(want) == set(eager)
    want.pop("camera_opt")
    for k, w in want.items():
        assert got[k].shape == w.shape and torch.isfinite(got[k]).all(), k
        assert grad_l2_error(k, got[k], w) <= CPU_TRAIN_GRAD_L2, (k, grad_l2_error(k, got[k], w))
    cam_w, cam_g = eager["camera_opt"], got["camera_opt"]
    assert cam_g.shape == cam_w.shape == (3, 6)
    assert torch.isfinite(cam_w).all() and torch.isfinite(cam_g).all()
    assert grad_l2_error("camera_opt", cam_g, cam_w) <= CPU_TRAIN_GRAD_L2, grad_l2_error("camera_opt", cam_g, cam_w)


def test_corner_params_round_trip_and_groups(corner_pair):
    """``params_from_jax`` / ``params_to_jax`` carry the ``table`` leaves bit
    for bit both ways (the last two axes swapped), ``draw_params`` draws
    them in +-2, and ``label_params`` puts the main field's table in
    ``fields`` and the proposals' in ``proposal_networks``, as the JAX
    package's ``label_params``."""
    _, tmodel, tree, _, _, _, _ = corner_pair
    table = np.asarray(tree["field"]["encoding"]["table"])
    assert table.min() >= -2 and table.max() < 2 and table.std() > 0.5
    sd = interop.params_from_jax(tree)
    assert np.array_equal(sd["field.encoding.table"].numpy(), table.transpose(0, 2, 1))
    back = interop.params_to_jax(dict(tmodel.named_parameters()))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    labels = label_params(dict(tmodel.named_parameters()))
    assert labels["field.encoding.table"] == "fields"
    assert labels["proposal_0.encoding.table"] == labels["proposal_1.encoding.table"] == "proposal_networks"


def test_corner_trainer_state_round_trips_jax(tmp_path):
    """A JAX-built corner trainer with every leaf of its state dict drawn at
    random: ``trainer_state_from_jax``, the port's ``restore`` and
    ``state_dict``, and ``trainer_state_to_jax`` bring it back bit for bit
    (the tables' Adam moments transposed like the tables)."""
    from test_cli import TINY_OVERRIDES

    from uncertainty_nerf_gs_torch.data.synthetic import write_blender_dataset
    from uncertainty_nerf_gs_torch.scripts import train as ttrain
    from uncertainty_nerf_gs_tpu.scripts import train as jtrain

    scene = write_blender_dataset(tmp_path / "scene", 2, 1, 8, 8, device="cpu")
    overrides = dict(TINY_OVERRIDES, grid_layout="corner", num_levels=2)
    jtr, _, _ = jtrain.build_trainer("active-nerfacto", scene, "blender-data", 0, None, overrides)
    ttr, _, _ = ttrain.build_trainer("active-nerfacto", scene, "blender-data", 0, None, overrides, device="cpu")
    rng = np.random.default_rng(3)
    leaves, treedef = jax.tree_util.tree_flatten(jtr.state_dict())
    leaves = [rng.normal(size=np.shape(x)).astype(np.float32) if np.asarray(x).dtype == np.float32
              else np.asarray(x) + 5 for x in leaves]
    state = jax.tree_util.tree_unflatten(treedef, leaves)
    assert "table" in state["params"]["field"]["encoding"]
    ttr.restore(interop.trainer_state_from_jax(state))
    back = interop.trainer_state_to_jax(ttr.state_dict(), like=state)
    got, got_def = jax.tree_util.tree_flatten(back)
    assert got_def == treedef
    for a, b in zip(leaves, got):
        assert np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)


def test_corner_ensemble_routes_per_member(corner_pair):
    """``build_ensemble_chunk_fn`` on corner members renders per member in
    either mode, as the JAX package routes it (fused only for cell and
    hybrid): the "fused" chunk equals ``ensemble_render`` bit for bit, and
    the fused packer refuses the layout, naming it."""
    from uncertainty_nerf_gs_torch.models.ensemble import ensemble_render
    from uncertainty_nerf_gs_torch.parallel.ensemble_fused import pack_ensemble_tables
    from uncertainty_nerf_gs_torch.scripts.eval_uncertainty import build_ensemble_chunk_fn

    _, tmodel, tree, _, tb, _, _ = corner_pair
    trees = [interop.params_from_jax(draw_params(tree, np.random.default_rng(s))) for s in (1, 2)]
    stacked = interop.stack_params(trees)
    fused = build_ensemble_chunk_fn(tmodel, stacked, ensemble_mode="fused")(tb)
    want = ensemble_render(tmodel, stacked, tb)
    assert set(fused) == set(want) and all(torch.equal(fused[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="corner"):
        pack_ensemble_tables(tmodel, stacked)


# -- K7 and K8's CUDA source on the host ----------------------------------------


@pytest.fixture(scope="module")
def k7_host(tmp_path_factory) -> Path:
    """csrc/hash_grid.cu built with g++ against tests/host_cuda/cuda_shim.h
    (each warp 32 host threads meeting at a barrier for every shuffle, IEEE
    single precision with nothing fused) and tests/host_cuda/k7_main.inc."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build K7/K8's source for the host")
    text = (REPO / "uncertainty_nerf_gs_torch" / "csrc" / "hash_grid.cu").read_text()
    text = text.replace("#include <cuda_runtime.h>", '#include "cuda_shim.h"')
    out = tmp_path_factory.mktemp("k7_host")
    (out / "k7.cpp").write_text(re.sub(r"<<<[^>]*>>>", "", text) + '\n#include "k7_main.inc"\n')
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-w",
                    f"-I{REPO / 'tests' / 'host_cuda'}", str(out / "k7.cpp"), "-o", str(out / "k7")],
                   check=True, timeout=300)
    return out / "k7"


def _run_host(exe, tmp_path, mode, table, pos, res, g_out=None):
    levels, size, feats = table.shape
    pos.tofile(tmp_path / "positions.bin")
    np.asarray(res, np.int32).tofile(tmp_path / "resolutions.bin")
    np.asarray([tenc.corner_dense_mask(res, size)], np.uint32).tofile(tmp_path / "dense.bin")
    table.tofile(tmp_path / "table.bin")
    if g_out is not None:
        g_out.tofile(tmp_path / "g_out.bin")
    subprocess.run([str(exe), str(tmp_path), mode, str(pos.shape[0]), str(levels), str(size), str(feats)],
                   check=True, timeout=120)


# name -> (levels, max_res, log2, n, F); min_res 16. A sample's levels take
# 1 to 32 lanes of a warp; every case mixes dense and hashed levels.
HOST_CASES = {
    "proposal_f2": (5, 128, 13, 300, 2),
    "field_f2": (16, 2048, 13, 60, 2),
    "f1": (4, 256, 13, 150, 1),
    "f4": (3, 96, 13, 77, 4),
    "f8": (5, 256, 13, 40, 8),
    "table_not_pow2": (4, 96, None, 90, 2),
}


def _host_inputs(rng, case):
    levels, max_res, log2, n, feats = HOST_CASES[case]
    size = 6000 if log2 is None else 2**log2
    res = tenc.hash_grid_resolutions(levels, 16, max_res)
    dense = [tenc.corner_is_dense(int(r), size) for r in res]
    assert any(dense) and not all(dense)
    table = rng.uniform(-2, 2, (levels, size, feats)).astype(np.float32)
    return table, _positions(rng, n, res), res


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_k7_source_matches_plain_version(k7_host, tmp_path, rng, case):
    """K7 on the host equals ``hash_encoding_lookup_reference`` bit for bit
    (as chip_smoke.py requires on the card), on a random table and on one
    whose entries hold their own slot."""
    table, pos, res = _host_inputs(rng, case)
    for t in (table, np.broadcast_to(np.arange(table.shape[1], dtype=np.float32)[None, :, None],
                                     table.shape).copy()):
        _run_host(k7_host, tmp_path, "fwd", t, pos, res)
        got = np.fromfile(tmp_path / "out.bin", np.float32).reshape(pos.shape[0], -1)
        want = tenc.hash_encoding_lookup_reference(_t(t), _t(pos), res, t.shape[2]).numpy()
        assert np.array_equal(got, want), f"{int((got != want).sum())} of {got.size} features differ"


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_k8_source_matches_plain_version(k7_host, tmp_path, rng, case):
    """K8 on the host (stages 1, 3 and 4 as written, warp by warp; the
    radix sort as a stable sort of its keys) against autograd through the
    plain lookup: the table gradient level by level and the positions'
    within GRID_GRAD_TOL; its positions-only mode's g_pos equal to the full
    backward's bit for bit."""
    table, pos, res = _host_inputs(rng, case)
    g_out = rng.normal(size=(pos.shape[0], table.shape[0] * table.shape[2])).astype(np.float32)
    _run_host(k7_host, tmp_path, "bwd", table, pos, res, g_out)
    g_table = np.fromfile(tmp_path / "g_table.bin", np.float32).reshape(table.shape)
    g_pos = np.fromfile(tmp_path / "g_pos.bin", np.float32).reshape(-1, 3)
    _run_host(k7_host, tmp_path, "pos", table, pos, res, g_out)
    only = np.fromfile(tmp_path / "g_pos.bin", np.float32).reshape(-1, 3)
    t, p = _t(table).requires_grad_(True), _t(pos).requires_grad_(True)
    want_t, want_p = torch.autograd.grad(tenc.hash_encoding_lookup_reference(t, p, res, table.shape[2]), [t, p],
                                         _t(g_out))
    for got_l, want_l in zip(_t(g_table), want_t):
        assert not grad_mismatch(got_l, want_l, GRID_GRAD_TOL).any()
    assert not grad_mismatch(_t(g_pos), want_p, GRID_GRAD_TOL).any()
    assert np.array_equal(only, g_pos)


@pytest.mark.parametrize("levels,feats", [(5, 2), (16, 2), (4, 1), (3, 4)])
def test_k5_positions_only_source_matches_full(k7_host, tmp_path, rng, levels, feats):
    """K5's keys kernel on the host with keys (the full backward's first
    stage) and without (the positions-only mode): the same g_pos bit for
    bit, within GRID_GRAD_TOL of autograd through ``cell_lookup_reference``."""
    res = tenc.hash_grid_resolutions(levels, 16, 512)
    size = 2**13  # the first level dense (16^3 cells), the last hashed
    cells = rng.uniform(-2, 2, (levels, size * 8 * feats // 128, 128)).astype(np.float32)
    pos = _positions(rng, 120, res)
    g_out = rng.normal(size=(120, levels * feats)).astype(np.float32)
    pos.tofile(tmp_path / "positions.bin")
    np.asarray(res, np.int32).tofile(tmp_path / "resolutions.bin")
    cells.tofile(tmp_path / "cells.bin")
    g_out.tofile(tmp_path / "g_out.bin")
    subprocess.run([str(k7_host), str(tmp_path), "k5", "120", str(levels), str(size), str(feats)], check=True,
                   timeout=120)
    full = np.fromfile(tmp_path / "g_pos_full.bin", np.float32).reshape(-1, 3)
    only = np.fromfile(tmp_path / "g_pos.bin", np.float32).reshape(-1, 3)
    assert np.array_equal(full, only)
    p = _t(pos).requires_grad_(True)
    want = torch.autograd.grad(tenc.cell_lookup_reference(_t(cells), p, res, size, feats), [p], _t(g_out))[0]
    assert not grad_mismatch(_t(only), want, GRID_GRAD_TOL).any()


@pytest.mark.parametrize("levels,feats", [(5, 2), (16, 2), (4, 1), (3, 4)])
def test_k5_source_sums_match_plain_version(k7_host, tmp_path, rng, levels, feats):
    """K5's stages 3 and 4 on the host (the segmented sum K8 shares, warp by
    warp; the radix sort as a stable sort of its keys) against autograd
    through ``cell_lookup_reference``: the cells' gradient level by level
    within GRID_GRAD_TOL. 300 of the 400 samples lie in one small cluster,
    so that a level's run of one cell is longer than a chunk of 256 keys
    and crosses chunks (stage 4)."""
    res = tenc.hash_grid_resolutions(levels, 16, 512)
    size = 2**13
    cells = rng.uniform(-2, 2, (levels, size * 8 * feats // 128, 128)).astype(np.float32)
    n, cluster = 400, 300
    pos = _positions(rng, n, res)
    pos[n - cluster:] = (0.3 + rng.uniform(0, 1e-3, (cluster, 3))).astype(np.float32)
    g_out = rng.normal(size=(n, levels * feats)).astype(np.float32)
    pos.tofile(tmp_path / "positions.bin")
    np.asarray(res, np.int32).tofile(tmp_path / "resolutions.bin")
    cells.tofile(tmp_path / "cells.bin")
    g_out.tofile(tmp_path / "g_out.bin")
    subprocess.run([str(k7_host), str(tmp_path), "k5", str(n), str(levels), str(size), str(feats)], check=True,
                   timeout=120)
    got = np.fromfile(tmp_path / "g_cells.bin", np.float32).reshape(cells.shape)
    c = _t(cells).requires_grad_(True)
    want = torch.autograd.grad(tenc.cell_lookup_reference(c, _t(pos), res, size, feats), [c], _t(g_out))[0]
    assert np.abs(want[0].numpy()).max() > 0
    for got_l, want_l in zip(_t(got), want):
        assert not grad_mismatch(got_l, want_l, GRID_GRAD_TOL).any()


def test_corner_steps_with_checkpointing_and_launches(tmp_path):
    """A corner trainer's steps with ``gradient_checkpointing`` equal the
    plain steps bit for bit, and K steps a launch equal K single steps (on
    the CPU the launch is a loop; on the card one replayed CUDA graph,
    chip_smoke.py::run_corner)."""
    from test_cli import TINY_OVERRIDES

    from uncertainty_nerf_gs_torch.data.synthetic import write_blender_dataset
    from uncertainty_nerf_gs_torch.scripts import train as ttrain

    scene = write_blender_dataset(tmp_path / "scene", 3, 1, 12, 12, device="cpu")
    overrides = dict(TINY_OVERRIDES, grid_layout="corner")
    states = []
    for ckpt, k in ((False, 1), (True, 1), (False, 3)):
        tr, _, _ = ttrain.build_trainer("active-nerfacto", scene, "blender-data", 0, None, overrides,
                                        grad_checkpoint=ckpt, device="cpu")
        tr.train(3, num_rays_per_batch=32, steps_per_launch=k)
        states.append(tr.state_dict())
    for other in states[1:]:
        for k, v in states[0]["params"].items():
            assert torch.equal(v, other["params"][k]), k
