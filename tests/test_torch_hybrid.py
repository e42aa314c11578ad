"""Parity of the port's sparse-view path against the JAX package, on the CPU:
the NeRF frequency encoding, the hybrid layout's level plan and corner-grid
expansion, the hybrid encoding forward and backward, the per-level cell
lookup, the face-consistency penalty with the JAX package's vertices, the
mlp proposal field, a hybrid model with an mlp proposal, and one training
batch with the face-consistency loss against the jitted JAX trainer.

Inputs are drawn with numpy from a seed; the tolerances are
tests/torch_parity.py's, named at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _check_train_parity, train_loss_and_grads
from torch_parity import (
    CPU_TRAIN_GRAD_L2,
    GRID_GRAD_TOL,
    MAX_FLIPPED_RAY_SHARE,
    TOL,
    draw_params,
    lookup_cells_jax,
    ray_mismatch,
    rays,
    small_config_kwargs,
)

from uncertainty_nerf_gs_tpu.fields.nerfacto_field import ProposalDensityField as JProposal
from uncertainty_nerf_gs_tpu.models.nerfacto import NerfactoConfig as JConfig, NerfactoModel as JModel
from uncertainty_nerf_gs_tpu.ops import encodings as jenc
from uncertainty_nerf_gs_tpu.ops.sampling import RayBundle as JBundle

from uncertainty_nerf_gs_torch.fields.nerfacto_field import ProposalDensityField as TProposal
from uncertainty_nerf_gs_torch.interop import params_from_jax
from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig as TConfig, NerfactoModel as TModel
from uncertainty_nerf_gs_torch.ops import encodings as tenc
from uncertainty_nerf_gs_torch.ops.sampling import RayBundle as TBundle


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- the frequency encoding --------------------------------------------------


@pytest.mark.parametrize("freqs,lo,hi,include", [(6, 0.0, 5.0, False), (5, 0.0, 4.0, True), (3, -1.0, 2.5, True)])
def test_nerf_encoding_matches_jax(rng, freqs, lo, hi, include):
    """Layout exactly (sines, then cosines, frequency innermost; the input
    first), values at TOL: sin and cos of arguments up to 2 pi 2^5 differ in
    their last bits between the two libraries."""
    x = rng.uniform(-1, 1, (7, 5, 3)).astype(np.float32)
    want = np.asarray(jenc.nerf_encoding(jnp.asarray(x), freqs, lo, hi, include))
    got = tenc.nerf_encoding(_t(x), freqs, lo, hi, include).numpy()
    assert got.shape == want.shape == (7, 5, 3 * (include + 2 * freqs))
    np.testing.assert_allclose(got, want, **TOL)


# -- the hybrid layout's plan and expansion -----------------------------------


@pytest.mark.parametrize("levels,max_res,log2", [(16, 2048, 19), (5, 128, 17), (5, 256, 17), (6, 256, 10)])
def test_hybrid_level_plan_matches_jax(levels, max_res, log2):
    """``hybrid_is_dense`` and the encoding's level plan, exactly: the main
    field's and both proposals' full-width plans (8 + 8, 4 + 1 and 3 + 2
    dense + hashed levels) and a small one; the parameters' names and shapes
    are the flax module's."""
    table = 2**log2
    for res in range(1, 400):
        assert tenc.hybrid_is_dense(res, table) == jenc.hybrid_is_dense(res, table)
    jmod = jenc.HybridHashEncoding(num_levels=levels, max_res=max_res, log2_hashmap_size=log2)
    want_res, want_dense = jmod.level_plan()
    if levels * log2 <= 60:  # small enough to initialise here
        tree = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((1, 3)))["params"]
        tmod = tenc.HybridHashEncoding(num_levels=levels, max_res=max_res, log2_hashmap_size=log2, device="cpu")
        assert {k: tuple(v.shape) for k, v in tmod.named_parameters()} == {k: v.shape for k, v in tree.items()}
    tmod = tenc.HybridHashEncoding.__new__(tenc.HybridHashEncoding)
    tmod.resolutions = tenc.hash_grid_resolutions(levels, 16, max_res)
    tmod.is_dense = [tenc.hybrid_is_dense(int(r), table) for r in tmod.resolutions]
    got_res, got_dense = tmod.level_plan()
    assert np.array_equal(got_res, want_res) and got_dense == list(want_dense)
    plans = {(16, 2048, 19): 8, (5, 128, 17): 4, (5, 256, 17): 3}
    if (levels, max_res, log2) in plans:
        assert sum(got_dense) == plans[(levels, max_res, log2)]


@pytest.mark.parametrize("res,feats", [(1, 2), (3, 2), (5, 1), (6, 4), (7, 2)])
def test_dense_corner_to_cell_rows_matches_jax(rng, res, feats):
    """Bit for bit: eight static slices, stacked and padded to whole rows."""
    grid = rng.normal(size=(res + 1, res + 1, (res + 1) * feats)).astype(np.float32)
    want = np.asarray(jenc.dense_corner_to_cell_rows(jnp.asarray(grid), res, feats))
    got = tenc.dense_corner_to_cell_rows(_t(grid), res, feats).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


def _hybrid_pair(rng, levels=5, max_res=64, log2=10, feats=2):
    """The JAX HybridHashEncoding's params drawn in +-2 and the port's
    encoding on them."""
    jmod = jenc.HybridHashEncoding(num_levels=levels, max_res=max_res, log2_hashmap_size=log2,
                                   features_per_level=feats)
    tree = _np(jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))["params"])
    tree = {k: rng.uniform(-2, 2, v.shape).astype(np.float32) for k, v in tree.items()}
    tmod = tenc.HybridHashEncoding(num_levels=levels, max_res=max_res, log2_hashmap_size=log2,
                                   features_per_level=feats, device="cpu")
    tmod.load_state_dict({k: _t(v) for k, v in tree.items()}, strict=True)
    return jmod, tmod, tree


@pytest.mark.parametrize("feats", [1, 2, 4])
def test_hybrid_encoding_forward_and_grads_match_jax(rng, feats):
    """Forward at TOL and every gradient (the hashed cells level by level,
    each corner grid, the positions) against ``jax.vjp`` at GRID_GRAD_TOL
    relative to each leaf's largest entry: a dense level's corner is shared
    by up to eight cells, whose sums the two packages add in another order."""
    jmod, tmod, tree = _hybrid_pair(rng, feats=feats)
    assert any(k.startswith("corners_") for k in tree) and "cells" in tree
    pos = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    g_out = rng.normal(size=(200, 5 * feats)).astype(np.float32)

    def f(params, p):
        return jmod.apply({"params": params}, p)

    want, vjp = jax.vjp(f, jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(pos))
    want_g, want_gp = vjp(jnp.asarray(g_out))
    p = _t(pos).requires_grad_(True)
    got = tmod(p)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got.backward(_t(g_out))
    for name, leaf in tmod.named_parameters():
        w = np.asarray(want_g[name])
        levels = zip(leaf.grad.numpy(), w) if name == "cells" else [(leaf.grad.numpy(), w)]
        for g, wl in levels:
            np.testing.assert_allclose(g, wl, atol=GRID_GRAD_TOL["atol"] * np.abs(wl).max(),
                                       rtol=GRID_GRAD_TOL["rtol"], err_msg=name)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_gp), atol=GRID_GRAD_TOL["atol"] * np.abs(
        np.asarray(want_gp)).max(), rtol=GRID_GRAD_TOL["rtol"])


def test_per_level_cell_lookup_matches_jax(rng):
    """``cell_lookup`` on per-level tables and sizes (res^3 cells at a dense
    level, a hashed table above, a non-power-of-two table) against the JAX
    package's at TOL, and bit for bit against the stacked form where the
    levels share a size."""
    res = (8, 12, 40, 70)
    sizes = [512, 1728, 1000, 2048]
    tables = [rng.uniform(-2, 2, (-(-s * 16 // 128), 128)).astype(np.float32) for s in sizes]
    pos = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    pos[:3] = [[0, 0, 0], [1, 1, 1], [-1e-7, 0.5, 1 + 1e-7]]
    want = np.asarray(jenc.cell_lookup([jnp.asarray(t) for t in tables], jnp.asarray(pos), res, sizes, 2))
    got = tenc.cell_lookup([_t(t) for t in tables], _t(pos), res, sizes, 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    same = [rng.uniform(-2, 2, (128, 128)).astype(np.float32) for _ in res]
    stacked = tenc.cell_lookup(_t(np.stack(same)), _t(pos), res, 1024, 2)
    assert torch.equal(stacked, tenc.cell_lookup([_t(t) for t in same], _t(pos), res, [1024] * 4, 2))


# -- the face-consistency penalty --------------------------------------------


@pytest.mark.parametrize("res,log2,feats", [(8, 10, 2), (40, 10, 2), (9, 12, 1), (30, 11, 4)])
def test_face_consistency_loss_matches_jax(rng, res, log2, feats):
    """The penalty and its gradient with the JAX package's vertices
    (``jax.random.randint`` of its key) injected, at TOL: a dense-indexed
    level (res^3 <= table) and hashed ones, F = 1, 2 and 4; the population
    variance (``correction=0``, as ``jnp.var``)."""
    table = 2**log2
    rows = rng.uniform(-2, 2, (-(-table * 8 * feats // 128), 128)).astype(np.float32)
    key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
    want, grad = jax.value_and_grad(jenc.face_consistency_loss)(jnp.asarray(rows), res, table, key, 256, feats)
    vertices = _t(jax.random.randint(key, (256, 3), 1, res)).long()
    r = _t(rows).requires_grad_(True)
    got = tenc.face_consistency_loss(r, res, table, vertices, 256, feats)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(grad), atol=TOL["atol"] * np.abs(np.asarray(grad)).max(),
                               rtol=TOL["rtol"])
    # from a generator: vertices in [1, res), a finite penalty
    gen = torch.Generator().manual_seed(0)
    drawn = tenc.face_vertices([res], 64, gen)[0]
    assert drawn.shape == (64, 3) and int(drawn.min()) >= 1 and int(drawn.max()) < res
    assert torch.isfinite(tenc.face_consistency_loss(_t(rows), res, table, torch.Generator().manual_seed(0), 64,
                                                     feats))
    assert float(tenc.face_consistency_loss(_t(rows), 1, table, vertices, 256, feats)) == 0.0


# -- the mlp proposal and a hybrid model ---------------------------------------


def test_mlp_proposal_matches_jax(rng):
    """``ProposalDensityField(field_type="mlp")``: the parameter tree is the
    flax module's (an MLP on 33 inputs, no grid), densities at TOL."""
    p = (rng.normal(size=(8, 24, 3)) * 1.5).astype(np.float32)
    jf = JProposal(field_type="mlp")
    tree = draw_params(_np(jf.init(jax.random.PRNGKey(0), jnp.asarray(p))["params"]), rng)
    assert set(tree) == {"mlp"}
    tf = TProposal(field_type="mlp", device="cpu")
    tf.load_state_dict(params_from_jax(tree), strict=True)
    want = np.asarray(jf.apply({"params": tree}, jnp.asarray(p)))
    with torch.no_grad():
        got = tf(_t(p)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


HYBRID_MLP = dict(grid_layout="hybrid", proposal_net_args=(
    dict(num_levels=3, max_res=64, log2_hashmap_size=10, hidden_dim=16, field_type="mlp"),
    dict(num_levels=3, max_res=128, log2_hashmap_size=10, hidden_dim=16),
))


def test_hybrid_mlp_model_eval_matches_jax(rng):
    """A hybrid NerfactoModel whose first proposal is an mlp (the per-net
    ``field_type`` override) and whose second and main field mix dense and
    hashed levels: the eval forward's outputs within OUTPUT_TOLS on rays that
    flipped no cell, the flipped rays bounded by MAX_FLIPPED_RAY_SHARE."""
    kw = small_config_kwargs(**HYBRID_MLP)
    o, d, ci = rays(rng, 256)
    n = o.shape[0]
    jb = JBundle(jnp.asarray(o), jnp.asarray(d), jnp.zeros(n), jnp.ones(n), jnp.asarray(ci))
    tb = TBundle(_t(o), _t(d), torch.zeros(n), torch.ones(n), _t(ci).long())
    jmodel = JModel(JConfig(**kw))
    tree = draw_params(_np(jmodel.init(jax.random.PRNGKey(0), jb)["params"]), rng)
    tmodel = TModel(TConfig(**kw), device="cpu")
    tmodel.load_state_dict(params_from_jax(tree), strict=True)
    enc = tmodel.field.encoding
    assert any(enc.is_dense) and not all(enc.is_dense) and "encoding" not in tree["proposal_0"]
    want = {k: np.asarray(v) for k, v in jmodel.apply({"params": tree}, jb).items()}
    j_sdist = jmodel.apply({"params": tree}, jb, train=True)["sdist_list"]
    t_all = tmodel(tb, return_intermediates=True)
    got = {k: v.numpy() for k, v in tmodel(tb).items()}
    assert set(got) == set(want)
    assert (want["accumulation"] > 0.5).mean() > 0.1  # not a near-empty field
    flipped = (lookup_cells_jax(jmodel.config, jb, j_sdist) != tmodel.lookup_cells(tb, t_all["sdist_list"]).numpy()
               ).any(axis=1)
    assert flipped.mean() <= MAX_FLIPPED_RAY_SHARE, f"{flipped.sum()} of 256 rays flipped"
    bad = ray_mismatch(want, got)
    assert not (bad & ~flipped).any(), f"{(bad & ~flipped).sum()} unflipped rays differ"


# -- a training batch with the face-consistency loss --------------------------


def test_face_consistency_batch_matches_jax(rng):
    """``NerfactoTrainer._loss_fn`` with ``grid_layout="hybrid"`` and
    ``face_consistency_mult=1.0`` (what the sparse parsers set) against the
    jitted JAX trainer's, JAX's forward draws and face vertices replayed:
    every loss term, ``face_consistency_loss`` among them, within
    TRAIN_LOSS_RTOL, every gradient (the hashed cells level by level, the
    corner grids) within CPU_TRAIN_GRAD_L2, on rays that flipped no cell."""
    result = train_loss_and_grads(rng, "zero", "white", config=dict(grid_layout="hybrid",
                                                                      face_consistency_mult=1.0))
    assert "face_consistency_loss" in result[1] and result[1]["face_consistency_loss"] > 0
    assert any(k.startswith("field.encoding.corners_") for k in result[3])
    _check_train_parity(*result, CPU_TRAIN_GRAD_L2)
