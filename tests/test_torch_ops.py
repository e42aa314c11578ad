"""Parity of the PyTorch port's ops against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both packages; tolerances are stated
in tests/torch_parity.py (``TOL``: atol 2e-5, rtol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import GRID_GRAD_TOL, TOL, grad_mismatch

from uncertainty_nerf_gs_tpu.cameras import cameras as jcam
from uncertainty_nerf_gs_tpu.cameras import lie as jlie
from uncertainty_nerf_gs_tpu.data.synthetic import hemisphere_cameras as j_hemisphere
from uncertainty_nerf_gs_tpu.ops import activations as jact
from uncertainty_nerf_gs_tpu.ops import encodings as jenc
from uncertainty_nerf_gs_tpu.ops import raymarch as jrm
from uncertainty_nerf_gs_tpu.ops import sampling as jsamp
from uncertainty_nerf_gs_tpu.ops import spatial as jsp
from uncertainty_nerf_gs_tpu.ops.mlp import MLP as JMLP
from uncertainty_nerf_gs_tpu.ops.pdf_pallas import resample_edges_tpu

from uncertainty_nerf_gs_torch.cameras import cameras as tcam
from uncertainty_nerf_gs_torch.cameras import lie as tlie
from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras as t_hemisphere
from uncertainty_nerf_gs_torch.interop import params_from_jax
from uncertainty_nerf_gs_torch.ops import activations as tact
from uncertainty_nerf_gs_torch.ops import encodings as tenc
from uncertainty_nerf_gs_torch.ops import raymarch as trm
from uncertainty_nerf_gs_torch.ops import sampling as tsamp
from uncertainty_nerf_gs_torch.ops import spatial as tsp
from uncertainty_nerf_gs_torch.ops.mlp import MLP as TMLP
from uncertainty_nerf_gs_torch.ops.mlp import Dropout
from uncertainty_nerf_gs_torch.ops.pdf_resample import (
    resample_edges,
    resample_edges_reference,
)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), **(tol or TOL)
    )


# -- activations -------------------------------------------------------------


def test_trunc_exp_and_shifted_softplus(rng):
    x = np.concatenate(
        [rng.normal(size=64) * 5, [-40.0, -15.5, 14.9, 15.0, 15.5, 40.0]]
    ).astype(np.float32)
    _close(tact.trunc_exp(_t(x)), jact.trunc_exp(jnp.asarray(x)))
    # the clipped gradient: g * exp(clip(x, -15, 15))
    g = rng.normal(size=x.shape).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jact.trunc_exp(v) * g))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    torch.sum(tact.trunc_exp(xt) * _t(g)).backward()
    _close(xt.grad, want)
    _close(
        tact.shifted_softplus(_t(x), 0.01), jact.shifted_softplus(jnp.asarray(x), 0.01)
    )


# -- spatial -----------------------------------------------------------------


def test_spatial(rng):
    x = (rng.normal(size=(256, 3)) * 3).astype(np.float32)
    x[0] = 0.0  # the 1e-9 floor on the magnitude
    _close(tsp.scene_contraction(_t(x)), jsp.scene_contraction(jnp.asarray(x)))
    _close(
        tsp.scene_contraction(_t(x), order=2),
        jsp.scene_contraction(jnp.asarray(x), order=2),
    )
    _close(tsp.contract_to_unit_cube(_t(x)), jsp.contract_to_unit_cube(jnp.asarray(x)))
    aabb = np.float32([[-1.5, -1.0, -2.0], [1.5, 2.0, 2.0]])
    _close(
        tsp.normalize_aabb(_t(x), _t(aabb)),
        jsp.normalize_aabb(jnp.asarray(x), jnp.asarray(aabb)),
    )


# -- sampling ----------------------------------------------------------------


def _bundles(rng, n, near=0.05, far=1000.0):
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nears = np.full(n, near, np.float32)
    fars = np.full(n, far, np.float32)
    ci = np.zeros(n, np.int32)
    jb = jsamp.RayBundle(*(jnp.asarray(a) for a in (o, d, nears, fars, ci)))
    tb = tsamp.RayBundle(*(_t(a) for a in (o, d, nears, fars)), _t(ci).long())
    return jb, tb


def _check_samples(got, want):
    for name in ("starts", "ends", "spacing_edges", "deltas", "midpoints", "positions"):
        _close(getattr(got, name), getattr(want, name))


def test_spacing_functions(rng):
    t = np.concatenate(
        [rng.uniform(0, 2, 128), rng.uniform(1, 1e4, 128), [0.0, 1.0]]
    ).astype(np.float32)
    s = rng.uniform(0, 1, 256).astype(np.float32)
    _close(tsamp.spacing_piecewise(_t(t)), jsamp.spacing_piecewise(jnp.asarray(t)))
    _close(
        tsamp.spacing_piecewise_inv(_t(s)), jsamp.spacing_piecewise_inv(jnp.asarray(s))
    )
    assert torch.equal(tsamp.spacing_uniform(_t(s)), _t(s))
    assert torch.equal(tsamp.spacing_uniform_inv(_t(s)), _t(s))


@pytest.mark.parametrize("num_samples", [256, 96, 7])
def test_sample_uniform_eval(rng, num_samples):
    jb, tb = _bundles(rng, 32)
    want = jsamp.sample_uniform(jb, num_samples)
    got = tsamp.sample_uniform(tb, num_samples)
    # evenly spaced edges are bit-identical (same float32 rounding)
    assert np.array_equal(got.spacing_edges.numpy(), np.asarray(want.spacing_edges))
    _check_samples(got, want)
    ju = jsamp.sample_uniform(
        jb, num_samples, spacing_fn=jsamp.spacing_uniform,
        spacing_fn_inv=jsamp.spacing_uniform_inv,
    )
    tu = tsamp.sample_uniform(
        tb, num_samples, spacing_fn=tsamp.spacing_uniform,
        spacing_fn_inv=tsamp.spacing_uniform_inv,
    )
    _check_samples(tu, ju)


def test_sample_uniform_stratified_stays_sorted(rng):
    """Stratified edges stay sorted in [0, 1]; with the draws of a JAX key
    (``jax.random.uniform(key, (R, S + 1))``) they are the JAX package's
    edges for that key, bit for bit."""
    jb, tb = _bundles(rng, 16)
    key = jax.random.PRNGKey(3)
    rs = tsamp.sample_uniform(tb, 64, draws=_t(jax.random.uniform(key, (16, 65))))
    edges = rs.spacing_edges
    assert (edges[:, 0] >= 0).all() and (edges[:, -1] <= 1).all()
    assert (torch.diff(edges, dim=1) >= 0).all()
    centred = tsamp.sample_uniform(tb, 64).spacing_edges
    assert not torch.equal(edges, centred)
    want = jsamp.sample_uniform(jb, 64, key=key)
    assert np.array_equal(edges.numpy(), np.asarray(want.spacing_edges))
    _check_samples(rs, want)


def test_sample_pdf_stratified_matches_jax(rng):
    """Training-time u from the draws of a JAX key, as the JAX package's
    ``sample_pdf(key=...)`` draws them."""
    r, s, n = 64, 96, 48
    jb, tb = _bundles(rng, r)
    w = (rng.uniform(0, 1, (r, s)) ** 4).astype(np.float32)
    edges = np.sort(rng.uniform(0, 1, (r, s + 1)).astype(np.float32), axis=1)
    key = jax.random.PRNGKey(5)
    want = jsamp.sample_pdf(jb, jnp.asarray(edges), jnp.asarray(w), n, key=key)
    got = tsamp.sample_pdf(tb, _t(edges), _t(w), n, draws=_t(jax.random.uniform(key, (r, n + 1))))
    _close(got.spacing_edges, want.spacing_edges)
    assert not np.array_equal(got.spacing_edges.numpy(),
                              tsamp.sample_pdf(tb, _t(edges), _t(w), n).spacing_edges.numpy())


@pytest.mark.parametrize("s,n", [(256, 96), (96, 48), (24, 12)])
def test_sample_pdf_eval_matches_xla_branch(rng, s, n):
    r = 64
    jb, tb = _bundles(rng, r)
    w = (rng.uniform(0, 1, (r, s)) ** 4).astype(np.float32)
    w[3] = 0.0
    edges = np.sort(rng.uniform(0, 1, (r, s + 1)).astype(np.float32), axis=1)
    want = jsamp.sample_pdf(jb, jnp.asarray(edges), jnp.asarray(w), n)
    got = tsamp.sample_pdf(tb, _t(edges), _t(w), n)
    _close(got.spacing_edges, want.spacing_edges)
    assert got.spacing_edges.shape == (r, n + 1)
    # t = 1 / (2 - 2 s) scales an s-edge's last-bit difference by 2 t^2 near
    # s -> 1, so the t-space samples are held on the same s-edges
    same = tsamp._edges_to_samples(
        tb, _t(want.spacing_edges), tsamp.spacing_piecewise,
        tsamp.spacing_piecewise_inv,
    )
    _check_samples(same, want)


def test_sample_pdf_eval_queries_match_jax():
    """The eval-time u, clip((arange(n+1)+0.5)/(n+1), 0, 1-1e-6), reaches the
    resampler: a flat histogram over uniform edges maps u onto itself."""
    for n in (96, 48, 12):
        want = np.asarray(
            jnp.clip((jnp.arange(n + 1, dtype=jnp.float32) + 0.5) / (n + 1), 0, 1 - 1e-6)
        )
        _, tb = _bundles(np.random.default_rng(0), 1)
        w = torch.zeros(1, 4)
        # an all-zero histogram over uniform edges maps u onto itself
        got = tsamp.sample_pdf(tb, torch.linspace(0, 1, 5)[None], w, n).spacing_edges
        np.testing.assert_allclose(got[0].numpy(), want, atol=1e-7, rtol=0)


@pytest.mark.parametrize("s,n", [(256, 97), (96, 49), (24, 13), (1, 13), (24, 1)])
def test_resample_reference_matches_pallas_interpret(s, n):
    """resample_edges_reference == the JAX Pallas kernel in interpret mode,
    as tests/test_ops.py runs it, including the all-zero row, one bin a ray
    (S = 1) and one query a ray (N = 1)."""
    rng = np.random.default_rng(0)
    r = 7
    w = (rng.uniform(0, 1, (r, s)).astype(np.float32)) ** 4
    w[2] = 0.0
    edges = np.sort(rng.uniform(0, 1, (r, s + 1)).astype(np.float32), axis=1)
    u = np.clip((np.arange(n, dtype=np.float32)[None] + 0.5) / n, 0, 1 - 1e-6)
    u = np.ascontiguousarray(np.broadcast_to(u, (r, n)), dtype=np.float32)
    want = np.asarray(
        resample_edges_tpu(jnp.asarray(w), jnp.asarray(edges), jnp.asarray(u))
    )
    got = resample_edges_reference(_t(w), _t(edges), _t(u)).numpy()
    _close(got, want)
    assert (np.diff(got, axis=1) >= -1e-6).all()
    # on a CPU tensor the checked wrapper runs exactly the plain version
    assert np.array_equal(resample_edges(_t(w), _t(edges), _t(u)).numpy(), got)


def _training_resampler_inputs(rng, r, s, n, anneal):
    """What a training step hands a resampler, drawn with numpy: compositing
    weights of random densities (exact zeros where the transmittance
    underflows, as behind an opaque sample) raised to the proposal
    annealing power, stratified edges, and stratified u from uniform
    draws."""
    tau = rng.exponential(0.05, (r, s)) * (rng.uniform(size=(r, s)) < 0.3) * rng.uniform(0, 40, (r, 1))
    trans = np.exp(-np.concatenate([np.zeros((r, 1)), np.cumsum(tau, axis=1)[:, :-1]], axis=1))
    w = ((1 - np.exp(-tau)) * trans).astype(np.float32)
    w[w < 1e-30] = 0.0
    w = (w ** np.float32(anneal)).astype(np.float32)
    w[:, -s // 4:][rng.uniform(size=(r, 1)).repeat(s // 4, 1) < 0.5] = 0.0
    jitter = ((rng.uniform(size=(r, s + 1)) - 0.5) / s).astype(np.float32)
    jitter[:, 0] = np.maximum(jitter[:, 0], 0)
    jitter[:, -1] = np.minimum(jitter[:, -1], 0)
    edges = (np.linspace(0, 1, s + 1, dtype=np.float32)[None] + jitter).astype(np.float32)
    draws = rng.uniform(size=(r, n)).astype(np.float32)
    return w, edges, draws


@pytest.mark.parametrize("s,n,anneal", [(256, 97, 0.04784689), (96, 49, 0.04784689), (256, 97, 1.0)])
def test_resample_training_inputs_match_jax(rng, s, n, anneal):
    """The resampler on a training step's kind of inputs (proposal weights
    annealed to w ** 0.048, nerfacto's factor at step 5, many bins empty,
    stratified edges and u), where a cdf step of an empty bin is about 0.01
    / S of the total and divides any last-bit difference in the cdf: the
    port's plain version (sums in float64, in K1's order) against the JAX
    package's sample_pdf with the same draws (its XLA branch) and against
    its Pallas kernel in interpret mode, within TOL."""
    r = 48
    w, edges, draws = _training_resampler_inputs(rng, r, s, n, anneal)
    u = np.clip((np.arange(n, dtype=np.float32)[None] + draws) / n, 0, 1 - 1e-6).astype(np.float32)
    got = resample_edges_reference(_t(w), _t(edges), _t(u)).numpy()
    jb, tb = _bundles(rng, r)
    want_xla = jsamp.sample_pdf(jb, jnp.asarray(edges), jnp.asarray(w), n - 1, key=jax.random.PRNGKey(0))
    # the same function with our draws: replay them through the port's sampler
    port = tsamp.sample_pdf(tb, _t(edges), _t(w), n - 1, draws=_t(draws))
    np.testing.assert_array_equal(port.spacing_edges.numpy(), got)
    want = np.asarray(resample_edges_tpu(jnp.asarray(w), jnp.asarray(edges), jnp.asarray(u)))
    _close(got, want)
    # JAX's XLA branch on its own draws, against the port replaying them
    j_draws = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (r, n)))
    replay = tsamp.sample_pdf(tb, _t(edges), _t(w), n - 1, draws=_t(j_draws)).spacing_edges
    _close(replay, want_xla.spacing_edges)
    assert (w == 0).mean() > 0.05 and (np.diff(got, axis=1) >= 0).all()


@pytest.mark.parametrize("s", [1, 2, 24, 96, 128, 129, 256, 600, 4096])
def test_resample_cdf_is_correctly_rounded(rng, s):
    """The plain cdf (float64 sums in K1's association, one rounding to
    float32) equals the float64 cumsum rounded to float32 to within one
    ulp, and nearly everywhere exactly; K1's lane layout covers S."""
    from uncertainty_nerf_gs_torch.ops.pdf_resample import _k1_cdf, lane_layout

    r = 16
    w = (rng.uniform(0, 1, (r, s)) ** 4).astype(np.float32)
    w[3] = 0.0
    got = _k1_cdf(_t(w), 0.01, 1e-5).numpy()
    hp = np.float64(np.float32(0.01))
    pad = w.astype(np.float64) + hp
    exact = np.clip(np.cumsum(pad / pad.sum(1, keepdims=True), axis=1), 0, 1).astype(np.float32)
    assert got.shape == (r, s + 1) and (got[:, 0] == 0).all()
    diff = np.abs(got[:, 1:] - exact)
    assert (diff <= np.spacing(np.float32(1))).all()
    assert (diff == 0).mean() > 0.99
    per, tile = lane_layout(s)
    assert per in (4, 8) and tile == 32 * per and (per == 8) == (s > 128)


@pytest.mark.parametrize("shared", ["u", "s_edges", "both"])
def test_resample_reads_expanded_rows_in_place(rng, shared):
    """The eval path hands the resampler u, and the first stage's edges, as
    one row expanded over the rays (stride 0). The CPU branch takes them as
    they are and gives the same bits as on contiguous copies."""
    r, s, n = 9, 24, 13
    w = torch.from_numpy((rng.uniform(0, 1, (r, s)) ** 4).astype(np.float32))
    w[4] = 0.0
    edges = torch.from_numpy(np.sort(rng.uniform(0, 1, (r, s + 1)).astype(np.float32), axis=1))
    u = torch.from_numpy(rng.uniform(0, 1, (r, n)).astype(np.float32))
    if shared in ("u", "both"):
        u = u[:1].expand(r, n)
    if shared in ("s_edges", "both"):
        edges = edges[:1].expand(r, s + 1)
    assert 0 in u.stride() + edges.stride()
    got = resample_edges(w, edges, u)
    want = resample_edges(w, edges.contiguous(), u.contiguous())
    assert torch.equal(got, want)


# -- encodings ---------------------------------------------------------------


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
def test_sh_encoding(rng, levels):
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _close(tenc.sh_encoding(_t(d), levels), jenc.sh_encoding(jnp.asarray(d), levels))


def test_hash_grid_resolutions():
    for args in ((16, 16, 2048), (5, 16, 128), (5, 16, 256), (3, 16, 64), (1, 16, 16)):
        assert np.array_equal(
            tenc.hash_grid_resolutions(*args), jenc.hash_grid_resolutions(*args)
        )


@pytest.mark.parametrize(
    "res,log2_size",
    [(2048, 19), (111, 19), (80, 19), (128, 17), (37, 10), (8, 10)],
)
def test_cell_indices(rng, res, log2_size):
    """Dense levels (res^3 <= table) and hashed ones, the latter through the
    wrapping uint32 hash; positions include the cube's faces."""
    table = 2**log2_size
    p = rng.uniform(0, 1, (512, 3)).astype(np.float32)
    p[:8] = np.float32([[0, 0, 0], [1, 1, 1], [1, 0, 1], [0.5, 1, 0]] * 2)
    j_idx, j_w = jenc.cell_indices(jnp.asarray(p), res, table)
    t_idx, t_w = tenc.cell_indices(_t(p), res, table)
    assert np.array_equal(t_idx.numpy(), np.asarray(j_idx).astype(np.int64))
    assert t_idx.max() < table
    _close(t_w, j_w)


def test_cell_hash_encoding_matches_jax(rng):
    kw = dict(num_levels=6, min_res=16, max_res=512, log2_hashmap_size=12)
    enc = jenc.CellHashEncoding(**kw)
    p = rng.uniform(0, 1, (4, 64, 3)).astype(np.float32)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(p))
    cells = rng.uniform(-2, 2, params["params"]["cells"].shape).astype(np.float32)
    want = enc.apply({"params": {"cells": jnp.asarray(cells)}}, jnp.asarray(p))
    tmod = tenc.CellHashEncoding(**kw)
    assert tuple(tmod.cells.shape) == cells.shape
    tmod.load_state_dict({"cells": _t(cells)})
    got = tmod(_t(p))
    assert got.shape == (4, 64, 12)
    _close(got.detach(), want)
    # and against the functional lookup on the flat positions
    flat = jenc.cell_lookup(
        jnp.asarray(cells), jnp.asarray(p.reshape(-1, 3)),
        jenc.hash_grid_resolutions(6, 16, 512), 2**12,
    )
    _close(got.detach().reshape(-1, 12), flat)


def _face_positions(rng, res, n):
    """(n, 3) positions in [0, 1]: the cube's corners, rows on cell faces
    k / res of every level (in float32, as a caller computes them), and
    uniform draws."""
    p = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    rows = [[0, 0, 0], [1, 1, 1], [1, 0, 1], [0.5, 1, 0]]
    for r in res:
        k = rng.integers(0, int(r) + 1, (4, 3))
        rows += (k.astype(np.float32) / np.float32(r)).tolist()
    p[: len(rows)] = np.float32(rows)
    return p


@pytest.mark.parametrize("log2_size,max_res", [(12, 64), (15, 128), (10, 512)])
def test_cell_lookup_vjp_matches_jax(rng, log2_size, max_res):
    """cell_lookup through CellLookup (on the CPU: the plain version, and
    autograd through it) against jax.vjp of the JAX cell_lookup, on dense
    levels (res^3 <= table) and hashed ones, positions on corners and cell
    faces: features at TOL; the cell gradient level by level and the
    position gradient within GRID_GRAD_TOL of their largest entry."""
    levels = 4
    res = jenc.hash_grid_resolutions(levels, 16, max_res)
    table = 2**log2_size
    cells = rng.uniform(-2, 2, (levels, table // 8, 128)).astype(np.float32)
    p = _face_positions(rng, res, 400)
    g = rng.normal(size=(400, 2 * levels)).astype(np.float32)
    want, vjp = jax.vjp(
        lambda c, x: jenc.cell_lookup(c, x, res, table), jnp.asarray(cells), jnp.asarray(p)
    )
    want_cells, want_pos = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    tc, tp = _t(cells).requires_grad_(True), _t(p).requires_grad_(True)
    got = tenc.cell_lookup(tc, tp, res, table)
    got.backward(_t(g))
    _close(got.detach(), want)
    dense = [int(r) ** 3 <= table for r in res]
    assert any(dense) or log2_size == 10
    for lvl in range(levels):
        assert not grad_mismatch(tc.grad[lvl], _t(want_cells[lvl]), GRID_GRAD_TOL).any(), lvl
    assert not grad_mismatch(tp.grad, _t(want_pos), GRID_GRAD_TOL).any()
    assert np.abs(want_pos).max() > 0 and np.abs(want_cells).max() > 0


@pytest.mark.parametrize("features", [1, 2, 4])
@pytest.mark.parametrize("log2_size,max_res", [(12, 64), (15, 128)])
def test_cell_lookup_reference_sums_in_k4_tree(rng, features, log2_size, max_res):
    """cell_lookup_reference equals, bit for bit, a numpy float32 evaluation
    of K4's association on the JAX package's cells and weights: the corner
    products rounded in float32, then ((c0 + c1) + (c2 + c3)) + ((c4 + c5) +
    (c6 + c7)) by pairwise float32 adds. Dense and hashed levels, positions
    on corners and cell faces. The tree is not the left-to-right chain on
    these inputs, so the test tells the two apart."""
    levels = 4
    res = jenc.hash_grid_resolutions(levels, 16, max_res)
    table = 2**log2_size
    assert int(res[0]) ** 3 <= table < int(res[-1]) ** 3  # dense and hashed levels
    cells = rng.uniform(-2, 2, (levels, table * features // 16, 128)).astype(np.float32)
    p = _face_positions(rng, res, 400)
    got = tenc.cell_lookup_reference(_t(cells), _t(p), res, table, features).numpy()
    blocks = cells.reshape(levels, -1, 8, features)
    want, chain = [], []
    for lvl, r in enumerate(res):
        idx, w = jenc.cell_indices(jnp.asarray(p), int(r), table)
        prod = blocks[lvl][np.asarray(idx)] * np.asarray(w)[..., None]  # (n, 8, F) float32
        c = [prod[:, k] for k in range(8)]
        want.append(((c[0] + c[1]) + (c[2] + c[3])) + ((c[4] + c[5]) + (c[6] + c[7])))
        acc = c[0]
        for k in range(1, 8):
            acc = acc + c[k]
        chain.append(acc)
    want, chain = np.concatenate(want, -1), np.concatenate(chain, -1)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert not np.array_equal(chain, want)


@pytest.mark.parametrize("log2_size,max_res,levels", [(12, 64, 4), (15, 128, 5), (10, 512, 16)])
def test_cell_keys_reference_matches_jax(rng, log2_size, max_res, levels):
    """K5's keys: lookup (i, l) at i * L + l holds l << cell_bits | idx,
    idx the JAX package's cell_indices level by level; the packing leaves
    the top bit free and sorts level-major, then by cell (a stable sort of
    the keys is the lexicographic order of (level, cell, lookup))."""
    res = jenc.hash_grid_resolutions(levels, 16, max_res)
    table = 2**log2_size
    p = _face_positions(rng, res, 300)
    keys = tenc.cell_keys_reference(_t(p), res, table)
    cell_bits, bits = tenc.key_bits(levels, table)
    assert keys.dtype == torch.int64 and keys.shape == (300 * levels,)
    assert cell_bits == log2_size and bits <= tenc.MAX_KEY_BITS and int(keys.max()) < 2**bits
    grid = keys.reshape(300, levels)
    for lvl, r in enumerate(res):
        j_idx, _ = jenc.cell_indices(jnp.asarray(p), int(r), table)
        assert np.array_equal((grid[:, lvl] >> cell_bits).numpy(), np.full(300, lvl))
        assert np.array_equal((grid[:, lvl] & (2**cell_bits - 1)).numpy(), np.asarray(j_idx).astype(np.int64))
    level = np.tile(np.arange(levels), 300)
    cell = (keys & (2**cell_bits - 1)).numpy()
    order = np.lexsort((np.arange(keys.numel()), cell, level))
    assert np.array_equal(torch.sort(keys, stable=True).indices.numpy(), order)


@pytest.mark.parametrize("log2_size,max_res", [(12, 64), (15, 128), (10, 512)])
def test_cell_lookup_vjp_reference_matches_jax(rng, log2_size, max_res):
    """The plain backward K5 is held against on the card,
    ``cell_lookup_vjp_reference``, called directly, against jax.vjp of the
    JAX cell_lookup: the cell gradient level by level and the position
    gradient within GRID_GRAD_TOL; without the position gradient it gives
    the same cell gradient and None."""
    levels = 4
    res = jenc.hash_grid_resolutions(levels, 16, max_res)
    table = 2**log2_size
    cells = rng.uniform(-2, 2, (levels, table // 8, 128)).astype(np.float32)
    p = _face_positions(rng, res, 400)
    g = rng.normal(size=(400, 2 * levels)).astype(np.float32)
    _, vjp = jax.vjp(lambda c, x: jenc.cell_lookup(c, x, res, table), jnp.asarray(cells), jnp.asarray(p))
    want_cells, want_pos = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    g_cells, g_pos = tenc.cell_lookup_vjp_reference(_t(cells), _t(p), res, table, 2, _t(g))
    for lvl in range(levels):
        assert not grad_mismatch(g_cells[lvl], _t(want_cells[lvl]), GRID_GRAD_TOL).any(), lvl
    assert not grad_mismatch(g_pos, _t(want_pos), GRID_GRAD_TOL).any()
    only, none = tenc.cell_lookup_vjp_reference(_t(cells), _t(p), res, table, 2, _t(g), False)
    assert none is None and torch.equal(only, g_cells)


def test_take_rows_matches_gather(rng):
    """``raymarch.take_rows`` (the interlevel loss's gather, whose backward
    adds in a fixed order on the card) equals torch.gather in value and
    gradient, repeated indices included, with leading batch dimensions."""
    values = _t(rng.normal(size=(2, 5, 9)).astype(np.float32))
    idx = torch.from_numpy(np.sort(rng.integers(0, 9, (2, 5, 7)), axis=-1))
    g = _t(rng.normal(size=(2, 5, 7)).astype(np.float32))
    a, b = values.clone().requires_grad_(True), values.clone().requires_grad_(True)
    got, want = trm.take_rows(a, idx), torch.gather(b, -1, idx)
    assert torch.equal(got, want)
    got.backward(g)
    want.backward(g)
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-6)


# -- mlp ---------------------------------------------------------------------


@pytest.mark.parametrize("skips,out_act", [((), None), ((2,), "relu")])
def test_mlp(rng, skips, out_act):
    x = rng.normal(size=(2, 50, 10)).astype(np.float32)
    jm = JMLP(
        num_layers=4, layer_width=32, out_dim=5, skip_connections=skips,
        out_activation=jax.nn.relu if out_act else None,
    )
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.4).astype(np.float32),
        params,
    )
    tm = TMLP(
        10, num_layers=4, layer_width=32, out_dim=5, skip_connections=skips,
        out_activation=torch.relu if out_act else None,
    )
    tm.load_state_dict(params_from_jax(params))
    _close(tm(_t(x)).detach(), jm.apply({"params": params}, jnp.asarray(x)))


def test_mlp_refuses_unported_options():
    """Dropout and bf16 compute are ported (tests/test_torch_mcdropout.py);
    what the MLP still refuses: a dropout rate outside [0, 1), and masks of
    another shape or dtype than the layer input's, or a Dropout with both
    or neither of a generator and masks."""
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError):
            TMLP(4, 2, 8, 1, dropout_layers=(-1,), dropout_rate=rate)
    m = TMLP(4, 2, 8, 1, dropout_layers=(-1,), dropout_rate=0.2, compute_dtype=torch.bfloat16)
    x = torch.ones(3, 4)
    for masks in ({"1": torch.ones(3, 7, dtype=torch.bool)}, {"1": torch.ones(3, 8)}):
        with pytest.raises(ValueError):
            m(x, Dropout(masks=masks))
    for kw in ({}, dict(generator=torch.Generator(), masks={})):
        with pytest.raises(ValueError):
            Dropout(**kw)
    assert m(x, Dropout(masks={"1": torch.ones(3, 8, dtype=torch.bool)})).dtype == torch.float32


# -- raymarch ----------------------------------------------------------------


def _march_inputs(rng, r=128, s=48):
    dens = (rng.uniform(0, 1, (r, s)) ** 3 * 60).astype(np.float32)
    t = np.sort(rng.uniform(0.05, 6.0, (r, s + 1)).astype(np.float32), axis=1)
    deltas = np.diff(t, axis=1)
    steps = 0.5 * (t[:, 1:] + t[:, :-1])
    rgbs = rng.uniform(0, 1, (r, s, 3)).astype(np.float32)
    betas = rng.uniform(0.01, 1, (r, s)).astype(np.float32)
    return dens, deltas, steps, rgbs, betas


def test_raymarch_renderers(rng):
    dens, deltas, steps, rgbs, betas = _march_inputs(rng)
    jw = jrm.render_weights(jnp.asarray(dens), jnp.asarray(deltas))
    tw = trm.render_weights(_t(dens), _t(deltas))
    _close(tw, jw)
    # downstream renderers on identical weights
    w = np.asarray(jw)
    jw, tw = jnp.asarray(w), _t(w)
    bg = np.float32([1.0, 0.5, 0.0])
    _close(trm.render_rgb(tw, _t(rgbs)), jrm.render_rgb(jw, jnp.asarray(rgbs)))
    _close(
        trm.render_rgb(tw, _t(rgbs), _t(bg)),
        jrm.render_rgb(jw, jnp.asarray(rgbs), jnp.asarray(bg)),
    )
    _close(trm.render_accumulation(tw), jrm.render_accumulation(jw))
    _close(
        trm.render_expected_depth(tw, _t(steps)),
        jrm.render_expected_depth(jw, jnp.asarray(steps)),
    )
    _close(
        trm.render_uncertainty(_t(betas), tw**2),
        jrm.render_uncertainty(jnp.asarray(betas), jw**2),
    )
    depth = np.asarray(jrm.render_median_depth(jw, jnp.asarray(steps)))
    _close(
        trm.depth_variance(tw, _t(steps), _t(depth)),
        jrm.depth_variance(jw, jnp.asarray(steps), jnp.asarray(depth)),
    )


def _loss_inputs(rng, r=64):
    """Final s-edges (R, 49) that share some edges with the first
    proposal's (R, 257), both sorted in [0, 1], and peaked weights."""
    prop = [np.sort(rng.uniform(0, 1, (r, n + 1)), axis=1).astype(np.float32) for n in (256, 96)]
    for e in prop:
        e[:, 0], e[:, -1] = 0.0, 1.0
    final = np.sort(rng.uniform(0, 1, (r, 49)), axis=1).astype(np.float32)
    final[:, 0], final[:, -1] = 0.0, 1.0
    final[:, 10:20] = prop[0][:, 100:110]  # ties: searchsorted's sides matter
    final = np.sort(final, axis=1)
    weights = [(rng.uniform(0, 1, (r, e.shape[1] - 1)) ** 4 / 8).astype(np.float32)
               for e in prop + [final]]
    return prop + [final], weights


def _interlevel_rounding_bar(sdists, weights, eps=1e-7):
    """Per proposal weight, how far the interlevel gradient moves when each
    envelope mass w_outer (a difference of two cumsum entries) moves by one
    rounding of the cumsum, 2^-23 of its largest entry: the gradient of
    sum_i 2 u / (w_i + eps) / N * w_outer_i. Where a final weight w_i is
    tiny, a one-ulp difference between two summation orders moves that
    bin's term by this much in either package."""
    final, w = _t(sdists[-1]), _t(weights[-1])
    bars = []
    for cp, wp in zip(sdists[:-1], weights[:-1]):
        wp = _t(wp).requires_grad_(True)
        u = 2.0**-23 * float(wp.detach().sum(-1).max())
        outer = trm._outer_measure(final, _t(cp), wp)
        (torch.sum(2 * u / (w + eps) / w.numel() * outer)).backward()
        bars.append(wp.grad.numpy())
    return bars


def test_interlevel_and_distortion_losses_match_jax(rng):
    """Values at TOL, on edges with ties. Gradients to every weight (the
    final weights get none from the interlevel loss) at TOL, the interlevel
    gradient plus twice its cumsum-rounding bar (one rounding in each
    package; ``_interlevel_rounding_bar``)."""
    sdists, weights = _loss_inputs(rng)
    bars = _interlevel_rounding_bar(sdists, weights) + [0.0]

    def j_losses(ws):
        inter = jrm.interlevel_loss(jnp.asarray(sdists[-1]), ws[-1], [jnp.asarray(e) for e in sdists[:-1]], ws[:-1])
        return inter, jrm.distortion_loss(jnp.asarray(sdists[-1]), ws[-1])

    jw = [jnp.asarray(w) for w in weights]
    want = j_losses(jw)
    tw = [_t(w).requires_grad_(True) for w in weights]
    ts = [_t(e) for e in sdists]
    got = (trm.interlevel_loss(ts[-1], tw[-1], ts[:-1], tw[:-1]), trm.distortion_loss(ts[-1], tw[-1]))
    for k in range(2):
        _close(got[k].detach(), want[k])
        want_g = jax.grad(lambda ws: j_losses(ws)[k])(jw)
        got_g = torch.autograd.grad(got[k], tw, allow_unused=True, retain_graph=True)
        for a, b, bar in zip(got_g, want_g, bars if k == 0 else [0.0] * 3):
            a = np.zeros(b.shape, np.float32) if a is None else a.numpy()
            b = np.asarray(b)
            assert (np.abs(a - b) <= TOL["atol"] + TOL["rtol"] * np.abs(b) + 2 * bar).all()
    assert float(got[0]) > 0 and float(got[1]) > 0


def test_render_median_depth(rng):
    """searchsorted side='left' on the cumulative weight at 0.5. A ray whose
    cumulative weight lies within 1e-6 of 0.5 may pick the next bin under
    another summation order; such rays are excluded and counted (none with
    this seed); every other ray must be exactly equal."""
    dens, deltas, steps, _, _ = _march_inputs(rng, r=256)
    w = np.array(jrm.render_weights(jnp.asarray(dens), jnp.asarray(deltas)))
    w[0] = 0.0  # never reaches 0.5: clipped to the last step
    w[1] = 0.0
    w[1, 10] = 0.5  # reaches 0.5 exactly at bin 10 (side='left')
    want = np.asarray(jrm.render_median_depth(jnp.asarray(w), jnp.asarray(steps)))
    got = trm.render_median_depth(_t(w), _t(steps)).numpy()
    ties = (np.abs(np.cumsum(w, axis=1) - 0.5) < 1e-6).any(axis=1)
    ties[:2] = False
    assert ties.sum() == 0
    assert np.array_equal(got[~ties], want[~ties])
    assert got[0] == steps[0, -1] and got[1] == steps[1, 10]


# -- cameras -----------------------------------------------------------------


def _camera_pair(camera_type=0, distortion=None):
    jc = j_hemisphere(3, height=10, width=12, seed=2)
    tc = t_hemisphere(3, height=10, width=12, seed=2)
    assert np.array_equal(tc.camera_to_worlds.numpy(), np.asarray(jc.camera_to_worlds))
    for name in ("fx", "fy", "cx", "cy"):
        assert np.array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)))
    if distortion is not None:
        jc = jc.replace(distortion_params=jnp.asarray(distortion))
        tc = tcam.Cameras(**{**tc.__dict__, "distortion_params": _t(distortion)})
    if camera_type:
        jc = jc.replace(camera_type=camera_type)
        tc = tcam.Cameras(**{**tc.__dict__, "camera_type": camera_type})
    return jc, tc


@pytest.mark.parametrize("kind", ["perspective", "distorted", "fisheye"])
def test_generate_rays(rng, kind):
    distortion = None
    if kind == "distorted":
        distortion = np.tile(np.float32([[0.05, -0.02, 0.01, 0.0, 0.001, -0.002]]), (3, 1))
    jc, tc = _camera_pair(1 if kind == "fisheye" else 0, distortion)
    px, py = jcam.pixel_grid(10, 12)
    tpx, tpy = tcam.pixel_grid(10, 12)
    assert np.array_equal(tpx.numpy(), np.asarray(px))
    assert np.array_equal(tpy.numpy(), np.asarray(py))
    idx = rng.integers(0, 3, px.shape[0]).astype(np.int32)
    want = jcam.generate_rays(jc, jnp.asarray(idx), px, py)
    got = tcam.generate_rays(tc, _t(idx), tpx, tpy)
    for name in ("origins", "directions", "nears", "fars"):
        _close(getattr(got, name), getattr(want, name))
    assert np.array_equal(got.camera_indices.numpy(), idx)


def _lie_tangents(rng, kind):
    if kind == "zero":
        return np.zeros((5, 6), np.float32)
    scale = 1e-9 if kind == "tiny" else 0.7  # tiny: the Taylor branches
    return (rng.normal(size=(5, 6)) * scale).astype(np.float32)


@pytest.mark.parametrize("kind", ["zero", "tiny", "random"])
def test_lie_maps_match_jax(rng, kind):
    """exp_map_SO3, exp_map_SO3xR3, exp_map_SE3 and compose_poses: values
    and Jacobians at TOL, at exactly zero (the camera tangents' start, where
    a bare norm has a NaN gradient), below the Taylor threshold and at random
    tangents; every Jacobian finite."""
    x = _lie_tangents(rng, kind)
    pose = np.concatenate(
        [np.asarray(jlie.exp_map_SO3(jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32)))),
         rng.normal(size=(5, 3, 1)).astype(np.float32)], axis=-1)
    pairs = [
        (lambda a: jlie.exp_map_SO3(a[:, 3:]), lambda a: tlie.exp_map_SO3(a[:, 3:])),
        (jlie.exp_map_SO3xR3, tlie.exp_map_SO3xR3),
        (jlie.exp_map_SE3, tlie.exp_map_SE3),
        (lambda a: jlie.compose_poses(jlie.exp_map_SO3xR3(a), jnp.asarray(pose)),
         lambda a: tlie.compose_poses(tlie.exp_map_SO3xR3(a), _t(pose))),
    ]
    for jfn, tfn in pairs:
        _close(tfn(_t(x)), jfn(jnp.asarray(x)))
        want = np.asarray(jax.jacfwd(jfn)(jnp.asarray(x)))
        got = torch.autograd.functional.jacobian(tfn, _t(x)).numpy()
        assert np.isfinite(got).all()
        _close(got, want)


@pytest.mark.parametrize("tangents", ["zero", "random"])
@pytest.mark.parametrize("mode", ["SO3xR3", "SE3"])
def test_generate_rays_pose_adjustment_matches_jax(rng, mode, tangents):
    """Rays from pose-adjusted cameras and the gradient of a random
    cotangent of origins and directions to the (N, 6) tangents, at TOL."""
    jc, tc = _camera_pair()
    adj = _lie_tangents(rng, "zero" if tangents == "zero" else "random")[:3] * 0.1
    px, py = jcam.pixel_grid(10, 12)
    idx = rng.integers(0, 3, px.shape[0]).astype(np.int32)
    go = rng.normal(size=(px.shape[0], 3)).astype(np.float32)
    gd = rng.normal(size=(px.shape[0], 3)).astype(np.float32)

    def j_rays(a):
        rb = jcam.generate_rays(jc, jnp.asarray(idx), px, py, pose_adjustment=a,
                                pose_adjustment_mode=mode)
        return rb.origins, rb.directions

    want, vjp = jax.vjp(j_rays, jnp.asarray(adj))
    (want_g,) = vjp((jnp.asarray(go), jnp.asarray(gd)))
    ta = _t(adj).requires_grad_(True)
    tpx, tpy = tcam.pixel_grid(10, 12)
    got = tcam.generate_rays(tc, _t(idx), tpx, tpy, pose_adjustment=ta, pose_adjustment_mode=mode)
    _close(got.origins.detach(), want[0])
    _close(got.directions.detach(), want[1])
    (torch.sum(got.origins * _t(go)) + torch.sum(got.directions * _t(gd))).backward()
    assert torch.isfinite(ta.grad).all() and ta.grad.abs().max() > 0
    _close(ta.grad, want_g)
