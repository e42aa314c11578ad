"""Parity of the PyTorch port's ops against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both packages; tolerances are stated
in tests/torch_parity.py (``TOL``: atol 2e-5, rtol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import TOL

from uncertainty_nerf_gs_tpu.cameras import cameras as jcam
from uncertainty_nerf_gs_tpu.data.synthetic import hemisphere_cameras as j_hemisphere
from uncertainty_nerf_gs_tpu.ops import activations as jact
from uncertainty_nerf_gs_tpu.ops import encodings as jenc
from uncertainty_nerf_gs_tpu.ops import raymarch as jrm
from uncertainty_nerf_gs_tpu.ops import sampling as jsamp
from uncertainty_nerf_gs_tpu.ops import spatial as jsp
from uncertainty_nerf_gs_tpu.ops.mlp import MLP as JMLP
from uncertainty_nerf_gs_tpu.ops.pdf_pallas import resample_edges_tpu

from uncertainty_nerf_gs_torch.cameras import cameras as tcam
from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras as t_hemisphere
from uncertainty_nerf_gs_torch.interop import params_from_jax
from uncertainty_nerf_gs_torch.ops import activations as tact
from uncertainty_nerf_gs_torch.ops import encodings as tenc
from uncertainty_nerf_gs_torch.ops import raymarch as trm
from uncertainty_nerf_gs_torch.ops import sampling as tsamp
from uncertainty_nerf_gs_torch.ops import spatial as tsp
from uncertainty_nerf_gs_torch.ops.mlp import MLP as TMLP
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
    _, tb = _bundles(rng, 16)
    gen = torch.Generator().manual_seed(3)
    rs = tsamp.sample_uniform(tb, 64, generator=gen)
    edges = rs.spacing_edges
    assert (edges[:, 0] >= 0).all() and (edges[:, -1] <= 1).all()
    assert (torch.diff(edges, dim=1) >= 0).all()
    centred = tsamp.sample_uniform(tb, 64).spacing_edges
    assert not torch.equal(edges, centred)


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
    with pytest.raises(NotImplementedError):
        TMLP(4, 2, 8, 1, dropout_layers=(-1,), dropout_rate=0.2)
    with pytest.raises(NotImplementedError):
        TMLP(4, 2, 8, 1, compute_dtype=torch.bfloat16)


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


def test_generate_rays_refuses_pose_adjustment():
    _, tc = _camera_pair()
    with pytest.raises(NotImplementedError):
        tcam.generate_rays(
            tc, torch.zeros(2, dtype=torch.long), torch.zeros(2), torch.zeros(2),
            pose_adjustment=torch.zeros(3, 6),
        )
