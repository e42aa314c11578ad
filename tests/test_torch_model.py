"""Parity of the port's field, model and serving path against the JAX
package, on the CPU, on shared weights (``interop.params_from_jax``).

Tolerances and the rule for rays whose samples crossed a hash-grid cell face
are stated in tests/torch_parity.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    MAX_FLIPPED_RAY_SHARE,
    OUTPUT_TOLS,
    TOL,
    draw_params,
    lookup_cells_jax,
    ray_mismatch,
    rays,
    small_config_kwargs,
)

from uncertainty_nerf_gs_tpu.cameras import cameras as jcam
from uncertainty_nerf_gs_tpu.data.synthetic import hemisphere_cameras as j_hemisphere
from uncertainty_nerf_gs_tpu.engine.trainer import NerfactoTrainer as JTrainer
from uncertainty_nerf_gs_tpu.fields.nerfacto_field import (
    NerfactoField as JField,
    ProposalDensityField as JProposal,
)
from uncertainty_nerf_gs_tpu.models.nerfacto import (
    NerfactoConfig as JConfig,
    NerfactoModel as JModel,
)
from uncertainty_nerf_gs_tpu.ops.sampling import RayBundle as JBundle

from uncertainty_nerf_gs_torch.cameras import cameras as tcam
from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras as t_hemisphere
from uncertainty_nerf_gs_torch.engine.trainer import NerfactoTrainer as TTrainer
from uncertainty_nerf_gs_torch.fields.nerfacto_field import (
    NerfactoField as TField,
    ProposalDensityField as TProposal,
)
from uncertainty_nerf_gs_torch.interop import params_from_jax, params_to_jax
from uncertainty_nerf_gs_torch.models.nerfacto import (
    NerfactoConfig as TConfig,
    NerfactoModel as TModel,
)
from uncertainty_nerf_gs_torch.ops.sampling import RayBundle as TBundle

OUTPUT_KEYS = tuple(OUTPUT_TOLS)


def _bundles(o, d, ci):
    n = o.shape[0]
    jb = JBundle(
        jnp.asarray(o), jnp.asarray(d), jnp.zeros(n), jnp.ones(n), jnp.asarray(ci)
    )
    tb = TBundle(
        torch.from_numpy(o), torch.from_numpy(d), torch.zeros(n), torch.ones(n),
        torch.from_numpy(ci).long(),
    )
    return jb, tb


def _jax_tree(module, *args, **kwargs):
    params = module.init(jax.random.PRNGKey(0), *args, **kwargs)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _shapes(tree):
    return jax.tree_util.tree_map(np.shape, tree)


def _model_pair(rng, **overrides):
    kw = small_config_kwargs(**overrides)
    o, d, ci = rays(rng, 4)
    jb, _ = _bundles(o, d, ci)
    jmodel = JModel(JConfig(**kw))
    tree = draw_params(_jax_tree(jmodel, jb), rng)
    tmodel = TModel(TConfig(**kw), device="cpu")
    tmodel.load_state_dict(params_from_jax(tree), strict=True)
    return jmodel, tmodel, tree


def test_params_round_trip_bit_exact(rng):
    jmodel, tmodel, tree = _model_pair(rng)
    # the torch model's own tree has the flax tree's structure and shapes
    assert _shapes(params_to_jax(TModel(TConfig(**small_config_kwargs()), device="cpu").state_dict())) == _shapes(tree)
    back = params_to_jax(tmodel.state_dict())
    assert _shapes(back) == _shapes(tree)
    for (path, a), b in zip(
        jax.tree_util.tree_leaves_with_path(tree), jax.tree_util.tree_leaves(back)
    ):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


def test_fields_match_jax(rng):
    """NerfactoField (with the aleatoric head) and the hash proposal field on
    shared weights and positions, at the module tolerance."""
    p = (rng.normal(size=(16, 24, 3)) * 1.5).astype(np.float32)
    o, d, ci = rays(rng, 16)
    jf = JField(num_images=3, num_levels=4, max_res=256, log2_hashmap_size=10,
                num_uncertainty_channels=1)
    tree = draw_params(_jax_tree(jf, jnp.asarray(p), jnp.asarray(d), jnp.asarray(ci)), rng)
    want = jf.apply({"params": tree}, jnp.asarray(p), jnp.asarray(d), jnp.asarray(ci))
    tf = TField(num_images=3, num_levels=4, max_res=256, log2_hashmap_size=10,
                num_uncertainty_channels=1, device="cpu")
    tf.load_state_dict(params_from_jax(tree), strict=True)
    with torch.no_grad():
        got = tf(torch.from_numpy(p), torch.from_numpy(d), torch.from_numpy(ci).long())
    for name in ("density", "rgb", "uncertainty", "density_before_activation",
                 "trunk", "color_penultimate"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=name, **TOL,
        )
    with torch.no_grad():
        avg = tf(torch.from_numpy(p), torch.from_numpy(d), torch.from_numpy(ci).long(),
                 use_average_appearance=True)
    want_avg = jf.apply({"params": tree}, jnp.asarray(p), jnp.asarray(d),
                        jnp.asarray(ci), use_average_appearance=True)
    np.testing.assert_allclose(avg.rgb.numpy(), np.asarray(want_avg.rgb), **TOL)

    jp = JProposal(num_levels=3, max_res=128, log2_hashmap_size=10)
    ptree = draw_params(_jax_tree(jp, jnp.asarray(p)), rng)
    tp = TProposal(num_levels=3, max_res=128, log2_hashmap_size=10, device="cpu")
    tp.load_state_dict(params_from_jax(ptree), strict=True)
    with torch.no_grad():
        got_d = tp(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(
        got_d, np.asarray(jp.apply({"params": ptree}, jnp.asarray(p))), **TOL
    )


def _flipped(jconfig, jb, j_sdist, tmodel, tb, t_sdist) -> np.ndarray:
    """(R,) bool: rays one of whose hash-grid lookups landed in another cell
    in the two packages (see tests/torch_parity.py)."""
    want = lookup_cells_jax(jconfig, jb, j_sdist)
    got = tmodel.lookup_cells(tb, t_sdist).numpy()
    assert want.shape == got.shape
    return (want != got).any(axis=1)


@pytest.mark.parametrize("background", ["white", "last_sample"])
def test_model_eval_forward_matches_jax(rng, background):
    """Eval forward (proposal 256 -> pdf 96 -> pdf 48 -> field) on shared
    weights and rays: every output within OUTPUT_TOLS on every ray none of
    whose lookups crossed a cell face between the packages; those rays are
    counted and bounded by MAX_FLIPPED_RAY_SHARE."""
    jmodel, tmodel, tree = _model_pair(rng, background_color=background)
    o, d, ci = rays(rng, 256)
    jb, tb = _bundles(o, d, ci)
    want = {k: np.asarray(v) for k, v in jmodel.apply({"params": tree}, jb).items()}
    # the same eager forward, with the sample edges each field was queried at
    j_sdist = jmodel.apply({"params": tree}, jb, train=True)["sdist_list"]
    t_all = tmodel(tb, return_intermediates=True)
    got = {k: v.numpy() for k, v in tmodel(tb).items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and np.isfinite(got[k]).all(), k
        assert np.array_equal(t_all[k].numpy(), got[k]), k
    # the test exercises peaked weights, not a near-empty field
    assert (want["accumulation"] > 0.5).mean() > 0.25
    flipped = _flipped(jmodel.config, jb, j_sdist, tmodel, tb, t_all["sdist_list"])
    assert flipped.mean() <= MAX_FLIPPED_RAY_SHARE, f"{flipped.sum()} of 256 rays flipped"
    bad = ray_mismatch(want, got)
    assert not (bad & ~flipped).any(), (
        f"{(bad & ~flipped).sum()} unflipped rays differ "
        f"({flipped.sum()} of 256 rays excluded as flipped)"
    )
    # a mean over every sample, flipped rays included: a flipped sample moves
    # it by about 0.01 * density / (256 * 48)
    np.testing.assert_allclose(got["density_mean"], want["density_mean"], rtol=1e-3)


def test_render_image_matches_jax(rng):
    """NerfactoTrainer.render_image on a 10x12 camera in chunks of 48 rays
    (120 pixels: the last chunk is padded with pixel (0, 0)). Excluded are
    the rays that flipped a cell between the port and the JAX package's
    eager forward, and those where the JAX package's jitted render
    disagrees with its own eager forward; every other pixel must meet
    OUTPUT_TOLS against the JAX render."""
    kw = small_config_kwargs()
    chunk = 48
    jcams = j_hemisphere(3, height=10, width=12, seed=1)
    jtr = JTrainer(JConfig(**kw), jcams, np.zeros((3, 10, 12, 3), np.float32))
    tree = draw_params(jax.tree_util.tree_map(np.asarray, jtr.state.params), rng)
    jtr.state = jtr.state._replace(params=jax.tree_util.tree_map(jnp.asarray, tree))
    ttr = TTrainer(TConfig(**kw), t_hemisphere(3, height=10, width=12, seed=1), device="cpu")
    ttr.restore({"params": params_from_jax(tree)})
    want = jtr.render_image(1, chunk=chunk)
    got = ttr.render_image(1, chunk=chunk)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape == (10, 12) + want[k].shape[2:], k

    # the same chunks, eager in JAX and with their sample edges in both
    px, py = jcam.pixel_grid(10, 12)
    px = np.concatenate([np.asarray(px), np.zeros(24, np.float32)])
    py = np.concatenate([np.asarray(py), np.zeros(24, np.float32)])
    idx = np.full(144, 1, np.int32)
    eager, flipped = [], []
    for s in range(0, 144, chunk):
        sl = slice(s, s + chunk)
        jb = jcam.generate_rays(jcams, jnp.asarray(idx[sl]), jnp.asarray(px[sl]), jnp.asarray(py[sl]))
        tb = tcam.generate_rays(
            ttr.cameras, torch.from_numpy(idx[sl]), torch.from_numpy(px[sl]),
            torch.from_numpy(py[sl]),
        )
        j_out = jtr.model.apply({"params": tree}, jb, train=True)
        t_out = ttr.model(tb, return_intermediates=True)
        eager.append({k: np.asarray(j_out[k]) for k in OUTPUT_KEYS})
        flipped.append(
            _flipped(jtr.model.config, jb, j_out["sdist_list"], ttr.model, tb, t_out["sdist_list"])
        )
    eager = {k: np.concatenate([e[k] for e in eager])[:120] for k in OUTPUT_KEYS}
    flipped = np.concatenate(flipped)[:120]
    flat = lambda m: {k: np.asarray(m[k]).reshape(120, -1) for k in OUTPUT_KEYS}
    self_disagree = ray_mismatch(flat(eager), flat(want))
    excluded = flipped | self_disagree
    assert excluded.mean() <= MAX_FLIPPED_RAY_SHARE, (
        f"{flipped.sum()} flipped, {self_disagree.sum()} where the JAX render "
        "disagrees with itself, of 120 rays"
    )
    bad = ray_mismatch(flat(want), flat(got))
    assert not (bad & ~excluded).any(), (
        f"{(bad & ~excluded).sum()} pixels differ ({excluded.sum()} of 120 excluded)"
    )
