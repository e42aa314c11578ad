"""nerfacto-laplace, port against the JAX package on the CPU: the diagonal
GGN fit (``fit_laplace``) over the same batches, ``laplace_render`` on
JAX's own posterior with JAX's normal draws replayed from
``jax.random.split(key, 3)``, the full-covariance fit and its joint draws,
the posterior converter, and the eval chunk renderer's Laplace branch.
Rays one of whose lookups crossed a hash-grid cell face between the
packages are left out of the batches (their trunk features differ by the
table's scale). Tolerances are stated in tests/torch_parity.py."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _trainer_pair
from torch_parity import (
    LAPLACE_GGN_TOL,
    MAX_FLIPPED_RAY_SHARE,
    MOMENT_TOL,
    OUTPUT_TOLS,
    TOL,
    draw_params,
    lookup_cells_jax,
    ray_mismatch,
    rays,
    small_config_kwargs,
)

from uncertainty_nerf_gs_tpu.cameras.cameras import generate_rays as j_generate_rays
from uncertainty_nerf_gs_tpu.models import laplace as jl
from uncertainty_nerf_gs_tpu.models.nerfacto import NerfactoConfig as JConfig
from uncertainty_nerf_gs_tpu.models.nerfacto import NerfactoModel as JModel
from uncertainty_nerf_gs_tpu.ops.sampling import RayBundle as JBundle
from uncertainty_nerf_gs_tpu.scripts import eval_uncertainty as j_eval

from uncertainty_nerf_gs_torch import interop
from uncertainty_nerf_gs_torch.cameras.cameras import generate_rays as t_generate_rays
from uncertainty_nerf_gs_torch.models import laplace as tl
from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig as TConfig
from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoModel as TModel
from uncertainty_nerf_gs_torch.ops.sampling import RayBundle as TBundle
from uncertainty_nerf_gs_torch.scripts import eval_uncertainty as t_eval

# methods.py's nerfacto-laplace: softplus density
LAPLACE_KW = dict(density_activation="softplus")


def _bundles(o, d, ci):
    n = o.shape[0]
    jb = JBundle(jnp.asarray(o), jnp.asarray(d), jnp.zeros(n), jnp.ones(n), jnp.asarray(ci))
    tb = TBundle(torch.from_numpy(o), torch.from_numpy(d), torch.zeros(n), torch.ones(n),
                 torch.from_numpy(ci).long())
    return jb, tb


def _model_pair(rng, **overrides):
    kw = small_config_kwargs(**{**LAPLACE_KW, **overrides})
    jb, _ = _bundles(*rays(rng, 4))
    jmodel = JModel(JConfig(**kw))
    tree = draw_params(jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jb)["params"]), rng)
    tmodel = TModel(TConfig(**kw), device="cpu")
    tmodel.load_state_dict(interop.params_from_jax(tree), strict=True)
    return jmodel, tmodel, tree


def _steady_rays(rng, jmodel, tmodel, tree, n):
    """n rays none of whose lookups flips a cell between the packages."""
    o, d, ci = rays(rng, 2 * n)
    jb, tb = _bundles(o, d, ci)
    j_sdist = jmodel.apply({"params": tree}, jb, train=True)["sdist_list"]
    t_sdist = tmodel(tb, return_intermediates=True)["sdist_list"]
    keep = ~(lookup_cells_jax(jmodel.config, jb, j_sdist) != tmodel.lookup_cells(tb, t_sdist).numpy()).any(1)
    assert keep.mean() >= 1 - MAX_FLIPPED_RAY_SHARE and keep.sum() >= n
    idx = np.flatnonzero(keep)[:n]
    return o[idx], d[idx], ci[idx]


def _batches(rng, jmodel, tmodel, tree, count, n=48):
    batches = [_bundles(*_steady_rays(rng, jmodel, tmodel, tree, n)) for _ in range(count)]
    return [b[0] for b in batches], [b[1] for b in batches]


def _posterior_close(got: tl.LaplacePosterior, want: jl.LaplacePosterior) -> None:
    back = interop.laplace_posterior_to_jax(got)
    for head in ("density_head", "rgb_head"):
        for leaf in ("kernel", "bias"):
            w = np.asarray(getattr(want, head)[leaf])
            np.testing.assert_allclose(back[head][leaf], w, atol=LAPLACE_GGN_TOL["atol"] * np.abs(w).max(),
                                       rtol=LAPLACE_GGN_TOL["rtol"], err_msg=f"{head}.{leaf}")


def fit_pair(rng, activation):
    """``fit_laplace`` in both packages over three batches of the same
    steady rays: (port posterior, JAX posterior)."""
    jmodel, tmodel, tree = _model_pair(rng, density_activation=activation)
    jbs, tbs = _batches(rng, jmodel, tmodel, tree, 3)
    want = jl.fit_laplace(jmodel, tree, lambda i: jbs[i], jmodel.config, n_iters=3)
    return tl.fit_laplace(tmodel, lambda i: tbs[i], tmodel.config, n_iters=3), want


@pytest.mark.parametrize("activation", ["softplus", "trunc_exp"])
def test_fit_laplace_matches_jax(rng, activation):
    """The diagonal GGN (scale 2, sum over rays and channels) over three
    batches of the same rays within LAPLACE_GGN_TOL, leaf by leaf; with
    trunc_exp too (its autograd Function runs under torch.func)."""
    got, want = fit_pair(rng, activation)
    _posterior_close(got, want)
    assert float(got.rgb_head["weight"].max()) > 0


def _jax_noise(key, shape, n_samples, n_draws):
    """JAX's laplace_render draws for its key, in laplace_draws' layout."""
    k_density, k_rgb, k_draws = jax.random.split(key, 3)
    return {"density": torch.from_numpy(np.array(jax.random.normal(k_density, (n_samples,) + shape))),
            "rgb": torch.from_numpy(np.array(jax.random.normal(k_rgb, (n_samples,) + shape + (3,)))),
            "draws": torch.from_numpy(np.array(jax.random.normal(k_draws, (n_draws,) + shape)))}


@pytest.mark.parametrize("background,deterministic", [("white", False), ("last_sample", False),
                                                      ("white", True)])
def test_laplace_render_matches_jax(rng, background, deterministic):
    """``laplace_render`` on JAX's own posterior (converted) with JAX's
    draws replayed: every output within OUTPUT_TOLS (the spreads within
    MOMENT_TOL) on rays that flipped no cell; the spread is not zero."""
    want, got = render_pair(rng, background, deterministic)
    assert set(got) == set(want)
    tols = dict(OUTPUT_TOLS, rgb_var=MOMENT_TOL, rgb_std=MOMENT_TOL)
    bad = ray_mismatch(want, got, tols)
    assert not bad.any(), f"{bad.sum()} rays differ"
    assert got["rgb_std"].max() > 1e-4 and np.isfinite(got["depth_std"]).all()


def render_pair(rng, background, deterministic):
    """``laplace_render`` in both packages on 64 steady rays, on JAX's
    posterior and JAX's draws: (JAX outputs, port outputs)."""
    jmodel, tmodel, tree = _model_pair(rng, background_color=background)
    jbs, _ = _batches(rng, jmodel, tmodel, tree, 1)
    post = jl.fit_laplace(jmodel, tree, lambda i: jbs[0], jmodel.config, n_iters=1)
    jb, tb = _bundles(*_steady_rays(rng, jmodel, tmodel, tree, 64))
    key = jax.random.PRNGKey(4)
    kw = dict(n_samples=16, num_density_draws=12, use_deterministic_density=deterministic, prior_prec=1.0)
    want = {k: np.asarray(v) for k, v in jl.laplace_render(jmodel, tree, post, jb, key, jmodel.config,
                                                           **kw).items()}
    noise = _jax_noise(key, (64, jmodel.config.num_nerf_samples), 16, 12)
    got = {k: v.numpy() for k, v in tl.laplace_render(tmodel, interop.laplace_posterior_from_jax(post), tb,
                                                      tmodel.config, noise=noise, **kw).items()}
    return want, got


def test_full_cov_fit_and_draws_match_jax(rng):
    """``fit_laplace_full_cov`` over two batches, each head's (D, D) block
    within LAPLACE_GGN_TOL of the JAX package's (the same flattening), and
    ``sample_laplace_full_cov`` with JAX's normal draws within TOL."""
    jmodel, tmodel, tree = _model_pair(rng)
    jbs, tbs = _batches(rng, jmodel, tmodel, tree, 2, n=24)
    # fit_laplace_full_cov closes over its params inside jit: device arrays
    want = jl.fit_laplace_full_cov(jmodel, jax.tree_util.tree_map(jnp.asarray, tree), lambda i: jbs[i],
                                   jmodel.config, n_iters=2)
    got = tl.fit_laplace_full_cov(tmodel, lambda i: tbs[i], tmodel.config, n_iters=2)
    for head in ("density_head", "rgb_head"):
        w = np.asarray(want[head])
        assert got[head].shape == w.shape
        np.testing.assert_allclose(got[head].numpy(), w, atol=LAPLACE_GGN_TOL["atol"] * np.abs(w).max(),
                                   rtol=LAPLACE_GGN_TOL["rtol"], err_msg=head)
    key = jax.random.PRNGKey(9)
    head = tree["field"]["rgb_head"]
    dim = head["kernel"].size + head["bias"].size
    j_samples = jl.sample_laplace_full_cov(key, head, want["rgb_head"], n_samples=7)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (7, dim))))
    t_head = {"weight": torch.from_numpy(head["kernel"].T.copy()), "bias": torch.from_numpy(head["bias"])}
    t_samples = tl.sample_laplace_full_cov(t_head, torch.from_numpy(np.asarray(want["rgb_head"])), 7, eps=eps)
    np.testing.assert_allclose(t_samples["bias"].numpy(), np.asarray(j_samples["bias"]), **TOL)
    np.testing.assert_allclose(t_samples["weight"].transpose(1, 2).numpy(), np.asarray(j_samples["kernel"]),
                               **TOL)


def test_laplace_posterior_round_trips(rng):
    """The posterior converter is bit-exact both ways."""
    post = jl.LaplacePosterior(
        density_head={"kernel": rng.normal(size=(64, 1)).astype(np.float32),
                      "bias": rng.normal(size=(1,)).astype(np.float32)},
        rgb_head={"kernel": rng.normal(size=(64, 3)).astype(np.float32),
                  "bias": rng.normal(size=(3,)).astype(np.float32)})
    got = interop.laplace_posterior_from_jax(post)
    assert tuple(got.rgb_head["weight"].shape) == (3, 64)
    back = interop.laplace_posterior_to_jax(got)
    for head in ("density_head", "rgb_head"):
        for leaf in ("kernel", "bias"):
            a, b = getattr(post, head)[leaf], back[head][leaf]
            assert a.dtype == b.dtype and np.array_equal(a, b)


def _steady_pixels(jtr, ttr, tree) -> np.ndarray:
    """(P, 3) (camera, y, x) of every training pixel whose ray flips no cell
    between the packages' eval forwards."""
    cams, h, w = ttr.images.shape[:3]
    grid = np.stack(np.meshgrid(np.arange(cams), np.arange(h), np.arange(w), indexing="ij"), -1).reshape(-1, 3)
    jb = j_generate_rays(jtr.cameras, jnp.asarray(grid[:, 0].astype(np.int32)),
                         jnp.asarray(grid[:, 2].astype(np.float32)), jnp.asarray(grid[:, 1].astype(np.float32)))
    tb = t_generate_rays(ttr.cameras, torch.from_numpy(grid[:, 0]).long(),
                         torch.from_numpy(grid[:, 2].astype(np.float32)),
                         torch.from_numpy(grid[:, 1].astype(np.float32)))
    model_tree = {k: v for k, v in tree.items() if k != "camera_opt"}
    j_sdist = jtr.model.apply({"params": model_tree}, jb, train=True)["sdist_list"]
    t_sdist = ttr.model(tb, return_intermediates=True)["sdist_list"]
    flipped = (lookup_cells_jax(jtr.model.config, jb, j_sdist) != ttr.model.lookup_cells(tb, t_sdist).numpy()).any(1)
    assert flipped.mean() <= MAX_FLIPPED_RAY_SHARE
    return grid[~flipped]


def test_laplace_chunk_fn_matches_jax(rng, tmp_path):
    """``build_chunk_render_fn``'s Laplace branch against the JAX package's
    (fit over two 4,096-ray batches of the JAX trainer's sampler, drawn
    from the pixels whose rays flip no cell, then the jitted render with
    its key's draws), with those batches and draws handed to the port: the
    port's posterior within LAPLACE_GGN_TOL of ``fit_laplace`` on those
    batches, and the outputs within OUTPUT_TOLS and MOMENT_TOL on the rays
    where the JAX package's jitted render agrees with its own eager one
    (``laplace_render`` on the same posterior; as in
    tests/test_torch_model.py::test_render_image_matches_jax, a ray whose
    density draws land on either side of a steep transmittance moves the
    jitted render away from the eager one)."""
    jtr, ttr, tree, images = _trainer_pair(rng, "zero", **LAPLACE_KW)
    steady = jnp.asarray(_steady_pixels(jtr, ttr, tree))

    def sample_batch(key, num_rays):
        rows = steady[jax.random.randint(key, (num_rays,), 0, steady.shape[0])]
        cam, py, px = rows[:, 0], rows[:, 1], rows[:, 2]
        return {"camera_indices": cam, "pixel_x": px.astype(jnp.float32), "pixel_y": py.astype(jnp.float32),
                "image": jnp.asarray(images)[cam, py, px]}

    jtr.sample_batch = sample_batch
    spec = types.SimpleNamespace(family="nerfacto", mc_samples=0, laplace=True)
    seed, iters, samples = 1, 2, 8
    jfn = j_eval.build_chunk_render_fn(jtr, spec, tmp_path, laplace_iters=iters, laplace_samples=samples,
                                       seed=seed)

    def batches(step):
        # the JAX package's batches (its sampler's keys)
        return jtr.sample_batch(jax.random.fold_in(jax.random.PRNGKey(seed + 11), step), 4096)

    def batch_iter(step):
        batch = batches(step)
        return t_generate_rays(ttr.cameras, torch.from_numpy(np.array(batch["camera_indices"])).long(),
                               torch.from_numpy(np.array(batch["pixel_x"])),
                               torch.from_numpy(np.array(batch["pixel_y"])))

    jb, tb = _bundles(*rays(rng, 48))
    key = jax.random.PRNGKey(seed + 7)
    noise = _jax_noise(key, (48, jtr.config.num_nerf_samples), samples, 100)
    tfn = t_eval.build_chunk_render_fn(ttr, spec, laplace_iters=iters, laplace_samples=samples, seed=seed,
                                       batch_iter=batch_iter, draws=noise)
    model_tree = {k: v for k, v in tree.items() if k != "camera_opt"}
    jpost = jl.fit_laplace(jtr.model, model_tree, lambda i: j_generate_rays(
        jtr.cameras, batches(i)["camera_indices"], batches(i)["pixel_x"], batches(i)["pixel_y"]),
        jtr.config, n_iters=iters)
    _posterior_close(tfn.posterior, jpost)
    want = {k: np.asarray(v) for k, v in jfn(jb).items()}
    eager = {k: np.asarray(v) for k, v in jl.laplace_render(jtr.model, model_tree, jpost, jb, key, jtr.config,
                                                            n_samples=samples).items()}
    got = {k: v.numpy() for k, v in tfn(tb).items()}
    assert set(got) == set(want)
    j_sdist = jtr.model.apply({"params": model_tree}, jb, train=True)["sdist_list"]
    flipped = (lookup_cells_jax(jtr.model.config, jb, j_sdist)
               != ttr.model.lookup_cells(tb, ttr.model(tb, return_intermediates=True)["sdist_list"]).numpy()).any(1)
    tols = dict(OUTPUT_TOLS, rgb_var=MOMENT_TOL, rgb_std=MOMENT_TOL)
    excluded = flipped | ray_mismatch(eager, want, tols)
    assert excluded.mean() <= MAX_FLIPPED_RAY_SHARE, (flipped.sum(), excluded.sum())
    bad = ray_mismatch(want, got, tols)
    assert not (bad & ~excluded).any(), f"{(bad & ~excluded).sum()} rays differ ({excluded.sum()} excluded)"
    assert not ray_mismatch(eager, got, tols)[~flipped].any()
