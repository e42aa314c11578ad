"""nerfacto-mcdropout and the bf16 MLP, port against the JAX package on the
CPU: the MLP's dropout (flax's nn.Dropout with the same masks imposed
through ``flax.linen.intercept_methods``) and its bf16 compute (flax's
``nn.Dense(dtype=bf16)``), one MC-dropout training batch's loss and every
gradient against the JAX trainer with JAX's draws replayed and the masks
imposed, ``mc_dropout_render`` against JAX's with the JAX package's own
masks read back (``record_dropout``) and against ``mc_samples`` separate
forwards, the eval chunk renderer's MC-dropout branch, and a restored
trainer repeating a dropout step. Tolerances are stated in
tests/torch_parity.py."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import H, N_CAMS, W, _batches, _flipped_rays, _jax_draws, _trainer_pair
from torch_parity import (
    BF16_MLP_TOL,
    BF16_MODEL_TOL,
    CPU_TRAIN_GRAD_L2,
    MAX_FLIPPED_RAY_SHARE,
    MOMENT_TOL,
    OUTPUT_TOLS,
    TOL,
    TRAIN_LOSS_RTOL,
    WELL_CONDITIONED_DENSITY_SHIFT,
    draw_params,
    dropout_layers,
    grad_l2_error,
    impose_dropout,
    lookup_cells_jax,
    ray_mismatch,
    rays,
    record_dropout,
    recorded_masks,
    small_config_kwargs,
)

from uncertainty_nerf_gs_tpu.models.mcdropout import mc_dropout_render as j_mc_render
from uncertainty_nerf_gs_tpu.models.nerfacto import NerfactoConfig as JConfig
from uncertainty_nerf_gs_tpu.models.nerfacto import NerfactoModel as JModel
from uncertainty_nerf_gs_tpu.ops.mlp import MLP as JMLP
from uncertainty_nerf_gs_tpu.ops.sampling import RayBundle as JBundle
from uncertainty_nerf_gs_tpu.scripts import eval_uncertainty as j_eval

from uncertainty_nerf_gs_torch import interop
from uncertainty_nerf_gs_torch.models.mcdropout import mc_dropout_render
from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig as TConfig
from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoModel as TModel
from uncertainty_nerf_gs_torch.ops.mlp import MLP as TMLP
from uncertainty_nerf_gs_torch.ops.mlp import Dropout
from uncertainty_nerf_gs_torch.ops.sampling import RayBundle as TBundle
from uncertainty_nerf_gs_torch.scripts import eval_uncertainty as t_eval

RATE = 0.2
# methods.py's nerfacto-mcdropout: dropout before the last density and rgb layers
MC_KW = dict(density_dropout_layers=(-1,), rgb_dropout_layers=(-1,), dropout_rate=RATE)


def _mlp_pair(rng, in_dim, **kw):
    """A flax MLP and the port's on the same random weights."""
    jm = JMLP(**kw)
    x = jnp.zeros((1, in_dim), jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), x)["params"])
    tree = jax.tree_util.tree_map(lambda a: (rng.normal(size=a.shape) * 0.5).astype(np.float32), tree)
    tkw = {k: v for k, v in kw.items() if k != "compute_dtype"}
    tm = TMLP(in_dim, compute_dtype=torch.bfloat16 if kw.get("compute_dtype") is not None else None,
              device="cpu", **tkw)
    with torch.no_grad():
        for i in range(kw["num_layers"]):
            getattr(tm, f"dense_{i}").weight.copy_(torch.from_numpy(tree[f"dense_{i}"]["kernel"].T.copy()))
            getattr(tm, f"dense_{i}").bias.copy_(torch.from_numpy(tree[f"dense_{i}"]["bias"]))
    return jm, tm, tree


def _mlp_masks(rng, x, kw, layers):
    """Bool masks of every dropout layer's input shape (as the port's MLP
    sees them) drawn with numpy, by port name ``mlp.{layer}``."""
    widths, width = [], x.shape[-1]
    for i in range(kw["num_layers"]):
        if i in kw.get("skip_connections", ()) and i > 0:
            width += x.shape[-1]
        widths.append(width)
        width = kw["layer_width"]
    return {f"mlp.{i}": rng.uniform(size=x.shape[:-1] + (widths[i],)) >= RATE for i in layers}


@pytest.mark.parametrize("drops,skips", [((-1,), ()), ((0,), ()), ((0, 2), (2,)), ((1, -1), (1,))])
def test_mlp_dropout_matches_flax(rng, drops, skips):
    """Dropout before the listed layers (after a skip's concatenation) with
    masks imposed on both: the same output within TOL, and units dropped."""
    kw = dict(num_layers=4, layer_width=16, out_dim=5, skip_connections=skips, dropout_layers=drops,
              dropout_rate=RATE)
    x = rng.normal(size=(7, 11, 6)).astype(np.float32)
    jm, tm, tree = _mlp_pair(rng, 6, **kw)
    layers = dropout_layers(4, drops)
    masks = _mlp_masks(rng, x, kw, layers)
    with impose_dropout({k.replace("mlp.", "root."): v for k, v in masks.items()}, {"root": layers}):
        want = jm.apply({"params": tree}, jnp.asarray(x), deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(1)})
    got = tm(torch.from_numpy(x), Dropout(masks={k.split(".")[1]: torch.from_numpy(v)
                                                 for k, v in masks.items()}))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    plain = tm(torch.from_numpy(x))
    assert not torch.allclose(got, plain)
    np.testing.assert_allclose(plain.detach().numpy(),
                               np.asarray(jm.apply({"params": tree}, jnp.asarray(x))), **TOL)


def bf16_pair(rng, drops):
    """A bf16 MLP with a skip and ``drops`` in both packages on the same
    weights, inputs and masks: (port float32 output, flax's, the port's
    float32 MLP's)."""
    kw = dict(num_layers=3, layer_width=32, out_dim=8, skip_connections=(1,), dropout_layers=drops,
              dropout_rate=RATE if drops else 0.0, compute_dtype=jnp.bfloat16)
    x = rng.normal(size=(64, 12)).astype(np.float32)
    jm, tm, tree = _mlp_pair(rng, 12, **kw)
    layers = dropout_layers(3, drops)
    masks = _mlp_masks(rng, x, kw, layers)
    with impose_dropout({k.replace("mlp.", "root."): v for k, v in masks.items()}, {"root": layers}):
        want = np.asarray(jm.apply({"params": tree}, jnp.asarray(x), deterministic=not drops,
                                   rngs={"dropout": jax.random.PRNGKey(1)}))
    dropout = Dropout(masks={k.split(".")[1]: torch.from_numpy(v) for k, v in masks.items()}) if drops else None
    got = tm(torch.from_numpy(x), dropout).detach()
    tm.compute_dtype = None
    return got, want, tm(torch.from_numpy(x), dropout).detach().numpy()


@pytest.mark.parametrize("drops", [(), (-1,)])
def test_mlp_bf16_matches_flax(rng, drops):
    """compute_dtype bf16 (nn.Dense(dtype=bf16) in each layer: input,
    weight and bias cast, bias added after the product, activation in
    bf16, output cast back to float32) within BF16_MLP_TOL, with and
    without dropout; closer to flax's bf16 output than to the port's own
    float32 MLP's, which misses the bar."""
    got, want, f32 = bf16_pair(rng, drops)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    scale = float(np.abs(want).max())
    tol = dict(atol=BF16_MLP_TOL["atol"] * scale, rtol=BF16_MLP_TOL["rtol"])
    np.testing.assert_allclose(got.numpy(), want, **tol)
    assert np.abs(got.numpy() - want).max() < np.abs(got.numpy() - f32).max()
    assert not np.allclose(f32, want, **tol)  # a float32 MLP would fail


def _model_pair(rng, **overrides):
    kw = small_config_kwargs(**{**MC_KW, **overrides})
    o, d, ci = rays(rng, 4)
    jb = JBundle(jnp.asarray(o), jnp.asarray(d), jnp.zeros(4), jnp.ones(4), jnp.asarray(ci))
    jmodel = JModel(JConfig(**kw))
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jb)["params"])
    tree = draw_params(tree, rng)
    tmodel = TModel(TConfig(**kw), device="cpu")
    tmodel.load_state_dict(interop.params_from_jax(tree), strict=True)
    return jmodel, tmodel, tree


def _bundles(o, d, ci):
    n = o.shape[0]
    jb = JBundle(jnp.asarray(o), jnp.asarray(d), jnp.zeros(n), jnp.ones(n), jnp.asarray(ci))
    tb = TBundle(torch.from_numpy(o), torch.from_numpy(d), torch.zeros(n), torch.ones(n),
                 torch.from_numpy(ci).long())
    return jb, tb


def _field_layers(cfg) -> dict:
    return {"base_mlp": dropout_layers(max(cfg.num_layers - 1, 1), cfg.density_dropout_layers),
            "color_trunk": dropout_layers(max(cfg.num_layers_color - 1, 1), cfg.rgb_dropout_layers)}


def mixed_precision_pair(rng):
    """The eval forward of a mixed_precision model in both packages on the
    same weights and 256 rays, and of the float32 models on those weights:
    (JAX bf16, port bf16, JAX float32, port float32 outputs, flipped rays)."""
    jmodel, tmodel, tree = _model_pair(rng, mixed_precision=True)
    o, d, ci = rays(rng, 256)
    jb, tb = _bundles(o, d, ci)
    out = []
    for mp in (True, False):
        jm = JModel(dataclasses.replace(jmodel.config, mixed_precision=mp))
        tm = TModel(dataclasses.replace(tmodel.config, mixed_precision=mp), device="cpu")
        tm.load_state_dict(tmodel.state_dict(), strict=True)
        with torch.no_grad():
            out += [{k: np.asarray(v) for k, v in jm.apply({"params": tree}, jb).items()},
                    {k: v.numpy() for k, v in tm(tb).items()}]
    j_sdist = jmodel.apply({"params": tree}, jb, train=True)["sdist_list"]
    with torch.no_grad():
        t_sdist = tmodel(tb, return_intermediates=True)["sdist_list"]
    flipped = (lookup_cells_jax(jmodel.config, jb, j_sdist) != tmodel.lookup_cells(tb, t_sdist).numpy()).any(1)
    return (*out, flipped)


def test_mixed_precision_model_matches_jax(rng):
    """NerfactoModel(mixed_precision=True) against the JAX package's on the
    same weights and rays: every output within BF16_MODEL_TOL of its largest
    magnitude on the rays that flipped no cell, and at least ten times
    closer to the JAX bf16 model than either package's float32 model is
    (casts in the wrong place, or none, would fail)."""
    want, got, want32, got32, flipped = mixed_precision_pair(rng)
    assert set(got) == set(want) and flipped.mean() <= MAX_FLIPPED_RAY_SHARE
    keep = ~flipped
    for k in OUTPUT_TOLS:
        w = want[k][keep]
        err = np.abs(got[k][keep] - w).max()
        assert err <= BF16_MODEL_TOL * np.abs(w).max(), (k, err)
        for other in (want32, got32):
            assert 10 * err < np.abs(other[k][keep] - w).max(), k


def _jax_masks(jmodel, tree, jb, keys) -> list[dict]:
    """The masks the JAX package's own MC forwards draw from each key (as
    ``mc_dropout_render``'s vmap over keys draws them), read back."""
    out = []
    layers = _field_layers(jmodel.config)
    for k in keys:
        with record_dropout():
            _, state = jmodel.apply({"params": tree}, jb, train=False, deterministic_dropout=False,
                                    use_average_appearance=True, rngs={"dropout": k},
                                    mutable=["intermediates"])
        out.append({n: torch.from_numpy(m.copy()) for n, m in recorded_masks(state["intermediates"], layers).items()})
    return out


def mc_render_pair(rng, mc=4):
    """``mc_dropout_render`` in both packages on 96 rays, the port with the
    JAX package's own masks: (JAX outputs, port outputs, flipped rays,
    the port's model, its rays, the masks)."""
    jmodel, tmodel, tree = _model_pair(rng)
    o, d, ci = rays(rng, 96)
    jb, tb = _bundles(o, d, ci)
    key = jax.random.PRNGKey(5)
    want = {k: np.asarray(v) for k, v in j_mc_render(jmodel, tree, jb, mc, key).items()}
    masks = _jax_masks(jmodel, tree, jb, jax.random.split(key, mc))
    got = mc_dropout_render(tmodel, tb, mc, masks=masks)
    j_sdist = jmodel.apply({"params": tree}, jb, train=True)["sdist_list"]
    t_sdist = tmodel(tb, return_intermediates=True)["sdist_list"]
    flipped = (lookup_cells_jax(jmodel.config, jb, j_sdist) != tmodel.lookup_cells(tb, t_sdist).numpy()).any(1)
    return want, got, flipped, tmodel, tb, masks


def test_mc_dropout_render_matches_jax(rng):
    """``mc_dropout_render`` with the masks the JAX package's own
    ``mc_dropout_render`` draws (read back per key): every output within
    OUTPUT_TOLS and every ``*_std`` / ``*_var`` within MOMENT_TOL on the
    rays no lookup of which crossed a cell face; and it equals
    ``mc_samples`` separate full forwards with the same masks bit for bit
    (the proposal chain and the lookups run once)."""
    want, got, flipped, tmodel, tb, masks = mc_render_pair(rng)
    assert {n for m in masks for n in m} == {"base_mlp.0", "color_trunk.1"}
    assert set(got) == set(want)
    assert flipped.mean() <= MAX_FLIPPED_RAY_SHARE
    tols = dict(OUTPUT_TOLS, **{k: MOMENT_TOL for k in got if k.endswith(("_std", "_var"))})
    bad = ray_mismatch(want, {k: v.numpy() for k, v in got.items()}, tols)
    assert not (bad & ~flipped).any(), f"{(bad & ~flipped).sum()} unflipped rays differ"
    assert float(got["rgb_std"].max()) > 1e-3
    # the same as mc separate forwards, stacked
    full = [tmodel(tb, deterministic_dropout=False, dropout_masks=m, use_average_appearance=True)
            for m in masks]
    for k, v in got.items():
        if k.endswith(("_std", "_var")) and k[: -4] in ("rgb", "depth", "expected_depth"):
            s = torch.std(torch.stack([f[k[:-4]] for f in full]), dim=0)
            s = s.mean(-1) if s.dim() > 1 else s
            assert torch.equal(v, s if k.endswith("_std") else s**2), k
        else:
            assert torch.equal(v, torch.mean(torch.stack([f[k] for f in full]), dim=0)), k


@pytest.mark.parametrize("only", ["density", "rgb"])
def test_forward_mc_shares_only_what_no_draw_changes(rng, only):
    """With dropout in one MLP only, ``forward_mc`` still equals separate
    forwards bit for bit (with the density MLP free of dropout, its trunk
    and the color MLP's first layer are shared), and two draws differ."""
    kw = dict(density_dropout_layers=(-1,) if only == "density" else (),
              rgb_dropout_layers=(-1,) if only == "rgb" else ())
    _, tmodel, _ = _model_pair(rng, **kw)
    o, d, ci = rays(rng, 32)
    _, tb = _bundles(o, d, ci)
    gen = torch.Generator().manual_seed(3)
    dropouts = [Dropout(generator=gen) for _ in range(3)]
    outs = tmodel.forward_mc(tb, dropouts)
    assert {n for dr in dropouts for n in dr.drawn} == {"base_mlp.0" if only == "density" else "color_trunk.1"}
    for dr, out in zip(dropouts, outs):
        ref = tmodel(tb, deterministic_dropout=False, dropout_masks=dr.drawn)
        assert all(torch.equal(out[k], ref[k]) for k in ref), only
    assert not torch.equal(outs[0]["rgb"], outs[1]["rgb"])


def mc_trainer_pair(rng, jit=True):
    """One nerfacto-mcdropout batch's loss terms and gradients in both
    packages (JAX's jitted unless ``jit`` is False) with JAX's draws
    replayed and the same masks imposed: (want terms, got terms, want
    grads, the port's trainer, its batch, draws and masks)."""
    jtr, ttr, tree, images = _trainer_pair(rng, "random", density_shift=WELL_CONDITIONED_DENSITY_SHIFT, **MC_KW)
    num_rays, step, key = 96, 300, jax.random.PRNGKey(3)
    draws = _jax_draws(jtr, key, num_rays)
    rows = np.stack([rng.integers(0, N_CAMS, num_rays), rng.integers(0, H, num_rays),
                     rng.integers(0, W, num_rays)], axis=1)
    for _ in range(6):
        jb, tb = _batches(images, rows)
        flipped, _ = _flipped_rays(jtr, ttr, tree, jb, tb, draws, key, step)
        if not flipped.any():
            break
        rows[flipped] = np.stack([rng.integers(0, N_CAMS, flipped.sum()), rng.integers(0, H, flipped.sum()),
                                  rng.integers(0, W, flipped.sum())], axis=1)
    assert not flipped.any()
    cfg = ttr.config
    s = cfg.num_nerf_samples
    masks = {"base_mlp.0": rng.uniform(size=(num_rays, s, ttr.model.field.encoding.output_dim)) >= RATE,
             "color_trunk.1": rng.uniform(size=(num_rays, s, cfg.hidden_dim_color)) >= RATE}
    loss_and_grad = jax.value_and_grad(jtr._loss_fn, has_aux=True)
    with impose_dropout(masks, _field_layers(jtr.config)):  # the masks are traced in as constants
        (total, terms), grads = (jax.jit(loss_and_grad) if jit else loss_and_grad)(
            jax.tree_util.tree_map(jnp.asarray, tree), jb, key, jnp.int32(step))
    t_masks = {k: torch.from_numpy(v) for k, v in masks.items()}
    t_total, t_terms = ttr._loss_fn(tb, step, draws=draws, dropout_masks=t_masks)
    t_total.backward()
    want_terms = {k: float(v) for k, v in terms.items()} | {"total_loss": float(total)}
    got_terms = {k: float(v.detach()) for k, v in t_terms.items()} | {"total_loss": float(t_total.detach())}
    want_grads = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    return want_terms, got_terms, want_grads, ttr, (tb, step, draws, t_masks)


def test_mcdropout_trainer_loss_and_grads_match_jax(rng):
    """One nerfacto-mcdropout batch (96 rays, step 300) through
    ``NerfactoTrainer._loss_fn`` with JAX's draws replayed and the same
    dropout masks imposed on both, on weights whose density heads are
    raised by WELL_CONDITIONED_DENSITY_SHIFT (so that the NLL is not ruled
    by the variance floor): every loss term within TRAIN_LOSS_RTOL and
    every gradient leaf within CPU_TRAIN_GRAD_L2 on rays whose lookups
    stayed in their cells (the dropped trunk inputs leave the main field's
    cells to a few rays: the JAX package's own eager gradients are 1.66e-2
    from its jitted ones there; ``python tests/torch_parity_report.py
    mcdropout``); the masks change the loss."""
    want_terms, got_terms, want_grads, ttr, (tb, step, draws, masks) = mc_trainer_pair(rng)
    for k in want_terms:
        assert np.isclose(got_terms[k], want_terms[k], rtol=TRAIN_LOSS_RTOL, atol=0), (k, got_terms[k])
    for k, p in ttr.params().items():
        assert torch.isfinite(p.grad).all(), k
        err = grad_l2_error(k, p.grad, want_grads[k])
        assert err <= CPU_TRAIN_GRAD_L2, (k, err)
    plain, _ = ttr._loss_fn(tb, step, draws=draws, dropout_masks={k: torch.ones_like(v) for k, v in masks.items()})
    assert abs(float(plain) - got_terms["total_loss"]) > 1e-6


def test_dropout_trainer_repeats_from_restored_state(rng):
    """A nerfacto-mcdropout training step draws its masks from the
    trainer's generator, whose state ``state_dict`` carries: a restored
    trainer repeats the step's losses and parameters bit for bit."""
    _, ttr, _, _ = _trainer_pair(rng, "zero", **MC_KW)
    ttr.train_step(32)
    snap = ttr.state_dict()
    snap = {"params": {k: v.clone() for k, v in snap["params"].items()}, "step": snap["step"],
            "generator": snap["generator"].clone(),
            "opt_state": {"groups": dict(snap["opt_state"]["groups"]),
                          **{m: {k: v.clone() for k, v in snap["opt_state"][m].items()}
                             for m in ("exp_avg", "exp_avg_sq")}}}
    a = ttr.train_step(32)
    after = {k: v.detach().clone() for k, v in ttr.params().items()}
    ttr.restore(snap)
    assert ttr.train_step(32) == a
    assert all(torch.equal(after[k], v.detach()) for k, v in ttr.params().items())


def test_mcdropout_chunk_fn_matches_jax(rng):
    """``build_chunk_render_fn``'s MC-dropout branch (the eval-time
    ``mc_samples`` override) against the JAX package's, with the JAX
    package's masks for its key handed to the port: within OUTPUT_TOLS and
    MOMENT_TOL on rays that flipped no cell."""
    jtr, ttr, tree, _ = _trainer_pair(rng, "zero", **MC_KW)
    spec = types.SimpleNamespace(family="nerfacto", mc_samples=10, laplace=False)
    mc, seed = 3, 2
    jfn = j_eval.build_chunk_render_fn(jtr, spec, None, mc_samples=mc, seed=seed)
    o, d, ci = rays(rng, 64)
    jb, tb = _bundles(o, d, ci)
    model_tree = {k: v for k, v in tree.items() if k != "camera_opt"}
    masks = _jax_masks(jtr.model, model_tree, jb, jax.random.split(jax.random.PRNGKey(seed + 7), mc))
    tfn = t_eval.build_chunk_render_fn(ttr, spec, mc_samples=mc, seed=seed, draws=masks)
    want = {k: np.asarray(v) for k, v in jfn(jb).items()}
    got = {k: v.numpy() for k, v in tfn(tb).items()}
    assert set(got) == set(want)
    j_sdist = jtr.model.apply({"params": model_tree}, jb, train=True)["sdist_list"]
    flipped = (lookup_cells_jax(jtr.model.config, jb, j_sdist)
               != ttr.model.lookup_cells(tb, ttr.model(tb, return_intermediates=True)["sdist_list"]).numpy()).any(1)
    tols = dict(OUTPUT_TOLS, **{k: MOMENT_TOL for k in got if k.endswith(("_std", "_var"))})
    bad = ray_mismatch(want, got, tols)
    assert not (bad & ~flipped).any() and flipped.mean() <= MAX_FLIPPED_RAY_SHARE
