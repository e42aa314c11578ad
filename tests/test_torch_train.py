"""Parity of the port's nerfacto training path against the JAX package, on
the CPU: the loss and its terms, the proposal annealing, the optimizer, one
batch's loss and every gradient through ``NerfactoTrainer._loss_fn``, the
masked pixel sampler and the trainer-state converter.

Inputs are drawn with numpy from a seed; tolerances and the rule for rays
that cross a hash-grid cell face are stated in tests/torch_parity.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import (
    CPU_TRAIN_GRAD_L2,
    MAX_FLIPPED_RAY_SHARE,
    SPLAT_STEP_PARAM_TOL,
    TOL,
    TRAIN_LOSS_RTOL,
    WELL_CONDITIONED_DENSITY_SHIFT,
    WELL_CONDITIONED_TRAIN_GRAD_L2,
    draw_params,
    grad_l2_error,
    lookup_cells_jax,
    small_config_kwargs,
)

from uncertainty_nerf_gs_tpu.cameras import cameras as jcam
from uncertainty_nerf_gs_tpu.data.synthetic import hemisphere_cameras as j_hemisphere
from uncertainty_nerf_gs_tpu.engine import optimizers as jopt
from uncertainty_nerf_gs_tpu.engine.trainer import NerfactoTrainer as JTrainer
from uncertainty_nerf_gs_tpu.models import nerfacto as jnerf

from uncertainty_nerf_gs_torch import interop
from uncertainty_nerf_gs_torch.cameras import cameras as tcam
from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras as t_hemisphere
from uncertainty_nerf_gs_torch.engine import optimizers as topt
from uncertainty_nerf_gs_torch.engine.trainer import NerfactoTrainer as TTrainer
from uncertainty_nerf_gs_torch.models import nerfacto as tnerf

H, W, N_CAMS = 10, 12, 3


def _t(x):
    return torch.from_numpy(np.array(x))


# -- loss and annealing ------------------------------------------------------


def test_proposal_anneal_factor_matches_jax():
    """Bit for bit: the factor is computed in float32 as the JAX package
    computes it."""
    for overrides in ({}, dict(proposal_weights_anneal_max_num_iters=300,
                               proposal_weights_anneal_slope=3.5)):
        tcfg = tnerf.NerfactoConfig(**overrides)
        jcfg = jnerf.NerfactoConfig(**overrides)
        for step in (0, 1, 7, 150, 299, 300, 500, 999, 1000, 4321):
            want = np.float32(jnerf.proposal_anneal_factor(jnp.int32(step), jcfg))
            assert np.float32(tnerf.proposal_anneal_factor(step, tcfg)) == want, step


@pytest.mark.parametrize("active", [True, False])
def test_nerfacto_loss_matches_jax(rng, active):
    """Every term and the gradient to every input at TOL, on train-mode
    outputs drawn at random (the active variant's NLL with rgb variances
    reaching below the 1e-6 floor)."""
    r = 32
    cfg_kw = dict(uncertainty_channels=1 if active else 0)
    edges = [np.sort(rng.uniform(0, 1, (r, n + 1)), axis=1).astype(np.float32) for n in (64, 24, 12)]
    arrays = {
        "rgb": rng.uniform(0, 1, (r, 3)),
        "rgb_var": np.concatenate([rng.uniform(0, 0.2, r - 4), [0.0, 1e-7, 1e-6, 2e-6]]),
        "density_mean": rng.uniform(0, 5, ()),
        "w0": rng.uniform(0, 1, (r, 64)) ** 4 / 4,
        "w1": rng.uniform(0, 1, (r, 24)) ** 4 / 4,
        "w2": rng.uniform(0.01, 1, (r, 12)) / 12,
    }
    arrays = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
    image = rng.uniform(0, 1, (r, 3)).astype(np.float32)
    keys = [k for k in arrays if active or k != "rgb_var"]

    def outputs(a, as_array):
        out = {k: a[k] for k in ("rgb", "rgb_var", "density_mean") if k in a}
        out["weights_list"] = [a["w0"], a["w1"], a["w2"]]
        out["sdist_list"] = [as_array(e) for e in edges]
        return out

    def j_total(a):
        return jnerf.nerfacto_loss(outputs(a, jnp.asarray), {"image": jnp.asarray(image)},
                                   jnerf.NerfactoConfig(**cfg_kw))

    j_in = {k: jnp.asarray(arrays[k]) for k in keys}
    (want_total, want_terms), want_grads = jax.value_and_grad(j_total, has_aux=True)(j_in)
    t_in = {k: _t(arrays[k]).requires_grad_(True) for k in keys}
    total, terms = tnerf.nerfacto_loss(outputs(t_in, _t), {"image": _t(image)},
                                       tnerf.NerfactoConfig(**cfg_kw))
    assert set(terms) == set(want_terms)
    for k in terms:
        np.testing.assert_allclose(terms[k].detach().numpy(), np.asarray(want_terms[k]), err_msg=k, **TOL)
    np.testing.assert_allclose(total.detach().numpy(), np.asarray(want_total), **TOL)
    grads = torch.autograd.grad(total, [t_in[k] for k in keys], allow_unused=True)
    for k, g in zip(keys, grads):
        g = torch.zeros_like(t_in[k]) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(want_grads[k]), err_msg=k, **TOL)


# -- optimizer ---------------------------------------------------------------


def test_make_optimizer_matches_optax(rng):
    """Three updates with injected gradients against optax's
    ``make_optimizer``: the fields' warmup (lr 0 at the first update), the
    decay after it, the camera_opt group, and AdamW on the proposals; the
    parameters after each update within SPLAT_STEP_PARAM_TOL."""
    groups = {
        "proposal_networks": jopt.OptimizerGroupConfig(lr=1e-2, lr_final=1e-3, max_steps=5,
                                                       weight_decay=0.1),
        "fields": jopt.OptimizerGroupConfig(lr=1e-2, lr_final=1e-4, max_steps=10, warmup_steps=2),
        "camera_opt": jopt.OptimizerGroupConfig(lr=1e-3, lr_final=1e-4, max_steps=3),
    }
    tgroups = {k: topt.OptimizerGroupConfig(**dataclasses.asdict(v)) for k, v in groups.items()}
    shapes = {"proposal_0": {"w": (4, 3)}, "field": {"cells": (2, 5), "b": (7,)}, "camera_opt": (3, 6)}
    tree = jax.tree_util.tree_map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                                  is_leaf=lambda x: isinstance(x, tuple))
    tx = jopt.make_optimizer(tree, groups)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(jparams)
    names = {"proposal_0.w": ("proposal_0", "w"), "field.cells": ("field", "cells"),
             "field.b": ("field", "b"), "camera_opt": ("camera_opt",)}

    def leaf(t, path):
        for k in path:
            t = t[k]
        return t

    tparams = {n: _t(leaf(tree, path)).requires_grad_(True) for n, path in names.items()}
    opt = topt.make_optimizer(tparams, tgroups)
    assert [g["name"] for g in opt.param_groups] == ["proposal_networks", "fields", "camera_opt"]
    for step in range(3):
        grads = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, path in names.items():
            tparams[n].grad = _t(leaf(grads, path))
        topt.apply_updates(opt)
        for n, path in names.items():
            np.testing.assert_allclose(tparams[n].detach().numpy(), np.asarray(leaf(jparams, path)),
                                       err_msg=f"{n} after update {step}", **SPLAT_STEP_PARAM_TOL)
    # the fields' first update had lr 0, as in optax
    assert [g["count"] for g in opt.param_groups] == [3, 3, 3]


# -- trainer -----------------------------------------------------------------


def _trainer_pair(rng, camera_opt, masks=None, background="white", density_shift=0.0, **config):
    """The JAX and the port's NerfactoTrainer with the camera optimizer, on
    one set of random weights (tables +-2) and random images.
    ``density_shift`` is added to the bias of every density head (the
    field's and the proposals'): rays then reach high accumulation.
    ``config`` overrides the small config's fields."""
    kw = small_config_kwargs(background_color=background, **config)
    images = rng.uniform(0, 1, (N_CAMS, H, W, 3)).astype(np.float32)
    jcams = j_hemisphere(N_CAMS, height=H, width=W, seed=1)
    jtr = JTrainer(jnerf.NerfactoConfig(**kw), jcams, images, use_camera_optimizer=True, masks=masks)
    model_tree = {k: v for k, v in jtr.state.params.items() if k != "camera_opt"}
    tree = draw_params(jax.tree_util.tree_map(np.asarray, model_tree), rng)
    if density_shift:
        tree["field"]["density_head"]["bias"] += np.float32(density_shift)
        for name in tree:
            if name.startswith("proposal_"):
                last = sorted(tree[name]["mlp"])[-1]
                tree[name]["mlp"][last]["bias"] += np.float32(density_shift)
    if camera_opt == "zero":
        tree["camera_opt"] = np.zeros((N_CAMS, 6), np.float32)
    else:
        tree["camera_opt"] = (rng.normal(size=(N_CAMS, 6)) * 0.02).astype(np.float32)
    jtr.state = jtr.state._replace(params=jax.tree_util.tree_map(jnp.asarray, tree))
    ttr = TTrainer(tnerf.NerfactoConfig(**kw), t_hemisphere(N_CAMS, height=H, width=W, seed=1),
                   images, use_camera_optimizer=True, masks=masks, device="cpu")
    ttr.restore({"params": interop.params_from_jax(tree)})
    return jtr, ttr, tree, images


def _jax_draws(jtr, rng_key, num_rays) -> dict:
    """The uniform draws JAX's training forward makes for ``num_rays`` rays
    under ``_loss_fn(..., rng_key, ...)``, in ``NerfactoModel.draw``'s
    layout: ``jax.random.uniform(key, shape)`` of the keys the model splits
    (its stratified jitter is that draw minus 0.5, to the bit)."""
    cfg = jtr.config
    k_model, _ = jax.random.split(rng_key)
    levels = len(cfg.proposal_net_args)
    keys = jax.random.split(k_model, levels + 2)
    counts = list(cfg.num_proposal_samples[1:levels]) + [cfg.num_nerf_samples]
    draws = {
        "uniform": _t(jax.random.uniform(keys[0], (num_rays, cfg.num_proposal_samples[0] + 1))),
        "pdf": [_t(jax.random.uniform(keys[1 + i], (num_rays, n + 1))) for i, n in enumerate(counts)],
    }
    if cfg.background_color == "random":
        draws["background"] = _t(jax.random.uniform(keys[-1], (num_rays, 3)))
    return draws


def _batches(images, rows):
    """The same batch for both packages: (cam, y, x) rows -> dicts."""
    cam, py, px = rows[:, 0], rows[:, 1], rows[:, 2]
    j = {"camera_indices": jnp.asarray(cam.astype(np.int32)), "pixel_x": jnp.asarray(px.astype(np.float32)),
         "pixel_y": jnp.asarray(py.astype(np.float32)), "image": jnp.asarray(images[cam, py, px])}
    t = {"camera_indices": _t(cam.astype(np.int64)), "pixel_x": _t(px.astype(np.float32)),
         "pixel_y": _t(py.astype(np.float32)), "image": _t(images[cam, py, px])}
    return j, t


def _flipped_rays(jtr, ttr, tree, jb, tb, draws, rng_key, step) -> tuple[np.ndarray, dict]:
    """(R,) bool: rays one of whose lookups lands in another cell in the two
    packages' training forwards on this batch and these draws; and the
    port's outputs."""
    cfg = jtr.config
    anneal = jnerf.proposal_anneal_factor(jnp.int32(step), cfg)
    k_model, _ = jax.random.split(rng_key)
    model_params = {k: v for k, v in tree.items() if k != "camera_opt"}
    j_rb = jcam.generate_rays(jtr.cameras, jb["camera_indices"], jb["pixel_x"], jb["pixel_y"],
                              pose_adjustment=jnp.asarray(tree["camera_opt"]))
    j_out = jtr.model.apply({"params": model_params}, j_rb, train=True, rngs_key=k_model,
                            proposal_anneal=anneal)
    t_rb = tcam.generate_rays(ttr.cameras, tb["camera_indices"], tb["pixel_x"], tb["pixel_y"],
                              pose_adjustment=ttr.camera_opt)
    with torch.no_grad():
        t_out = ttr.model(t_rb, train=True, draws=draws,
                          proposal_anneal=tnerf.proposal_anneal_factor(step, ttr.config))
    want = lookup_cells_jax(cfg, j_rb, j_out["sdist_list"])
    got = ttr.model.lookup_cells(t_rb, t_out["sdist_list"]).numpy()
    return (want != got).any(axis=1), t_out


def _jax_face_vertices(jtr, rng_key) -> list[torch.Tensor]:
    """The face-consistency loss's vertices JAX's trainer draws under
    ``_loss_fn(..., rng_key, ...)``: ``jax.random.randint`` of the key
    folded with 0xFACE and then with the level, one draw a cell-stored level
    of the main field."""
    from uncertainty_nerf_gs_tpu.ops.encodings import hash_grid_resolutions, hybrid_is_dense

    cfg = jtr.config
    res = hash_grid_resolutions(cfg.num_levels, cfg.base_res, cfg.max_res)
    key = jax.random.fold_in(rng_key, 0xFACE)
    levels = [lvl for lvl, r in enumerate(res)
              if cfg.grid_layout == "cell" or not hybrid_is_dense(int(r), 2**cfg.log2_hashmap_size)]
    return [_t(jax.random.randint(jax.random.fold_in(key, lvl), (cfg.face_consistency_samples, 3), 1,
                                  int(res[lvl]))).long() for lvl in levels]


def train_loss_and_grads(rng, camera_opt, background="white", num_rays=96, step=300, seed=3,
                         jit=True, density_shift=0.0, outputs=None, config=None):
    """One batch's loss terms and gradients in both packages (JAX's under
    ``jax.jit`` unless ``jit`` is False), ``config`` overriding the small
    config's fields (with the face-consistency loss on, JAX's vertices are
    replayed too). Rays whose
    lookups flipped a cell are replaced by fresh rays until none flips (the
    batch keeps its size, so that JAX's draws for each row stay the same).
    Returns (want_terms, got_terms, want_grads and got_grads by torch name,
    rays replaced); a dict passed as ``outputs`` receives the port's
    forward outputs on the final batch."""
    jtr, ttr, tree, images = _trainer_pair(rng, camera_opt, background=background,
                                           density_shift=density_shift, **(config or {}))

    def fresh(n):
        return np.stack([rng.integers(0, N_CAMS, n), rng.integers(0, H, n), rng.integers(0, W, n)], axis=1)

    rows = fresh(num_rays)
    rng_key = jax.random.PRNGKey(seed)
    draws = _jax_draws(jtr, rng_key, num_rays)
    if jtr.config.face_consistency_mult > 0.0:
        draws["face_vertices"] = _jax_face_vertices(jtr, rng_key)
    replaced = 0
    for _ in range(6):
        jb, tb = _batches(images, rows)
        flipped, t_out = _flipped_rays(jtr, ttr, tree, jb, tb, draws, rng_key, step)
        if outputs is not None:
            outputs.update(t_out)
        if not flipped.any():
            break
        replaced += int(flipped.sum())
        rows[flipped] = fresh(int(flipped.sum()))
    assert not flipped.any(), "rays keep flipping cells"
    loss_and_grad = jax.value_and_grad(jtr._loss_fn, has_aux=True)
    (total, terms), grads = (jax.jit(loss_and_grad) if jit else loss_and_grad)(
        jax.tree_util.tree_map(jnp.asarray, tree), jb, rng_key, jnp.int32(step))
    want_terms = {k: float(v) for k, v in terms.items()} | {"total_loss": float(total)}
    want_grads = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    t_total, t_terms = ttr._loss_fn(tb, step, draws=draws)
    t_total.backward()
    got_terms = {k: float(v.detach()) for k, v in t_terms.items()} | {"total_loss": float(t_total.detach())}
    got_grads = {k: p.grad for k, p in ttr.params().items()}
    return want_terms, got_terms, want_grads, got_grads, replaced


@pytest.mark.parametrize("camera_opt,background", [("zero", "white"), ("random", "last_sample")])
def test_trainer_loss_and_grads_match_jax(rng, camera_opt, background):
    """``NerfactoTrainer._loss_fn`` with JAX's draws replayed through
    ``draws=`` against ``jax.value_and_grad`` of the JAX trainer's
    ``_loss_fn``, on one batch of 96 rays at step 300 (annealing active),
    camera tangents at their zero start and at random, on a fixed and on
    the last-sample background: every loss term within TRAIN_LOSS_RTOL,
    every gradient leaf (fields, proposals, camera_opt) within
    CPU_TRAIN_GRAD_L2 in relative L2 norm, on rays none of whose lookups
    crossed a cell face between the packages."""
    _check_train_parity(*train_loss_and_grads(rng, camera_opt, background), CPU_TRAIN_GRAD_L2)


def _check_train_parity(want_terms, got_terms, want_grads, got_grads, replaced, grad_bar):
    assert replaced <= MAX_FLIPPED_RAY_SHARE * 96 * 2
    assert set(got_terms) == set(want_terms)
    for k in want_terms:
        assert np.isclose(got_terms[k], want_terms[k], rtol=TRAIN_LOSS_RTOL, atol=0), (
            k, got_terms[k], want_terms[k])
    assert set(got_grads) == set(want_grads)
    for k, want in want_grads.items():
        got = got_grads[k]
        assert got.shape == want.shape and torch.isfinite(got).all(), k
        assert grad_l2_error(k, got, want) <= grad_bar, (k, grad_l2_error(k, got, want))
    assert want_grads["camera_opt"].abs().max() > 0


def test_trainer_loss_and_grads_match_jax_well_conditioned(rng):
    """As above, on weights whose density heads are raised by
    WELL_CONDITIONED_DENSITY_SHIFT: most rays reach high accumulation, so
    their rendered rgb variance stays far above its 1e-6 floor and the NLL's
    gradients are not dominated by the floor's division. Every gradient
    within WELL_CONDITIONED_TRAIN_GRAD_L2 (tests/torch_parity.py)."""
    outputs = {}
    result = train_loss_and_grads(rng, "random", "white", density_shift=WELL_CONDITIONED_DENSITY_SHIFT,
                                  outputs=outputs)
    acc, rgb_var = outputs["accumulation"], outputs["rgb_var"]
    assert float(torch.median(acc)) > 0.9 and float(rgb_var.min()) > 1e-4, (
        float(torch.median(acc)), float(rgb_var.min()))
    _check_train_parity(*result, WELL_CONDITIONED_TRAIN_GRAD_L2)


def test_sample_batch_with_masks_never_draws_masked_pixel(rng):
    masks = rng.uniform(size=(N_CAMS, H, W)) < 0.3
    masks[1] = False  # a camera with no valid pixel
    _, ttr, _, images = _trainer_pair(rng, "zero", masks=masks)
    seen = np.zeros_like(masks)
    for _ in range(20):
        batch = ttr.sample_batch(256)
        cam = batch["camera_indices"].numpy()
        py, px = batch["pixel_y"].long().numpy(), batch["pixel_x"].long().numpy()
        assert masks[cam, py, px].all()
        np.testing.assert_array_equal(batch["image"].numpy(), images[cam, py, px])
        seen[cam, py, px] = True
    assert seen.sum() > 0.9 * masks.sum()  # uniform over the valid pixels


def test_trainer_state_round_trips_jax_state_dict(rng):
    """A JAX trainer state (random moments, counts 7) through
    ``trainer_state_from_jax``, the port's ``restore`` and ``state_dict``,
    and ``trainer_state_to_jax`` comes back bit for bit, and the JAX trainer
    restores it."""
    jtr, ttr, _, _ = _trainer_pair(rng, "random")
    leaves, treedef = jax.tree_util.tree_flatten(jtr.state_dict())
    leaves = [
        rng.normal(size=np.shape(x)).astype(np.float32) if np.asarray(x).dtype == np.float32
        else np.asarray(x) + 7 for x in leaves
    ]
    state = jax.tree_util.tree_unflatten(treedef, leaves)
    ttr.restore(interop.trainer_state_from_jax(state))
    assert ttr.step == 7
    back = interop.trainer_state_to_jax(ttr.state_dict(), like=state)
    got, got_def = jax.tree_util.tree_flatten(back)
    assert got_def == treedef
    for a, b in zip(leaves, got):
        assert np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)
    jtr.restore(back)
    assert int(jtr.state.step) == 7


def test_trainer_trains_and_resumes(rng):
    """Three steps through ``train`` with a writer and a callback: finite
    losses, every group moved (camera_opt from the first step, the warmed-up
    groups after it); a restored state continues bit for bit."""
    _, ttr, _, _ = _trainer_pair(rng, "zero")
    start = {k: v.detach().clone() for k, v in ttr.params().items()}
    written, called = [], []

    class Writer:
        def write(self, step, losses):
            written.append(step)

    losses = ttr.train(3, num_rays_per_batch=32, writer=Writer(),
                       callback=lambda i, l: called.append(i))
    assert written == [1, 3] and called == [0, 1, 2] and ttr.step == 3
    assert all(np.isfinite(v) for v in losses.values())
    assert all(not torch.equal(v.detach(), start[k]) for k, v in ttr.params().items())
    ckpt = {k: v for k, v in ttr.state_dict().items()}
    ckpt = {"params": {k: v.clone() for k, v in ckpt["params"].items()},
            "opt_state": {"groups": dict(ckpt["opt_state"]["groups"]),
                          **{m: {k: v.clone() for k, v in ckpt["opt_state"][m].items()}
                             for m in ("exp_avg", "exp_avg_sq")}},
            "step": ckpt["step"]}
    gen_state = ttr._generator.get_state()
    a = ttr.train_step(32)
    ttr.restore(ckpt)
    ttr._generator.set_state(gen_state)
    assert ttr.train_step(32) == a


@pytest.mark.parametrize("what", ["steps_per_launch", "gradient_checkpointing", "face_consistency"])
def test_trainer_refuses_unported_options(what):
    """Each option the trainer once refused now runs: ``steps_per_launch >
    1`` and ``gradient_checkpointing`` (equal to the plain loop bit for bit,
    tests/test_torch_checkpointing.py; a launch of fewer than one step is
    refused), and the face consistency loss, which joins the losses
    (tests/test_torch_hybrid.py holds it against the JAX trainer)."""
    kw = small_config_kwargs()
    cams = t_hemisphere(N_CAMS, height=H, width=W, seed=1)
    images = np.zeros((N_CAMS, H, W, 3), np.float32)
    if what == "steps_per_launch":
        trainer = TTrainer(tnerf.NerfactoConfig(**kw), cams, images, device="cpu")
        assert np.isfinite(trainer.train(2, 8, steps_per_launch=2)["total_loss"]) and trainer.step == 2
        with pytest.raises(ValueError, match="steps_per_launch"):
            trainer.train(2, 8, steps_per_launch=0)
    elif what == "gradient_checkpointing":
        trainer = TTrainer(tnerf.NerfactoConfig(**kw), cams, images, gradient_checkpointing=True, device="cpu")
        assert np.isfinite(trainer.train_step(8)["total_loss"])
    else:
        trainer = TTrainer(tnerf.NerfactoConfig(**kw, face_consistency_mult=0.1), cams, images, device="cpu")
        losses = trainer.train_step(8)
        assert losses["face_consistency_loss"] > 0 and np.isfinite(losses["total_loss"])
