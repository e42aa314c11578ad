"""Parity of the port's joint ensemble training step and its per-member
ensemble render against the JAX package, on the CPU:
``parallel/ensemble_parallel.py``'s ``init_ensemble_params``,
``build_ensemble_train_step`` (one and two steps against JAX's jitted step
on the same carried weights, batches and draws; each member against a lone
single-member step, bit for bit; its K-step launch and its restore), the
stacked optimizer-state converter, and ``build_ensemble_render``.

Inputs are drawn with numpy from a seed; the bars are tests/torch_parity.py's
and each test states the ones it holds. Torch cannot replay JAX keys: the
JAX step keys member m's forward with ``split(fold_in(key, 0), M)[m]``, and
``torch_parity.jax_draws(per_member=M)`` hands the port those draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ensemble import _compare, bundles, flipped_rays
from torch_parity import (
    CPU_TRAIN_GRAD_L2,
    MAX_FLIPPED_RAY_SHARE,
    TRAIN_LOSS_RTOL,
    draw_params,
    grad_l2_error,
    jax_draws,
    lookup_cells_jax,
    small_config_kwargs,
)

from uncertainty_nerf_gs_tpu.cameras import cameras as jcam
from uncertainty_nerf_gs_tpu.data.synthetic import hemisphere_cameras as j_hemisphere
from uncertainty_nerf_gs_tpu.engine import optimizers as jopt
from uncertainty_nerf_gs_tpu.models import nerfacto as jnerf
from uncertainty_nerf_gs_tpu.parallel import ensemble_parallel as jpar

from uncertainty_nerf_gs_torch import interop
from uncertainty_nerf_gs_torch.cameras import cameras as tcam
from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras as t_hemisphere
from uncertainty_nerf_gs_torch.engine import optimizers as topt
from uncertainty_nerf_gs_torch.engine.trainer import NerfactoTrainer
from uncertainty_nerf_gs_torch.models import nerfacto as tnerf
from uncertainty_nerf_gs_torch.models.ensemble import ensemble_render, member_apply
from uncertainty_nerf_gs_torch.parallel import ensemble_parallel as tpar

H, W, N_CAMS, M, RAYS = 10, 12, 3, 2, 48
STEP = 300  # the proposal annealing active
LR = 1e-3
# Adam's update a step is at most 1.0014 lr in magnitude over two steps
# (Cauchy-Schwarz on the bias-corrected moments at b1 0.9, b2 0.999)
ADAM_STEP_BOUND = 1.0015 * LR
# where both packages' first moments share their sign and pass this, the
# first step is -lr sign(g) in both, up to float32 rounding
SIGN_FLOOR = 1e-10
GROUPS = {k: dict(lr=LR, lr_final=1e-4, max_steps=1000) for k in ("proposal_networks", "fields")}


def _config_kwargs():
    return small_config_kwargs(num_proposal_samples=(32, 16), num_nerf_samples=8)


def _t(x):
    return torch.from_numpy(np.array(x))


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree


def _batches(images, rows):
    cam, py, px = rows[:, 0], rows[:, 1], rows[:, 2]
    j = {"camera_indices": jnp.asarray(cam.astype(np.int32)), "pixel_x": jnp.asarray(px.astype(np.float32)),
         "pixel_y": jnp.asarray(py.astype(np.float32)), "image": jnp.asarray(images[cam, py, px])}
    t = {"camera_indices": _t(cam.astype(np.int64)), "pixel_x": _t(px.astype(np.float32)),
         "pixel_y": _t(py.astype(np.float32)), "image": _t(images[cam, py, px])}
    return j, t


class Setup:
    """Both packages' models, cameras, weights and steps, on one set of
    member weights (``draw_params``, tables +-2)."""

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        kw = _config_kwargs()
        self.jcfg, self.tcfg = jnerf.NerfactoConfig(**kw), tnerf.NerfactoConfig(**kw)
        self.jmodel = jnerf.NerfactoModel(self.jcfg)
        self.tmodel = tnerf.NerfactoModel(self.tcfg, device="cpu")
        self.jcams = j_hemisphere(N_CAMS, height=H, width=W, seed=1)
        self.tcams = t_hemisphere(N_CAMS, height=H, width=W, seed=1)
        self.images = rng.uniform(0, 1, (N_CAMS, H, W, 3)).astype(np.float32)
        like = interop.params_to_jax(self.tmodel.state_dict())
        trees = [draw_params(like, rng) for _ in range(M)]
        self.stacked = jax.tree_util.tree_map(lambda *xs: jnp.asarray(np.stack(xs)), *trees)
        self.tstacked = interop.ensemble_params_from_jax(jax.tree_util.tree_map(np.asarray, self.stacked))
        self.tx = jopt.make_optimizer(jax.tree_util.tree_map(lambda x: x[0], self.stacked),
                                      {k: jopt.OptimizerGroupConfig(**v) for k, v in GROUPS.items()})
        self.tgroups = {k: topt.OptimizerGroupConfig(**v) for k, v in GROUPS.items()}
        self.jstep = jpar.build_ensemble_train_step(self.jmodel, self.jcfg, self.jcams, self.tx)
        self.tstep = tpar.build_ensemble_train_step(self.tmodel, self.tcfg, self.tcams, self.tgroups, device="cpu")
        self.rng = rng

        def j_forward(params, rb, key, anneal):
            return self.jmodel.apply({"params": params}, rb, train=True, rngs_key=key,
                                     proposal_anneal=anneal)["sdist_list"]

        self.j_forward = jax.jit(j_forward)

        def j_edges(stacked, rb):
            # every member's eval sample edges (apply(train=True) without a key)
            return jax.vmap(lambda p: self.jmodel.apply({"params": p}, rb, train=True)["sdist_list"])(stacked)

        self.j_edges = jax.jit(j_edges)

    def fresh(self, n):
        return np.stack([self.rng.integers(0, N_CAMS, n), self.rng.integers(0, H, n),
                         self.rng.integers(0, W, n)], axis=1)

    def flipped(self, jparams, tparams, jb, tb, key, draws, step):
        """(R,) bool: rays with a lookup in another cell in any member's
        training forward, JAX's at ``jparams`` against the port's at
        ``tparams`` (stacked), on this batch and these draws."""
        anneal = jnerf.proposal_anneal_factor(jnp.int32(step), self.jcfg)
        j_rb = jcam.generate_rays(self.jcams, jb["camera_indices"], jb["pixel_x"], jb["pixel_y"])
        t_rb = tcam.generate_rays(self.tcams, tb["camera_indices"], tb["pixel_x"], tb["pixel_y"])
        keys = jax.random.split(jax.random.fold_in(key, 0), M)
        out = None
        for m in range(M):
            j_sdist = self.j_forward(jax.tree_util.tree_map(lambda x: x[m], jparams), j_rb, keys[m], anneal)
            with torch.no_grad():
                t_sdist = member_apply(
                    self.tmodel, {k: v[m] for k, v in tparams.items()},
                    lambda mdl, rb: mdl(rb, train=True, draws=draws[m],
                                        proposal_anneal=tnerf.proposal_anneal_factor(step, self.tcfg)),
                    t_rb)["sdist_list"]
            f = (lookup_cells_jax(self.jcfg, j_rb, j_sdist) != self.tmodel.lookup_cells(t_rb, t_sdist).numpy()).any(1)
            out = f if out is None else out | f
        return out

    def batch(self, jparams, tparams, key, step):
        """A batch of RAYS rays none of whose lookups flips a cell in any
        member between the packages (flipped rays replaced by fresh ones, so
        that JAX's draws for each row stay the same), its draws, and the
        rays replaced."""
        rows = self.fresh(RAYS)
        draws = jax_draws(self.jcfg, key, RAYS, per_member=M)
        replaced = 0
        for _ in range(6):
            jb, tb = _batches(self.images, rows)
            flipped = self.flipped(jparams, tparams, jb, tb, key, draws, step)
            if not flipped.any():
                return jb, tb, draws, replaced
            replaced += int(flipped.sum())
            rows[flipped] = self.fresh(int(flipped.sum()))
        raise AssertionError("rays keep flipping cells")


@pytest.fixture(scope="module")
def two_steps():
    """Two ensemble steps in both packages from the same weights, batches and
    draws: per step the losses, the stacked first moments and the
    parameters, JAX's and the port's."""
    s = Setup()
    jparams, jopt_state = s.stacked, jax.vmap(s.tx.init)(s.stacked)
    state = s.tstep.init(s.tstacked, step=STEP)
    start = {k: v.clone() for k, v in state.params.items()}
    steps = []
    for i in range(2):
        key = jax.random.PRNGKey(11 + i)
        jb, tb, draws, replaced = s.batch(jparams, state.params, key, STEP + i)
        jparams, jopt_state, jlosses = s.jstep(jparams, jopt_state, jb, key, jnp.int32(STEP + i))
        losses = s.tstep(state, tb, draws=draws)
        want_opt = interop.opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jopt_state))
        steps.append(dict(
            want_losses=np.asarray(jlosses), got_losses=losses.numpy(), replaced=replaced,
            want_mu=want_opt["exp_avg"], got_mu={k: v.clone() for k, v in state.moments["exp_avg"].items()},
            want_params=interop.ensemble_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)),
            got_params={k: v.clone() for k, v in state.params.items()},
            jopt_state=jopt_state,
        ))
    return dict(setup=s, start=start, steps=steps, init_opt_state=jax.vmap(s.tx.init)(s.stacked))


# -- init --------------------------------------------------------------------


def test_init_ensemble_params_matches_jax_layout():
    """Names in the same order, shapes and dtypes as
    ``ensemble_params_from_jax`` of JAX's ``init_ensemble_params``; the
    members' random leaves differ; member m is ``NerfactoModel`` built
    alone from seed base_seed + m, exactly."""
    from test_torch_ensemble import tiny_config_kwargs

    kw = tiny_config_kwargs()
    jmodel = jnerf.NerfactoModel(jnerf.NerfactoConfig(**kw))
    want = interop.ensemble_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax.jit(lambda: jpar.init_ensemble_params(jmodel, 3))()))
    got = tpar.init_ensemble_params(tnerf.NerfactoConfig(**kw), 3, base_seed=4, device="cpu")
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    for k, v in got.items():
        if k.endswith(("cells", "weight")):
            assert not torch.equal(v[0], v[1]) and not torch.equal(v[1], v[2]), k
    for m in range(3):
        alone = tnerf.NerfactoModel(tnerf.NerfactoConfig(**kw), device="cpu",
                                    generator=torch.Generator().manual_seed(4 + m)).state_dict()
        assert set(alone) == set(got)
        for k, v in alone.items():
            assert torch.equal(got[k][m], v), (m, k)


# -- the step against JAX ------------------------------------------------------


def check_step(got: dict, want: dict, start: dict, after: int, loss_rtol: float, mu_l2: float) -> None:
    """One package's ensemble state after ``after`` steps against another's
    from the same ``start`` parameters: ``losses`` (M,) within ``loss_rtol``;
    each member's first Adam moment ``mu`` (stacked, by name), which carries
    the gradient, within ``mu_l2`` in relative L2 norm per leaf (a cell
    table per level); each parameter's change from the start within 2 x
    ADAM_STEP_BOUND a step elementwise (Adam's steps are +-lr wherever a
    tiny gradient flips its sign), and after the first step within 1e-5 lr
    wherever both first moments share their sign past SIGN_FLOOR."""
    assert got["losses"].shape == want["losses"].shape
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=loss_rtol, atol=0)
    assert set(got["mu"]) == set(want["mu"]) == set(got["params"]) == set(start)
    moved = 0
    for k, want_mu in want["mu"].items():
        got_mu = got["mu"][k]
        for m in range(want_mu.shape[0]):
            assert grad_l2_error(k, got_mu[m], want_mu[m]) <= mu_l2, (k, m, grad_l2_error(k, got_mu[m], want_mu[m]))
        got_d = got["params"][k] - start[k]
        want_d = want["params"][k] - start[k]
        assert float((got_d - want_d).abs().max()) <= 2 * after * ADAM_STEP_BOUND, k
        if after == 1:
            same = (torch.sign(got_mu) == torch.sign(want_mu)) & (want_mu.abs() > SIGN_FLOOR) & (
                got_mu.abs() > SIGN_FLOOR)
            diff = (got_d - want_d)[same].abs()
            assert diff.numel() == 0 or float(diff.max()) <= 1e-5 * LR, (k, float(diff.max()))
            moved += int(same.sum())
    assert after != 1 or moved > 0


@pytest.mark.parametrize("after", [1, 2])
def test_ensemble_steps_match_jax(two_steps, after):
    """After one and after two steps against JAX's jitted
    ``build_ensemble_train_step`` (each member its own draws, the batch
    shared, rays that flipped a cell replaced), ``check_step``'s checks at
    TRAIN_LOSS_RTOL on the losses and CPU_TRAIN_GRAD_L2 on the first
    moments."""
    step = two_steps["steps"][after - 1]
    assert step["replaced"] <= MAX_FLIPPED_RAY_SHARE * RAYS * 6
    assert step["got_losses"].shape == (M,)
    check_step(dict(losses=step["got_losses"], mu=step["got_mu"], params=step["got_params"]),
               dict(losses=step["want_losses"], mu=step["want_mu"], params=step["want_params"]),
               two_steps["start"], after, TRAIN_LOSS_RTOL, CPU_TRAIN_GRAD_L2)


@pytest.mark.parametrize("when", ["init", "after_step"])
def test_ensemble_opt_state_converter_round_trips(two_steps, when):
    """``jax.vmap(tx.init)``'s stacked optax state, and the state after one
    JAX step, through ``opt_state_from_jax``, the ensemble state's
    ``load_state_dict`` and ``state_dict``, and ``opt_state_to_jax``:
    every leaf and the tree's structure come back bit for bit."""
    s = two_steps["setup"]
    like = two_steps["init_opt_state"] if when == "init" else two_steps["steps"][0]["jopt_state"]
    like = jax.tree_util.tree_map(np.asarray, like)
    state = s.tstep.init(s.tstacked)
    state.load_state_dict({"params": s.tstacked, "opt_state": interop.opt_state_from_jax(like)})
    back = interop.opt_state_to_jax(state.state_dict()["opt_state"], like)
    want, want_def = jax.tree_util.tree_flatten(like)
    got, got_def = jax.tree_util.tree_flatten(back)
    assert got_def == want_def
    for a, b in zip(want, got):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, b)
    if when == "after_step":
        assert [g["adam_count"] for g in state.optimizer.param_groups] == [1] * len(state.optimizer.param_groups)


# -- the step against a lone member --------------------------------------------


def test_members_equal_lone_steps_bit_for_bit(two_steps):
    """Two ensemble steps with the members' own generators: member m's
    losses, parameters and both Adam moments equal, bit for bit, two steps
    of a single-member trainer (``NerfactoTrainer``'s step on the same
    batch, with draws from a generator in the same state). ``launch`` of
    the same two batches from the restored state repeats them bit for bit."""
    s = two_steps["setup"]
    state = s.tstep.init(s.tstacked, seed=7, step=STEP)
    snapshot = _clone(state.state_dict())
    gens = [g.get_state() for g in state.generators]
    batches = [_batches(s.images, s.fresh(RAYS))[1] for _ in range(2)]
    losses = [s.tstep(state, b) for b in batches]
    for m in range(M):
        lone = NerfactoTrainer(s.tcfg, s.tcams, s.images, optimizer_groups=s.tgroups, device="cpu")
        lone.restore({"params": {k: v[m] for k, v in s.tstacked.items()}, "step": STEP})
        gen = torch.Generator().manual_seed(0)
        gen.set_state(gens[m])
        for i, b in enumerate(batches):
            lone.optimizer.zero_grad(set_to_none=True)
            total, _ = lone._loss_fn(b, lone._step_t, draws=lone.model.draw(RAYS, gen))
            total.backward()
            topt.apply_updates(lone.optimizer)
            lone._step_t += 1
            assert torch.equal(total.detach(), losses[i][m]), (m, i)
        for k, p in lone.model.named_parameters():
            assert torch.equal(p.detach(), state.params[k][m]), (m, k)
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(lone.optimizer.state[p][key], state.moments[key][k][m]), (m, k, key)
    after = {k: v.clone() for k, v in state.params.items()}
    state.load_state_dict(snapshot)
    rows = s.tstep.launch(state, {k: torch.stack([b[k] for b in batches]) for k in batches[0]})
    assert np.array_equal(rows, torch.stack(losses).numpy()) and state.step == STEP + 2
    for k, v in after.items():
        assert torch.equal(state.params[k], v), k


# -- the render ----------------------------------------------------------------


@pytest.mark.parametrize("parity", [True, False])
def test_ensemble_render_matches_jax(two_steps, rng, parity):
    """``build_ensemble_render`` against JAX's jitted one on the steps'
    members (tables +-2) at both ``parity_mode``s, with
    tests/test_torch_ensemble.py's bars: each member output its OUTPUT_TOLS
    entry, the combined variances MOMENT_TOL, the rays that flipped a cell
    in any member excluded; and equal to ``models/ensemble.py::
    ensemble_render`` bit for bit at parity_mode."""
    s = two_steps["setup"]
    jb, tb = bundles(rng, RAYS)
    want = {k: np.asarray(v) for k, v in jpar.build_ensemble_render(s.jmodel, parity_mode=parity)(s.stacked, jb).items()}
    got = tpar.build_ensemble_render(s.tmodel, parity_mode=parity)(s.tstacked, tb)
    j_edges = s.j_edges(s.stacked, jb)
    j_sdist = [[e[j] for e in j_edges] for j in range(M)]
    t_sdist = [member_apply(s.tmodel, {k: v[j] for k, v in s.tstacked.items()},
                            lambda mdl, rb: mdl(rb, return_intermediates=True)["sdist_list"], tb) for j in range(M)]
    _compare(want, {k: v.numpy() for k, v in got.items()}, flipped_rays(s.jmodel, s.tmodel, jb, tb, j_sdist, t_sdist))
    if parity:
        ref = ensemble_render(s.tmodel, s.tstacked, tb)
        assert set(ref) == set(got) and all(torch.equal(ref[k], got[k]) for k in ref)
    else:
        assert torch.equal(got["rgb_var"], got["rgb_var_combined"])


# -- port rules ----------------------------------------------------------------


def test_ensemble_step_without_cuda_raises(monkeypatch):
    """``device=None`` is the card, as everywhere in the port."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = _config_kwargs()
    model = tnerf.NerfactoModel(tnerf.NerfactoConfig(**kw), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpar.build_ensemble_train_step(model, model.config, t_hemisphere(N_CAMS, height=H, width=W))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpar.init_ensemble_params(tnerf.NerfactoConfig(**kw), 2)
