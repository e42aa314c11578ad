"""Parity of the port's splat refinement, capacity tuner and the trainer past
warmup against the JAX package, on the CPU, on shared inputs drawn with
numpy. The refinement's split samples are JAX's own draws, fed to the port
as ``eps``. Decision masks and counts must be equal; the floats hold the
tolerances stated in tests/torch_parity.py."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import SPLAT_LOSS_RTOL, SPLAT_MOMENT_TOL, SPLAT_STEP_PARAM_TOL, TOL
from test_torch_splat_model import trainer_pair

from uncertainty_nerf_gs_tpu.cameras.cameras import Cameras as JCameras
from uncertainty_nerf_gs_tpu.models import splatfacto as jsf

from uncertainty_nerf_gs_torch.cameras.cameras import Cameras as TCameras
from uncertainty_nerf_gs_torch.engine.splat_trainer import SplatfactoTrainer as TTrainer
from uncertainty_nerf_gs_torch.interop import (
    splat_params_from_jax,
    splat_trainer_state_from_jax,
    splat_trainer_state_to_jax,
)
from uncertainty_nerf_gs_torch.models import splatfacto as tsf

INFO_COUNTS = ("num_alive", "num_split", "num_dup", "num_culled", "num_nonfinite",
               "num_dropped_capacity", "num_budget_capped")


def jax_refine_eps(key, cfg):
    """The standard normal draws JAX's refine_gaussians takes from ``key``."""
    return np.array(jax.random.normal(jax.random.split(key)[0], (cfg.n_split_samples, cfg.capacity, 3)))


def _toy_params(cap: int) -> dict[str, np.ndarray]:
    """tests/test_splat.py's hand-built buffer: every alive slot a split
    candidate (unit scales, opacity about 0.95)."""
    return {
        "means": np.arange(cap * 3, dtype=np.float32).reshape(cap, 3),
        "scales": np.zeros((cap, 3), np.float32),
        "quats": np.tile(np.float32([[1.0, 0.0, 0.0, 0.0]]), (cap, 1)),
        "opacities": np.full((cap,), 3.0, np.float32),
        "features_dc": np.zeros((cap, 3), np.float32),
        "features_rest": np.zeros((cap, 3, 3), np.float32),
    }


def _state(alive, grad_accum, vis_count, max_radii):
    return dict(alive=np.asarray(alive, bool), grad_accum=np.asarray(grad_accum, np.float32),
                vis_count=np.asarray(vis_count, np.int32), max_radii=np.asarray(max_radii, np.float32))


def _random_buffer(rng, cap=96, n_alive=70):
    """Random Gaussians with log-uncertainties in a partly filled buffer:
    averages of the screen gradient spread over decades around the default
    threshold, screen radii around both screen thresholds, some large
    scales and low opacities, and the dead slots left dirty."""
    alive = np.zeros(cap, bool)
    alive[rng.permutation(cap)[:n_alive]] = True
    p = {
        "means": rng.normal(size=(cap, 3)).astype(np.float32),
        "scales": (rng.uniform(-8.0, -2.0, (cap, 3))
                   + 2.5 * (rng.uniform(size=(cap, 1)) < 0.15)).astype(np.float32),
        "quats": rng.normal(size=(cap, 4)).astype(np.float32),
        "opacities": rng.normal(0.0, 2.0, cap).astype(np.float32),
        "features_dc": rng.normal(size=(cap, 3)).astype(np.float32),
        "features_rest": rng.normal(size=(cap, 3, 3)).astype(np.float32),
        "log_uncertainties": rng.normal(size=(cap, 1)).astype(np.float32),
    }
    vis = rng.integers(0, 6, cap)
    avg = np.float32(10.0) ** rng.uniform(-5.0, -1.5, cap).astype(np.float32)
    state = _state(alive, avg * vis, vis, rng.uniform(0.0, 0.3, cap))
    return p, state


def refine_case(case, rng):
    """(params, state, config kwargs, step) of a named case."""
    if case.startswith("saturated"):
        cap = 32
        return (_toy_params(cap), _state(np.ones(cap), np.ones(cap), np.ones(cap), np.zeros(cap)),
                dict(capacity=cap, n_split_samples=2, refine_cap_to_budget=case == "saturated"), 1000)
    if case == "partial_budget":
        cap, n_alive = 32, 27  # 5 free slots, each split funds 1 child
        alive = np.arange(cap) < n_alive
        grads = np.where(alive, np.float32(0.01) * (1.0 + np.arange(cap, dtype=np.float32)), 0.0)
        return (_toy_params(cap), _state(alive, grads, np.ones(cap), np.zeros(cap)),
                dict(capacity=cap, n_split_samples=2), 1000)
    if case == "nonfinite":
        cap = 16
        p = _toy_params(cap)
        p["means"][3] = np.nan
        p["scales"][5] = np.inf
        return (p, _state(np.ones(cap), np.zeros(cap), np.ones(cap), np.zeros(cap)),
                dict(capacity=cap, num_random=cap), 1000)
    step = int(case.split("_")[1])
    p, state = _random_buffer(rng)
    # screen tests after step 100, scale culls after step 50
    return p, state, dict(capacity=96, n_split_samples=3, stop_screen_size_at=100, refine_every=10,
                          reset_alpha_every=5, sh_degree=1, uncertainty_channels=1), step


def refine_pair(p, state, cfg_kw, step, seed=0, scene_extent=1.0):
    key = jax.random.PRNGKey(seed)
    jcfg, tcfg = jsf.SplatfactoConfig(**cfg_kw), tsf.SplatfactoConfig(**cfg_kw)
    j = jsf.refine_gaussians(key, {k: jnp.asarray(v) for k, v in p.items()},
                             jsf.SplatState(**{k: jnp.asarray(v) for k, v in state.items()}),
                             jcfg, step, scene_extent=scene_extent)
    t = tsf.refine_gaussians(splat_params_from_jax(p),
                             tsf.SplatState(**{k: torch.from_numpy(v) for k, v in state.items()}),
                             tcfg, step, scene_extent=scene_extent,
                             eps=torch.from_numpy(jax_refine_eps(key, jcfg)))
    return j, t


@pytest.mark.parametrize("case", ["saturated", "saturated_uncapped", "partial_budget", "nonfinite",
                                  "random_40", "random_75", "random_150"])
def test_refine_gaussians_matches_jax(rng, case):
    """Masks and counts equal, the admitted splits and dups too; the rows a
    dup copied, and every leaf but the split means and scales, bit for bit;
    the split samples within TOL."""
    p, state, cfg_kw, step = refine_case(case, rng)
    (jp, jstate, jinfo), (tp, tstate, tinfo) = refine_pair(p, state, cfg_kw, step)
    assert set(tinfo) == set(jinfo)
    for k in INFO_COUNTS:
        assert int(tinfo[k]) == int(jinfo[k]), k
    np.testing.assert_array_equal(tinfo["touched_slots"].numpy(), np.asarray(jinfo["touched_slots"]))
    np.testing.assert_array_equal(tstate.alive.numpy(), np.asarray(jstate.alive))
    for k in ("grad_accum", "vis_count", "max_radii"):
        got = getattr(tstate, k).numpy()
        assert not got.any() and got.dtype == np.asarray(getattr(jstate, k)).dtype, k
    for k, want in jp.items():
        got, want = tp[k].numpy(), np.asarray(want)
        if k in ("means", "scales"):
            np.testing.assert_allclose(got, want, err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    # refine_decisions admits what the JAX rules admit, and what info counts
    splits, dups, capped = tsf.refine_decisions(
        splat_params_from_jax(p), tsf.SplatState(**{k: torch.from_numpy(v) for k, v in state.items()}),
        tsf.SplatfactoConfig(**cfg_kw), step)
    want_splits, want_dups = _decisions(p, state, cfg_kw, step)
    np.testing.assert_array_equal(splits.numpy(), want_splits)
    np.testing.assert_array_equal(dups.numpy(), want_dups)
    assert (int(splits.sum()), int(capped)) == (int(jinfo["num_split"]), int(jinfo["num_budget_capped"]))
    # the dups are the first new rows, so they take the first free slots
    dups = np.flatnonzero(want_dups)
    assert len(dups) == int(jinfo["num_dup"])
    dest = np.flatnonzero(~state["alive"])[:len(dups)]
    for k in p:
        np.testing.assert_array_equal(tp[k].numpy()[dest], p[k][dups], err_msg=k)
    if case == "saturated":
        assert int(tinfo["num_budget_capped"]) == 32 and not tinfo["touched_slots"].any()
    if case == "partial_budget":
        assert int(tinfo["num_split"]) == 5 and tinfo["touched_slots"][22:27].all()
    if case == "nonfinite":
        assert int(tinfo["num_nonfinite"]) == 2 and not tstate.alive[[3, 5]].any()
    if case.startswith("random"):
        assert int(tinfo["num_split"]) and int(tinfo["num_dup"]) and int(tinfo["num_culled"]), tinfo


def _decisions(p, state, cfg_kw, step):
    """The split and dup masks refine_gaussians admits, from the JAX
    package's own rules: high-gradient, large (or, past
    stop_screen_size_at, large on screen) or small and not split, within
    the budget."""
    cfg = jsf.SplatfactoConfig(**cfg_kw)
    avg = state["grad_accum"] / np.maximum(state["vis_count"], 1)
    high = (avg > np.float32(cfg.densify_grad_thresh)) & state["alive"]
    splits = high & (np.exp(p["scales"]).max(-1) > np.float32(cfg.densify_size_thresh))
    if step > cfg.stop_screen_size_at:
        splits |= state["alive"] & (state["max_radii"] > np.float32(cfg.split_screen_size))
    dups = high & ~splits & (step < cfg.stop_split_at)
    splits &= step < cfg.stop_split_at
    if cfg.refine_cap_to_budget:
        cost = np.where(splits, cfg.n_split_samples - 1, 0) + np.where(dups, 1, 0)
        order = np.argsort(-np.where(splits | dups, avg, -np.inf), kind="stable")
        keep = np.zeros_like(dups)
        keep[order] = np.cumsum(cost[order]) <= (~state["alive"]).sum()
        splits &= keep
        dups &= keep
    return splits, dups


@pytest.mark.parametrize("n_alive,n_want", [(20, 6), (28, 9)], ids=["fits", "overflows"])
def test_compact_into_free_matches_jax(rng, n_alive, n_want):
    """Rows go to the free slots in rank order and beyond them are dropped
    and counted: params, alive, the count and the written mask equal."""
    cap = 32
    p, _ = _random_buffer(rng, cap=cap, n_alive=n_alive)
    alive = np.zeros(cap, bool)
    alive[rng.permutation(cap)[:n_alive]] = True
    state = _state(alive, np.zeros(cap), np.zeros(cap), np.zeros(cap))
    new = {k: rng.normal(size=(2 * cap,) + v.shape[1:]).astype(np.float32) for k, v in p.items()}
    want_new = np.zeros(2 * cap, bool)
    want_new[rng.permutation(2 * cap)[:n_want]] = True
    j = jsf._compact_into_free({k: jnp.asarray(v) for k, v in p.items()},
                               jsf.SplatState(**{k: jnp.asarray(v) for k, v in state.items()}),
                               {k: jnp.asarray(v) for k, v in new.items()}, jnp.asarray(want_new))
    t = tsf._compact_into_free(splat_params_from_jax(p),
                               tsf.SplatState(**{k: torch.from_numpy(v) for k, v in state.items()}),
                               splat_params_from_jax(new), torch.from_numpy(want_new))
    for k in p:
        np.testing.assert_array_equal(t[0][k].numpy(), np.asarray(j[0][k]), err_msg=k)
    for got, want in zip(t[1:], j[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(t[2]) == max(0, n_want - (cap - n_alive))


# -- the capacity tuner ----------------------------------------------------------

def _tuner_scene(n_cams=3):
    """tests/test_capacity_tuner.py's scene: 400 random Gaussians, cameras
    at radius 3 looking at the origin, 64x48, a tiny rasterize capacity."""
    cfg_kw = dict(capacity=512, num_random=400, random_scale=1.0, rasterize_capacity=64,
                  rasterize_capacity_auto=True, sh_degree=1)
    params, state = jsf.init_gaussians(jax.random.PRNGKey(0), jsf.SplatfactoConfig(**cfg_kw))
    c2ws = []
    for i in range(n_cams):
        th = 2 * np.pi * i / n_cams
        pos = np.array([3 * np.sin(th), 0.0, 3 * np.cos(th)])
        z = pos / np.linalg.norm(pos)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        c2ws.append(np.stack([x, np.cross(z, x), z, pos], axis=-1))
    c2ws = np.stack(c2ws).astype(np.float32)
    intr = {k: np.full((n_cams,), v, np.float32) for k, v in dict(fx=60.0, fy=60.0, cx=32.0, cy=24.0).items()}
    jcams = JCameras(camera_to_worlds=jnp.asarray(c2ws), width=64, height=48,
                     **{k: jnp.asarray(v) for k, v in intr.items()})
    tcams = TCameras(camera_to_worlds=torch.from_numpy(c2ws), width=64, height=48,
                     **{k: torch.from_numpy(v) for k, v in intr.items()})
    p = {k: np.asarray(v) for k, v in params.items()}
    return cfg_kw, p, np.asarray(state.alive), jcams, tcams


@pytest.mark.parametrize("capacity_max", [4096, 128])
def test_probe_and_tune_match_jax(capacity_max):
    """Every camera's tile and row counts equal, and the tuned capacities
    equal JAX's as integers (also where rasterize_capacity_max clamps)."""
    cfg_kw, p, alive, jcams, tcams = _tuner_scene()
    cfg_kw["rasterize_capacity_max"] = capacity_max
    jcfg, tcfg = jsf.SplatfactoConfig(**cfg_kw), tsf.SplatfactoConfig(**cfg_kw)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = splat_params_from_jax(p)
    for i in range(len(tcams)):
        cam = jax.tree.map(lambda x: x[i], jcams)
        jc = jsf.probe_tile_counts(jp, jnp.asarray(alive), cam.camera_to_worlds, cam.fx, cam.fy,
                                   cam.cx, cam.cy, 64, 48, jcfg)
        tc = tsf.probe_tile_counts(tp, torch.from_numpy(alive), tcams.camera_to_worlds[i],
                                   *(float(getattr(tcams, a)[i]) for a in ("fx", "fy", "cx", "cy")),
                                   64, 48, tcfg)
        np.testing.assert_array_equal(tc.tile.numpy(), np.asarray(jc.tile))
        np.testing.assert_array_equal(tc.row.numpy(), np.asarray(jc.row))
    jt = jsf.tune_rasterize_capacity(jcfg, jp, jnp.asarray(alive), jcams)
    tt = tsf.tune_rasterize_capacity(tcfg, tp, torch.from_numpy(alive), tcams)
    assert (tt.rasterize_capacity, tt.rasterize_row_capacity) == (
        jt.rasterize_capacity, jt.rasterize_row_capacity)
    assert tt.rasterize_capacity > 64 and tt.rasterize_capacity % 64 == 0
    if capacity_max == 128:
        assert tt.rasterize_capacity == 128


def test_trainer_tunes_at_start_and_retune_never_shrinks():
    """``rasterize_capacity_auto`` tunes at construction; ``retune_capacity``
    reports no change while the budget holds, keeps a larger budget, and
    grows a smaller one back to the tuned value."""
    cfg_kw, _, _, _, tcams = _tuner_scene()
    images = np.random.default_rng(3).uniform(size=(3, 48, 64, 3)).astype(np.float32)
    tr = TTrainer(tsf.SplatfactoConfig(**cfg_kw), tcams, images, device="cpu")
    tuned = tsf.tune_rasterize_capacity(tsf.SplatfactoConfig(**cfg_kw), tr.params, tr.splat_state.alive,
                                        tr.cameras)
    assert tr.config == tuned and tr.config.rasterize_capacity > 64
    assert tr.retune_capacity() is False and tr.config == tuned
    tr.config = dataclasses.replace(tuned, rasterize_capacity=2 * tuned.rasterize_capacity)
    assert tr.retune_capacity() is False
    assert tr.config.rasterize_capacity == 2 * tuned.rasterize_capacity
    tr.config = dataclasses.replace(tuned, rasterize_capacity=64)
    assert tr.retune_capacity() is True
    assert tr.config.rasterize_capacity == tuned.rasterize_capacity
    assert tr.config.rasterize_row_capacity == tuned.rasterize_row_capacity
    # capacity_retune_every grows it inside train_step
    tr.config = dataclasses.replace(tr.config, rasterize_capacity=64, capacity_retune_every=1)
    tr.train_step()
    assert tr.config.rasterize_capacity == tuned.rasterize_capacity


# -- the trainer past warmup ---------------------------------------------------

# refines at steps 4 and 10 (the second with scale and screen culls), an
# opacity reset at 6
SCHEDULE = dict(warmup_length=2, refine_every=2, reset_alpha_every=3, stop_screen_size_at=5,
                densify_size_thresh=0.095, cull_screen_size=0.4)


def _moments(state):
    """{group: (Adam count, schedule count, exp_avg, exp_avg_sq)} of a port
    state dict."""
    opt = state["opt_state"]
    return {k: (opt["groups"][k]["adam_count"], opt["groups"][k]["schedule_count"],
                opt["exp_avg"][k], opt["exp_avg_sq"][k]) for k in opt["groups"]}


def trainer_deviations(jtr, ttr) -> dict[str, float]:
    """Each parameter's and each group's moments' largest deviation from
    JAX's as a share of its bar (1.0 at the bar), after checking the exact
    parts: step, last reset, alive mask, visit counts, Adam and schedule
    counts."""
    want = splat_trainer_state_from_jax(jtr.state_dict())
    got = ttr.state_dict()
    assert got["step"] == want["step"] and got["last_opacity_reset"] == want["last_opacity_reset"]
    np.testing.assert_array_equal(got["splat_alive"], want["splat_alive"])
    np.testing.assert_array_equal(ttr.splat_state.vis_count.numpy(), np.asarray(jtr.splat_state.vis_count))

    def share(g, w, atol, rtol):
        return float(((g - w).abs() / (atol + rtol * w.abs())).max())

    out = {k: share(got["params"][k], v, **SPLAT_STEP_PARAM_TOL) for k, v in want["params"].items()}
    gm, wm = _moments(got), _moments(want)
    for k, (count, sched, mu, nu) in wm.items():
        assert gm[k][:2] == (count, sched), k
        for name, g, w in (("exp_avg", gm[k][2], mu), ("exp_avg_sq", gm[k][3], nu)):
            tol = SPLAT_MOMENT_TOL
            out[f"{k}.{name}"] = share(g, w, tol["atol"] * float(w.abs().max()), tol["rtol"])
    return out


def refining_run():
    """Both trainers from one state three steps in (JAX's, with its real
    Adam moments, through ``splat_trainer_state_from_jax``), then over the
    same cameras through a refine at 4, an opacity reset at 6 and a refine
    at 10, JAX's refine draws fed to the port. Yields (step, jtr, ttr,
    j_losses, t_losses) after the restore (losses None) and each step."""
    jtr, ttr = trainer_pair(**SCHEDULE)
    key = jax.random.PRNGKey(1)
    for _ in range(3):
        jtr.train_step(key)
    jtr.restore(jtr.state_dict())  # the strategy statistics start at zero in both
    ttr.restore(splat_trainer_state_from_jax(jtr.state_dict()))
    ttr._cam_rng = copy.deepcopy(jtr._cam_rng)
    yield 3, jtr, ttr, None, None
    for step in range(4, 11):
        draws = jax_refine_eps(jax.random.fold_in(jax.random.PRNGKey(0), step), jtr.config)
        j_losses = jtr.train_step(key)
        yield step, jtr, ttr, j_losses, ttr.train_step(refine_eps=torch.from_numpy(draws))


def test_trainer_refines_like_jax(monkeypatch):
    """``refining_run``: losses, parameters, alive masks, visit counts, and
    every group's Adam counts and moments after each step; each refine's
    counts and touched slots. At each refine every live average gradient
    must lie clear of the threshold by ten times the largest relative error
    between the two packages' statistics, so that a flipped decision fails
    here rather than as a mismatch."""
    seen = {}

    def recording(module, name):
        original = module.refine_gaussians

        def wrapper(*args, **kwargs):
            out = original(*args, **kwargs)
            seen.setdefault(name, []).append((args[2] if name == "jax" else args[1], out[2]))
            return out

        monkeypatch.setattr(module, "refine_gaussians", wrapper)

    recording(jsf, "jax")
    recording(tsf, "port")
    refined = []
    for step, jtr, ttr, j_losses, t_losses in refining_run():
        if j_losses is not None:
            assert set(t_losses) == set(j_losses), step
            for k, v in j_losses.items():
                assert t_losses[k] == pytest.approx(v, rel=SPLAT_LOSS_RTOL), (step, k)
            if "num_alive" in t_losses:
                refined.append(step)
                touched = seen["port"][-1][1]["touched_slots"]
                assert touched.any()
                for k, opt in ttr.optimizers.items():
                    for st in opt.state.values():
                        assert not st["exp_avg"][touched].any() and not st["exp_avg_sq"][touched].any(), k
        dev = trainer_deviations(jtr, ttr)
        assert max(dev.values()) <= 1.0, (step, {k: v for k, v in dev.items() if v > 1.0})
        if step == 6:
            assert ttr._last_opacity_reset == 6 and not ttr.optimizers["opacities"].state
            assert ttr.optimizers["opacities"].param_groups[0]["count"] == 0
    assert refined == [4, 10] and len(seen["jax"]) == len(seen["port"]) == 2
    thresh = np.float32(jtr.config.densify_grad_thresh)
    for (j_state, j_info), (t_state, t_info) in zip(seen["jax"], seen["port"]):
        for k in INFO_COUNTS:
            assert int(t_info[k]) == int(j_info[k]), k
        np.testing.assert_array_equal(t_info["touched_slots"].numpy(), np.asarray(j_info["touched_slots"]))
        live = np.asarray(j_state.alive)
        j_avg = (np.asarray(j_state.grad_accum) / np.maximum(np.asarray(j_state.vis_count), 1))[live]
        t_avg = (t_state.grad_accum / torch.clamp(t_state.vis_count, min=1)).numpy()[live]
        err = float(np.max(np.abs(t_avg - j_avg) / np.maximum(j_avg, 1e-30)))
        assert 0 < err < 1e-4
        assert np.all(np.abs(j_avg - thresh) > 10 * err * thresh), (err, np.sort(np.abs(j_avg - thresh))[:3])
    # each refine splits and culls, the first also duplicates, the second
    # also culls by scale and screen size
    infos = [{k: int(i[k]) for k in INFO_COUNTS} for _, i in seen["port"]]
    assert all(i["num_split"] and i["num_culled"] for i in infos) and infos[0]["num_dup"], infos


def test_camera_optimizer_matches_jax():
    """Two steps with the camera optimizer: losses, the updated parameters
    and every camera's SO3xR3 tangent against JAX's."""
    jtr, ttr = trainer_pair(use_camera_optimizer=True)
    key = jax.random.PRNGKey(1)
    for step in range(2):
        j_losses = jtr.train_step(key)
        t_losses = ttr.train_step()
        for k, v in j_losses.items():
            assert t_losses[k] == pytest.approx(v, rel=SPLAT_LOSS_RTOL), (step, k)
        want = np.asarray(jtr.camera_opt)
        np.testing.assert_allclose(ttr.camera_opt.detach().numpy(), want, err_msg=f"step {step}",
                                   **SPLAT_STEP_PARAM_TOL)
        for k, v in jtr.params.items():
            np.testing.assert_allclose(ttr.params[k].detach().numpy(), np.asarray(v),
                                       err_msg=f"step {step}: {k}", **SPLAT_STEP_PARAM_TOL)
    assert np.abs(want).max() > 0 and ttr.cam_optimizer.state


def test_splat_trainer_state_round_trips_bit_exact():
    """The JAX trainer's whole state (two steps in, the camera optimizer on,
    so every moment is live) -> the port -> JAX, and the port's restored
    state -> JAX -> the port, leaf for leaf."""
    jtr, ttr = trainer_pair(use_camera_optimizer=True)
    key = jax.random.PRNGKey(1)
    for _ in range(2):
        jtr.train_step(key)
    like = jtr.state_dict()
    ported = splat_trainer_state_from_jax(like)
    back = splat_trainer_state_to_jax(ported, like)
    flat_like, tree_like = jax.tree.flatten(like)
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree_back == tree_like
    for got, want in zip(flat_back, flat_like):
        want = np.asarray(want)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert ported["opt_state"]["groups"]["means"] == {"adam_count": 2, "schedule_count": 2}
    ttr.restore(ported)
    again = splat_trainer_state_from_jax(splat_trainer_state_to_jax(ttr.state_dict(), like))
    state = ttr.state_dict()
    for got, want in zip(jax.tree.leaves(again), jax.tree.leaves(state)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and np.array_equal(got, want)
