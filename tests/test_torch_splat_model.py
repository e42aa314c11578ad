"""Parity of the port's splat model and trainer against the JAX package, on
the CPU, on shared parameters (``interop.splat_params_from_jax``). The JAX
side composites with its Pallas kernels in interpret mode
(``rasterize_backend="pallas"``). Scenes have no capacity overflow, so a
last-bit difference in a projection cannot change which Gaussians survive
truncation. Tolerances are stated in tests/torch_parity.py; the numbers
behind the trainer's come from ``python tests/torch_parity_report.py``."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    SPLAT_FWD_TOL,
    SPLAT_GRAD_TOL,
    SPLAT_LOSS_RTOL,
    SPLAT_OUTPUT_TOLS,
    SPLAT_STEP_PARAM_TOL,
    TOL,
    grad_mismatch,
)

from uncertainty_nerf_gs_tpu.data.synthetic import hemisphere_cameras as j_hemisphere
from uncertainty_nerf_gs_tpu.engine import optimizers as jopt
from uncertainty_nerf_gs_tpu.engine.splat_trainer import SplatfactoTrainer as JTrainer
from uncertainty_nerf_gs_tpu.models import splatfacto as jsf

from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras as t_hemisphere
from uncertainty_nerf_gs_torch.engine import optimizers as topt
from uncertainty_nerf_gs_torch.engine.splat_trainer import SplatfactoTrainer as TTrainer
from uncertainty_nerf_gs_torch.interop import splat_params_from_jax, splat_params_to_jax
from uncertainty_nerf_gs_torch.models import splatfacto as tsf

W, H = 64, 48
# at z = +2.5 looking along -z (OpenGL), the scene in front of it
C2W = np.array([[1.0, 0, 0, 0.1], [0, 1.0, 0, -0.05], [0, 0, 1.0, 2.5]], np.float32)
INTRINSICS = (40.0, 40.0, 32.0, 24.0)


def _config_kwargs(**overrides) -> dict:
    kw = dict(capacity=256, num_random=100, random_scale=0.6, rasterize_capacity=256,
              sh_degree=1, uncertainty_channels=1, rasterize_backend="pallas",
              background_color="white")
    kw.update(overrides)
    return kw


def _params(rng, cfg):
    """JAX-initialized parameters as numpy, with features, log-scales and
    opacities drawn from ``rng`` so that every parameter matters."""
    params, state = jsf.init_gaussians(jax.random.PRNGKey(0), cfg)
    p = {k: np.array(v) for k, v in params.items()}
    alive = np.asarray(state.alive)
    n = int(alive.sum())
    p["features_dc"][:n] = rng.normal(size=(n, 3)).astype(np.float32)
    p["features_rest"][:n] = 0.3 * rng.normal(size=p["features_rest"][:n].shape).astype(np.float32)
    p["opacities"][:n] = rng.normal(size=n).astype(np.float32)
    p["scales"][:n] += rng.uniform(-0.5, 0.3, (n, 3)).astype(np.float32)
    return p, alive


def _render_pair(p, alive, cfg_kw, **kwargs):
    j_out = jsf.render_splat(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(alive), jnp.asarray(C2W),
        *INTRINSICS, W, H, jsf.SplatfactoConfig(**cfg_kw), **kwargs,
    )
    t_kwargs = {k: torch.from_numpy(np.asarray(v)) if k == "background" else v
                for k, v in kwargs.items()}
    t_out = tsf.render_splat(
        splat_params_from_jax(p), torch.from_numpy(alive), torch.from_numpy(C2W),
        *INTRINSICS, W, H, tsf.SplatfactoConfig(**cfg_kw), **t_kwargs,
    )
    return j_out, t_out


def test_splat_params_round_trip_bit_exact(rng):
    p, _ = _params(rng, jsf.SplatfactoConfig(**_config_kwargs()))
    back = splat_params_to_jax(splat_params_from_jax(p))
    assert list(back) == list(p)
    for k in p:
        assert back[k].dtype == p[k].dtype and np.array_equal(back[k], p[k]), k
    with pytest.raises(KeyError):
        splat_params_from_jax({"kernel": p["means"]})


def test_init_gaussians_matches_jax(rng):
    """From given points and colors the buffers agree within 1e-6; the
    random quats come from each package's own generator and are unit."""
    cfg_kw = _config_kwargs(capacity=160, sh_degree=2)
    points = rng.uniform(-1, 1, (120, 3)).astype(np.float32)
    colors = rng.uniform(0, 1, (120, 3)).astype(np.float32)
    jp, jstate = jsf.init_gaussians(jax.random.PRNGKey(3), jsf.SplatfactoConfig(**cfg_kw),
                                    jnp.asarray(points), jnp.asarray(colors))
    tp, tstate = tsf.init_gaussians(torch.Generator().manual_seed(3),
                                    tsf.SplatfactoConfig(**cfg_kw),
                                    torch.from_numpy(points), torch.from_numpy(colors))
    assert list(tp) == list(jp)
    for k in ("means", "scales", "opacities", "features_dc", "features_rest"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0, err_msg=k)
    np.testing.assert_array_equal(tstate.alive.numpy(), np.asarray(jstate.alive))
    q = tp["quats"].numpy()
    np.testing.assert_allclose(np.linalg.norm(q[:120], axis=-1), 1.0, atol=1e-6)
    assert not q[120:].any() and not tp["log_uncertainties"][120:].any()
    assert tp["log_uncertainties"].shape == (160, 1)


@pytest.mark.parametrize("active", [False, True], ids=["splatfacto", "active"])
@pytest.mark.parametrize("depth_var_mode", ["moments", "indirection"])
def test_render_splat_matches_jax(rng, active, depth_var_mode):
    """Every output key of render_splat on shared parameters, within the
    forward tolerance; the cull and the overflow exactly."""
    cfg_kw = _config_kwargs(uncertainty_channels=int(active), depth_var_mode=depth_var_mode)
    p, alive = _params(rng, jsf.SplatfactoConfig(**cfg_kw))
    j_out, t_out = _render_pair(p, alive, cfg_kw, background=np.float32([0.2, 0.5, 0.9]))
    assert set(t_out) == set(j_out)
    assert int(t_out["raster_overflow"]) == int(j_out["raster_overflow"]) == 0
    np.testing.assert_array_equal(t_out["visible"].numpy(), np.asarray(j_out["visible"]))
    assert 0.2 < float(t_out["accumulation"].mean()) < 0.95
    for k, want in j_out.items():
        got = t_out[k].detach().numpy()
        assert got.shape == np.shape(want) and np.isfinite(got).all(), k
        np.testing.assert_allclose(got, np.asarray(want), err_msg=k,
                                   **SPLAT_OUTPUT_TOLS.get(k, SPLAT_FWD_TOL))


def test_splatfacto_loss_and_grads_match_jax(rng):
    """Active-splatfacto loss and its gradients with respect to every
    parameter and the screen-space tap, then accumulate_stats, against
    jax.value_and_grad; gradients relative to their largest entry."""
    cfg_kw = _config_kwargs()
    jcfg, tcfg = jsf.SplatfactoConfig(**cfg_kw), tsf.SplatfactoConfig(**cfg_kw)
    p, alive = _params(rng, jcfg)
    gt = rng.uniform(size=(H, W, 3)).astype(np.float32)
    bg = np.ones(3, np.float32)

    def j_loss(params, tap):
        out = jsf.render_splat(params, jnp.asarray(alive), jnp.asarray(C2W), *INTRINSICS, W, H,
                               jcfg, sh_deg=1, background=jnp.asarray(bg), means2d_tap=tap)
        total, losses = jsf.splatfacto_loss(out, jnp.asarray(gt), params, jcfg)
        return total, (losses, out["radii"], out["visible"])

    (j_total, (j_losses, j_radii, j_vis)), (j_g, j_tap) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True
    )({k: jnp.asarray(v) for k, v in p.items()}, jnp.zeros((256, 2)))

    tp = {k: v.requires_grad_(True) for k, v in splat_params_from_jax(p).items()}
    tap = torch.zeros((256, 2), requires_grad=True)
    out = tsf.render_splat(tp, torch.from_numpy(alive), torch.from_numpy(C2W), *INTRINSICS, W, H,
                           tcfg, sh_deg=1, background=torch.from_numpy(bg), means2d_tap=tap)
    total, losses = tsf.splatfacto_loss(out, torch.from_numpy(gt), tp, tcfg)
    total.backward()
    assert set(losses) == set(j_losses) == {"nll_loss", "opacity_loss", "ssim_loss"}
    for k in losses:
        assert float(losses[k]) == pytest.approx(float(j_losses[k]), rel=SPLAT_LOSS_RTOL), k
    for k, g in tp.items():
        assert tp[k].grad.abs().max() > 0, k
        bad = grad_mismatch(tp[k].grad, torch.from_numpy(np.asarray(j_g[k])))
        assert not bad.any(), f"{k}: {int(bad.sum())} entries"
    assert not grad_mismatch(tap.grad, torch.from_numpy(np.asarray(j_tap))).any()

    j_state = jsf.accumulate_stats(
        jsf.SplatState(jnp.asarray(alive), jnp.zeros(256), jnp.zeros(256, jnp.int32),
                       jnp.zeros(256)), j_tap, j_radii, j_vis, W, H,
    )
    t_state = tsf.accumulate_stats(
        tsf.SplatState(torch.from_numpy(alive), torch.zeros(256), torch.zeros(256, dtype=torch.int32),
                       torch.zeros(256)), tap.grad, out["radii"].detach(), out["visible"], W, H,
    )
    np.testing.assert_array_equal(t_state.vis_count.numpy(), np.asarray(j_state.vis_count))
    np.testing.assert_allclose(t_state.max_radii.numpy(), np.asarray(j_state.max_radii), **TOL)
    scale = float(np.abs(np.asarray(j_state.grad_accum)).max())
    np.testing.assert_allclose(t_state.grad_accum.numpy(), np.asarray(j_state.grad_accum),
                               atol=SPLAT_GRAD_TOL["atol"] * scale,
                               rtol=SPLAT_GRAD_TOL["rtol"])


@pytest.mark.parametrize("group", [
    dict(lr=1.6e-4, lr_final=1.6e-6, max_steps=30_000),
    dict(lr=5e-3, lr_final=5e-3, max_steps=30_000),
    dict(lr=1e-2, lr_final=1e-4, max_steps=200_000, warmup_steps=200),
])
def test_exp_decay_schedule_matches_optax(group):
    """The port's schedule in float64 against optax's in float32: optax's
    warmup, (init - end) (1 - t / T) + end, cancels to about 2e-6."""
    j_sched = jopt.exp_decay_schedule(jopt.OptimizerGroupConfig(**group))
    t_sched = topt.exp_decay_schedule(topt.OptimizerGroupConfig(**group))
    for step in (0, 1, 2, 150, 200, 201, 5_000, 30_000, 250_000):
        assert t_sched(step) == pytest.approx(float(j_sched(step)), rel=1e-5), step


def test_sh_ramp_and_opacity_reset_match_jax(rng):
    cfg_kw = _config_kwargs(sh_degree=3, sh_degree_interval=1000)
    for step in (0, 999, 1000, 2500, 10_000):
        assert tsf.active_sh_degree(step, tsf.SplatfactoConfig(**cfg_kw)) == int(
            jsf.active_sh_degree(jnp.int32(step), jsf.SplatfactoConfig(**cfg_kw)))
    p, _ = _params(rng, jsf.SplatfactoConfig(**cfg_kw))
    want = jsf.reset_opacities({k: jnp.asarray(v) for k, v in p.items()},
                               jsf.SplatfactoConfig(**cfg_kw))
    got = tsf.reset_opacities(splat_params_from_jax(p), tsf.SplatfactoConfig(**cfg_kw))
    for k in p:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, rtol=0, err_msg=k)


def trainer_pair(num_cameras=3, use_camera_optimizer=False, **overrides):
    """The JAX trainer and the port's on the same cameras, images and
    initial parameters: the JAX trainer's, with anisotropic scales drawn
    from a numpy seed, through the converter. (At init every Gaussian is
    isotropic, so its quaternion gradient is float32 noise, which Adam with
    eps 1e-15 turns into a full step of random sign in either package.)"""
    cfg_kw = _config_kwargs(**{"num_random": 120, "random_scale": 0.5, **overrides})
    rng = np.random.default_rng(5)
    images = rng.uniform(size=(num_cameras, H, W, 3)).astype(np.float32)
    jtr = JTrainer(jsf.SplatfactoConfig(**cfg_kw), j_hemisphere(num_cameras, H, W, radius=2.0),
                   images, seed=0, use_camera_optimizer=use_camera_optimizer)
    params = {k: np.array(v) for k, v in jtr.params.items()}
    params["scales"] += rng.uniform(-0.5, 0.3, params["scales"].shape).astype(np.float32)
    jtr.params = {k: jnp.asarray(v) for k, v in params.items()}
    ttr = TTrainer(tsf.SplatfactoConfig(**cfg_kw), t_hemisphere(num_cameras, H, W, radius=2.0),
                   images, seed=0, use_camera_optimizer=use_camera_optimizer, device="cpu")
    ttr.restore({
        "params": splat_params_from_jax(params),
        "splat_alive": np.asarray(jtr.splat_state.alive),
        "step": 0,
    })
    return jtr, ttr


def test_trainer_steps_match_jax():
    """Two train steps from the same parameters over the same camera
    sequence: losses, updated parameters and strategy state."""
    jtr, ttr = trainer_pair()
    key = jax.random.PRNGKey(1)
    for step in range(2):
        j_losses = jtr.train_step(key)
        t_losses = ttr.train_step()
        assert set(t_losses) == set(j_losses)
        for k, v in j_losses.items():
            assert t_losses[k] == pytest.approx(v, rel=SPLAT_LOSS_RTOL), (step, k)
        for k, v in jtr.params.items():
            np.testing.assert_allclose(ttr.params[k].detach().numpy(), np.asarray(v),
                                       err_msg=f"step {step}: {k}", **SPLAT_STEP_PARAM_TOL)
        np.testing.assert_array_equal(ttr.splat_state.vis_count.numpy(),
                                      np.asarray(jtr.splat_state.vis_count))
    assert ttr.step == jtr.step == 2
    # the steps moved every group
    start = {k: np.asarray(v) for k, v in trainer_pair()[0].params.items()}
    for k, v in ttr.params.items():
        assert not np.array_equal(v.detach().numpy(), start[k]) or k == "features_rest", k


def test_trainer_render_image_matches_jax():
    jtr, ttr = trainer_pair()
    want = jtr.render_image(1)
    got = ttr.render_image(1)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   **SPLAT_OUTPUT_TOLS.get(k, SPLAT_FWD_TOL))
    state = ttr.state_dict()
    other = TTrainer(ttr.config, t_hemisphere(3, H, W, radius=2.0), ttr.images.numpy(), seed=7,
                     device="cpu")
    other.restore(state)
    np.testing.assert_array_equal(other.render_image(1)["rgb"], got["rgb"])
