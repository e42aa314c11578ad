"""Parity of the port's splat eval renderers against the JAX package on the
CPU: the deep ensemble's render (``ensemble_render_splat``), the single
model's eval render (the splat branch of ``build_render_fn``), the eval
rasterize budgets (``_apply_raster_capacity``) and the ensemble's render by
pose (``build_ensemble_splat_render_cam``), on shared parameters. The JAX
side composites with its Pallas kernels in interpret mode. Tolerances are
stated in tests/torch_parity.py."""

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import MOMENT_TOL, SPLAT_FWD_TOL, SPLAT_OUTPUT_TOLS
from test_torch_splat_model import C2W, H, INTRINSICS, W, _config_kwargs, _params, trainer_pair

from uncertainty_nerf_gs_tpu.models import ensemble as jens
from uncertainty_nerf_gs_tpu.models import splatfacto as jsf
from uncertainty_nerf_gs_tpu.scripts import eval_uncertainty as jeval

from uncertainty_nerf_gs_torch.interop import splat_params_from_jax, stack_params
from uncertainty_nerf_gs_torch.models import ensemble as tens
from uncertainty_nerf_gs_torch.models import splatfacto as tsf
from uncertainty_nerf_gs_torch.scripts import eval_uncertainty as teval

SPLAT_SPEC = SimpleNamespace(family="splatfacto")
# the combined variances: a difference of member outputs, squared
COMBINED = ("rgb_var_alea", "rgb_var_epi", "rgb_var_combined", "rgb_std_combined",
            "depth_var_alea", "depth_var_epi", "depth_var_combined", "depth_std_combined")


def _tol(k):
    return MOMENT_TOL if k in COMBINED else SPLAT_OUTPUT_TOLS.get(k, SPLAT_FWD_TOL)


def _assert_outputs_match(got, want, label=""):
    assert set(got) == set(want), label
    for k, w in want.items():
        g = got[k].detach().cpu().numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        assert g.shape == np.shape(w) and np.isfinite(g).all(), (label, k)
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"{label} {k}", **_tol(k))


def _members(rng):
    """Two members on one buffer: different parameters (the second shifted
    by 0.01, as tests/test_splat.py's) and alive masks (rolled by 7)."""
    cfg_kw = _config_kwargs()
    p, alive = _params(rng, jsf.SplatfactoConfig(**cfg_kw))
    p2 = {k: v + np.float32(0.01) for k, v in p.items()}
    return cfg_kw, [p, p2], [alive, np.roll(alive, 7)]


def test_ensemble_render_splat_matches_jax(rng):
    """Two members with their own alive masks through one camera: every
    combined output, the member means at the forward's bars and the
    combined variances at MOMENT_TOL; the epistemic variance is live."""
    cfg_kw, ps, alives = _members(rng)
    bg = np.float32([0.2, 0.5, 0.9])
    want = jens.ensemble_render_splat(
        jens.stack_params([{k: jnp.asarray(v) for k, v in p.items()} for p in ps]),
        jnp.asarray(np.stack(alives)), jnp.asarray(C2W), *INTRINSICS, W, H,
        jsf.SplatfactoConfig(**cfg_kw), background=jnp.asarray(bg))
    got = tens.ensemble_render_splat(
        stack_params([splat_params_from_jax(p) for p in ps]), torch.from_numpy(np.stack(alives)),
        torch.from_numpy(C2W), *INTRINSICS, W, H, tsf.SplatfactoConfig(**cfg_kw),
        background=torch.from_numpy(bg))
    _assert_outputs_match(got, want)
    assert float(got["rgb_var_epi"].max()) > 1e-4


def test_identical_members_equal_the_single_model(rng):
    """Three copies of one model: the ensemble's outputs are the single
    model's render, and the epistemic variances are 0."""
    cfg_kw, ps, alives = _members(rng)
    cfg = tsf.SplatfactoConfig(**cfg_kw)
    tp = splat_params_from_jax(ps[0])
    alive = torch.from_numpy(alives[0])
    got = tens.ensemble_render_splat(stack_params([tp] * 3), torch.stack([alive] * 3),
                                     torch.from_numpy(C2W), *INTRINSICS, W, H, cfg)
    single = tsf.render_splat(tp, alive, torch.from_numpy(C2W), *INTRINSICS, W, H, cfg,
                              sh_deg=cfg.sh_degree)
    for k in ("rgb", "depth", "accumulation", "rgb_std", "depth_var"):
        torch.testing.assert_close(got[k], single[k], rtol=0, atol=1e-6, msg=k)
    assert not got["rgb_var_epi"].any() and not got["depth_var_epi"].any()


def test_build_splat_render_fn_matches_jax():
    """The trained model's eval render of each camera on the config's fixed
    background (random: nerfstudio's navy), against the splat branch of the
    JAX package's ``build_render_fn``."""
    jtr, ttr = trainer_pair(background_color="random")
    key = jax.random.PRNGKey(1)
    jtr.train_step(key)
    ttr.restore({"params": {k: np.asarray(v) for k, v in jtr.params.items()},
                 "splat_alive": np.asarray(jtr.splat_state.alive), "step": 1})
    want_fn = jeval.build_render_fn(jtr, SPLAT_SPEC, jtr.cameras, Path("."))
    got_fn = teval.build_splat_render_fn(ttr, ttr.cameras)
    for i in range(2):
        got = got_fn(i)
        _assert_outputs_match(got, want_fn(i), f"camera {i}")
        np.testing.assert_array_equal(got["background"].numpy(), np.float32(tsf.EVAL_BACKGROUND_RANDOM))
        assert int(got["raster_overflow"]) == 0


@pytest.mark.parametrize("setting", ["auto", 128, None])
def test_apply_raster_capacity_matches_jax(setting):
    """An int sets the capacity, "auto" probes the eval cameras and takes
    the members' largest, None keeps the run's: the members' configs equal
    JAX's as integers."""
    pairs = [trainer_pair(rasterize_capacity=64), trainer_pair(rasterize_capacity=64, random_scale=0.3)]
    jtrs, ttrs = [j for j, _ in pairs], [t for _, t in pairs]
    jeval._apply_raster_capacity(jtrs, SPLAT_SPEC, jtrs[0].cameras, setting)
    teval._apply_raster_capacity(ttrs, ttrs[0].cameras, setting)
    for j, t in zip(jtrs, ttrs):
        assert (t.config.rasterize_capacity, t.config.rasterize_row_capacity) == (
            j.config.rasterize_capacity, j.config.rasterize_row_capacity)
    if setting == "auto":
        assert ttrs[0].config.rasterize_capacity > 64


def test_build_ensemble_splat_render_cam_matches_jax():
    """Two trainers' members stacked, rendered by pose through the JAX
    package's jitted ``build_ensemble_splat_render_cam`` and the port's, on
    eval budgets tuned for the cameras ("auto")."""
    pairs = [trainer_pair(), trainer_pair(random_scale=0.4)]
    jtrs, ttrs = [j for j, _ in pairs], [t for _, t in pairs]
    jeval._apply_raster_capacity(jtrs, SPLAT_SPEC, jtrs[0].cameras, "auto")
    teval._apply_raster_capacity(ttrs, ttrs[0].cameras, "auto")
    want_cam = jeval.build_ensemble_splat_render_cam(jtrs, W, H)
    got_cam = teval.build_ensemble_splat_render_cam(ttrs, W, H)
    cams = jtrs[0].cameras
    for i in range(2):
        want = want_cam(cams.camera_to_worlds[i], cams.fx[i], cams.fy[i], cams.cx[i], cams.cy[i])
        got = got_cam(ttrs[0].cameras.camera_to_worlds[i], *ttrs[0]._intrinsics[i])
        _assert_outputs_match(got, want, f"camera {i}")
