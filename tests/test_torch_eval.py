"""Parity of the port's uncertainty metrics and evaluator against the JAX
package, on the CPU, on numpy-seeded inputs: AUSE, AUCE, the Gaussian NLL,
PSNR, SSIM, LPIPS and their masked variants, JAX's bilinear resize, the
RGB and depth metric blocks, the averaging loop with its JSON, and the PNG
writers. Tolerances are tests/torch_parity.py's ``TOL`` unless a test
states its own.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import TOL

from uncertainty_nerf_gs_tpu.eval import evaluator as jev
from uncertainty_nerf_gs_tpu.metrics import image_metrics as jim
from uncertainty_nerf_gs_tpu.metrics.auce import auce as jauce
from uncertainty_nerf_gs_tpu.metrics.ause import ause as jause
from uncertainty_nerf_gs_tpu.metrics.nll import gaussian_nll as jnll
from uncertainty_nerf_gs_tpu.ops import lpips as jlp

from uncertainty_nerf_gs_torch.eval import evaluator as tev
from uncertainty_nerf_gs_torch.metrics import image_metrics as tim
from uncertainty_nerf_gs_torch.metrics.auce import auce as tauce
from uncertainty_nerf_gs_torch.metrics.ause import ause as tause
from uncertainty_nerf_gs_torch.metrics.nll import gaussian_nll as tnll
from uncertainty_nerf_gs_torch.ops import lpips as tlp
from uncertainty_nerf_gs_torch.ops.resize import resize_bilinear

N = 1000  # int((1 - r) * 1000) in float32 rounds differently from exact arithmetic


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, err_msg="", **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=err_msg, **(tol or TOL))


def _with_ties(rng, n=N):
    """Uncertainties and errors with ties: runs of equal uncertainties and
    of zero errors."""
    unc = rng.uniform(0, 1, n).astype(np.float32)
    unc[::7] = 0.25
    unc[1::11] = 0.0
    err = (rng.uniform(0, 1, n) ** 2).astype(np.float32)
    err[::5] = 0.0
    err[3::13] = err[3]
    return unc, err


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("err_type", ["rmse", "mae", "mse"])
def test_ause_matches_jax(rng, err_type, masked):
    """The ratios and the keep counts are equal; the curves and AUSE at TOL
    (the cumulative sums add in another order)."""
    from uncertainty_nerf_gs_torch.metrics import ause as tmod

    unc, err = _with_ties(rng)
    mask = rng.uniform(size=N) > 0.3 if masked else None
    want = jause(jnp.asarray(unc), jnp.asarray(err), err_type,
                 mask=None if mask is None else jnp.asarray(mask))
    got = tause(_t(unc), _t(err), err_type, mask=None if mask is None else _t(mask))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    n_valid = N if mask is None else int(mask.sum())
    want_keep = jax.jit(lambda r, n: jnp.clip(((1.0 - r) * n).astype(jnp.int32), 1, n))(
        want[0], jnp.int32(n_valid))
    got_keep = tmod.keep_counts(got[0], torch.tensor(n_valid, dtype=torch.int32))
    assert np.array_equal(got_keep.numpy(), np.asarray(want_keep))
    for name, g, w in zip(("oracle", "by_var", "ause"), got[1:], want[1:]):
        _close(g.numpy(), w, name)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_auce_matches_jax(rng, masked):
    """Each coverage within 1 / n (z is ndtri in float64 rounded, JAX's
    float32 ppf is up to 2.5e-6 away); the interval lengths at TOL; what is
    derived from the coverage within 1 / n on top of TOL."""
    mu = rng.uniform(0, 1, N).astype(np.float32)
    sigma = rng.uniform(0.01, 0.2, N).astype(np.float32)
    target = (mu + rng.normal(size=N) * sigma * 1.3).astype(np.float32)
    target[::9] = mu[::9]  # zero residuals
    sigma[::17] = 0.0  # covered only where the residual is 0
    sigma[1::19] = sigma[1]  # equal sigmas
    mask = rng.uniform(size=N) > 0.25 if masked else None
    want = jauce(jnp.asarray(mu), jnp.asarray(sigma), jnp.asarray(target),
                 mask=None if mask is None else jnp.asarray(mask))
    got = tauce(_t(mu), _t(sigma), _t(target), mask=None if mask is None else _t(mask))
    assert set(got) == set(want)
    n = N if mask is None else int(mask.sum())
    step = 1.0 / n
    np.testing.assert_allclose(got["coverage_values"].numpy(), np.asarray(want["coverage_values"]),
                               atol=step + 1e-7, rtol=0)
    _close(got["avg_length_values"].numpy(), want["avg_length_values"], "length")
    _close(got["auc_length_values"].numpy(), want["auc_length_values"], "auc length")
    for k in ("coverage_error_values", "abs_coverage_error_values", "neg_coverage_error_values",
              "auc_abs_error_values", "auc_neg_error_values"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=step + TOL["atol"],
                                   rtol=TOL["rtol"], err_msg=k)


def test_gaussian_nll_matches_jax(rng):
    preds = rng.uniform(size=(40, 3)).astype(np.float32)
    targets = rng.uniform(size=(40, 3)).astype(np.float32)
    stds = rng.uniform(0, 0.2, 40).astype(np.float32)
    stds[::4] = 0.0  # floored
    for eps in (1e-6, 3e-2):
        want = jnll(jnp.asarray(preds), jnp.asarray(targets), jnp.asarray(stds), eps)
        got = tnll(_t(preds), _t(targets), _t(stds), eps)
        _close(got.numpy(), want, f"eps {eps}")


def _images(rng, h=40, w=36):
    pred = rng.uniform(size=(h, w, 3)).astype(np.float32)
    target = np.clip(pred + rng.normal(size=(h, w, 3)) * 0.1, 0, 1).astype(np.float32)
    mask = rng.uniform(size=(h, w)) > 0.4
    return pred, target, mask


def test_psnr_ssim_and_masked_match_jax(rng):
    pred, target, mask = _images(rng)
    p, t, m = jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask)
    _close(tim.psnr(_t(pred), _t(target)).numpy(), jim.psnr(p, t), "psnr")
    _close(tim.ssim(_t(pred), _t(target)).numpy(), jim.ssim(p, t), "ssim")
    _close(tim.masked_psnr(_t(pred), _t(target), _t(mask)).numpy(), jim.masked_psnr(p, t, m), "masked psnr")
    _close(tim.masked_ssim(_t(pred), _t(target), _t(mask)).numpy(), jim.masked_ssim(p, t, m), "masked ssim")


def test_lpips_random_params_equal_jax():
    want, got = jlp.init_random_params(0), tlp.init_random_params(0)
    for a, b in zip(want["convs"], got["convs"]):
        assert np.array_equal(b["w"].numpy(), np.asarray(a["w"]))
        assert np.array_equal(b["b"].numpy(), np.asarray(a["b"]))
    for a, b in zip(want["lins"], got["lins"]):
        assert np.array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("shape", [(40, 36), (66, 70)], ids=["upsampled", "as_is"])
def test_lpips_matches_jax(rng, shape):
    """lpips, lpips_spatial and masked_lpips with init_random_params(0): an
    image under 64 pixels a side is up-sampled first, and the spatial maps
    are resized back to it."""
    pred, target, mask = _images(rng, *shape)
    p, t = jnp.asarray(pred), jnp.asarray(target)
    _close(tim.lpips(_t(pred), _t(target)).numpy(), jim.lpips(p, t), "lpips")
    _close(tlp.lpips_spatial(_t(pred), _t(target)).numpy(), jlp.lpips_spatial(p, t), "spatial")
    _close(tim.masked_lpips(_t(pred), _t(target), _t(mask)).numpy(),
           jim.masked_lpips(p, t, jnp.asarray(mask)), "masked")
    _close(tim.masked_lpips(_t(pred), _t(target)).numpy(), jim.masked_lpips(p, t), "unmasked")


@pytest.mark.parametrize("shapes", [((12, 20), (31, 45)), ((40, 50), (17, 23)), ((20, 9, 3), (20, 4, 3))],
                         ids=["up", "down", "one_axis"])
def test_resize_matches_jax(rng, shapes):
    """jax.image.resize(..., "bilinear"): up-sampling, and down-sampling,
    where it widens the triangle kernel (anti-aliasing)."""
    src, dst = shapes
    x = rng.uniform(0, 5, src).astype(np.float32)
    _close(resize_bilinear(_t(x), dst).numpy(), jax.image.resize(jnp.asarray(x), dst, "bilinear"))


def _fake_render(rng, h=24, w=20):
    rgb = rng.uniform(size=(h, w, 3)).astype(np.float32)
    gt = np.clip(rgb + rng.normal(size=(h, w, 3)) * 0.05, 0, 1).astype(np.float32)
    std = (np.abs(gt - rgb).mean(-1) + rng.uniform(0, 0.05, (h, w))).astype(np.float32)
    std[::5, ::3] = std[0, 0]  # ties
    return rgb, std, gt


def test_rgb_uncertainty_metrics_match_jax(rng):
    rgb, std, gt = _fake_render(rng)
    gt4 = np.concatenate([gt, rng.uniform(size=gt.shape[:2] + (1,)).astype(np.float32)], -1)
    bg = np.float32([1.0, 0.5, 0.0])
    for g, b in ((gt, None), (gt4, bg)):
        want = jev.rgb_uncertainty_metrics(jnp.asarray(rgb), jnp.asarray(std), jnp.asarray(g),
                                           None if b is None else jnp.asarray(b))
        got = tev.rgb_uncertainty_metrics(_t(rgb), _t(std), _t(g), None if b is None else _t(b))
        _compare_block(got, want, rgb.size)


def _coverage_tol(key: str, n: int) -> dict:
    """AUCE's coverage and what is derived from it move in steps of 1 / n
    (test_auce_matches_jax); its lengths and everything else hold TOL."""
    if "length" in key or not key.startswith(("coverage", "abs_coverage", "neg_coverage", "auc_", "rgb_auce",
                                               "depth_auce")):
        return TOL
    return dict(atol=1.0 / n + TOL["atol"], rtol=TOL["rtol"])


def _compare_block(got, want, n):
    """A metric block (rgb_/depth_uncertainty_metrics), AUCE over n values."""
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            assert set(got[k]) == set(v), k
            for kk, vv in v.items():
                _close(got[k][kk], vv, kk, **(_coverage_tol(kk, n) if k == "auce" else TOL))
        else:
            _close(got[k], v, k)


@pytest.mark.parametrize("gt_shape", [(24, 20), (36, 30), (15, 12)], ids=["same", "upsampled", "downsampled"])
def test_depth_uncertainty_metrics_match_jax(rng, gt_shape):
    """The depth block with a prediction resized up and down to the GT's
    shape, pixels without GT depth masked, a dataset scale."""
    depth = rng.uniform(0.5, 3.0, (24, 20)).astype(np.float32)
    depth_std = rng.uniform(0.05, 0.5, (24, 20)).astype(np.float32)
    depth_gt = rng.uniform(0.5, 3.0, gt_shape).astype(np.float32)
    depth_gt[rng.uniform(size=gt_shape) < 0.2] = 0.0
    want = jev.depth_uncertainty_metrics(jnp.asarray(depth), jnp.asarray(depth_std), depth_gt, 1.3)
    got = tev.depth_uncertainty_metrics(_t(depth), _t(depth_std), depth_gt, 1.3)
    _compare_block(got, want, int((depth_gt > 0).sum()))


def test_visualize_ranks_matches_jax(rng):
    unc = rng.uniform(size=(9, 7)).astype(np.float32)
    unc[::2, ::3] = 0.5
    assert np.array_equal(tev.visualize_ranks(unc), jev.visualize_ranks(unc))


TIMING_KEYS = {"num_rays_per_sec", "fps", "compile_and_first_render_sec"}


def test_average_metrics_and_json_match_jax(tmp_path, rng):
    """get_average_uncertainty_metrics over a fixed fake render of two
    images, then write_benchmark_json: the same keys and, but for the
    timing keys, the same values at TOL; the same averaged curves."""
    renders = [_fake_render(rng) for _ in range(2)]
    gts = [g for _, _, g in renders]

    def render_fn(backend):
        def fn(i):
            rgb, std, _ = renders[i]
            return {"rgb": backend(rgb), "rgb_std": backend(std), "depth": backend(std * 3)}
        return fn

    opts = dict(experiment_name="e", method_name="ensemble", checkpoint="c",
                approximations={"table_dtype": "f32"})
    want = jev.get_average_uncertainty_metrics(render_fn(jnp.asarray), gts, jev.EvalOptions(**opts))
    got = tev.get_average_uncertainty_metrics(render_fn(_t), gts, tev.EvalOptions(**opts))
    assert set(got["results"]) == set(want["results"])
    assert "lpips_rand" in got["results"]
    n = gts[0].size  # AUCE over every channel of every pixel
    for k, v in want["results"].items():
        if k not in TIMING_KEYS:
            _close(got["results"][k], v, k, **_coverage_tol(k, n))
    for group, curves in want["artifacts"].items():
        assert set(got["artifacts"][group]) == set(curves), group
        for k, v in curves.items():
            _close(got["artifacts"][group][k], v, f"{group} {k}",
                   **(_coverage_tol(k, n) if group.endswith("auce_curves") else TOL))
    jev.write_benchmark_json(tmp_path / "jax.json", want["results"], jev.EvalOptions(**opts))
    tev.write_benchmark_json(tmp_path / "port.json", got["results"], tev.EvalOptions(**opts))
    a, b = (json.loads((tmp_path / f).read_text()) for f in ("jax.json", "port.json"))
    assert list(a) == list(b) and set(a["results"]) == set(b["results"])
    assert {k: v for k, v in a.items() if k != "results"} == {k: v for k, v in b.items() if k != "results"}


def test_png_writers_match_jax(tmp_path, rng):
    """The RGB and depth image writers give the JAX package's pixels on the
    same arrays; the curve plots write the same files and arrays."""
    Image = pytest.importorskip("PIL.Image")
    pytest.importorskip("matplotlib")
    rgb, std, gt = _fake_render(rng)
    abs_err = np.clip(np.abs(rgb - gt).sum(-1), 0, 1)
    depth = rng.uniform(0.5, 3.0, std.shape).astype(np.float32)
    curves_ause = {k: rng.uniform(size=100) for k in tev.CURVE_KEYS}
    curves_auce = {k: rng.uniform(size=99) for k in (
        "coverage_values", "avg_length_values", "coverage_error_values",
        "abs_coverage_error_values", "neg_coverage_error_values")}
    for mod, out in ((jev, tmp_path / "jax"), (tev, tmp_path / "port")):
        mod.save_imgs_rgb(out, 3, gt, rgb, std, abs_err, 0.0, 0.2)
        mod.save_imgs_depth(out, 3, depth, depth * 1.1, std, abs_err)
        mod.plot_ause_curves(out, "rgb", curves_ause)
        mod.plot_auce_curves(out, "rgb", curves_auce)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len([n for n in names if n.startswith("3_")]) == 10
    for name in names:
        a, b = tmp_path / "jax" / name, tmp_path / "port" / name
        if name.endswith(".npy"):
            assert np.array_equal(np.load(a), np.load(b)), name
        elif name.startswith("3_"):
            assert np.array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b))), name
