"""Uncertainty evaluation: per-image metrics, their averages, the JSON.

Counterpart of ``uncertainty_nerf_gs_tpu/eval/evaluator.py`` (the
reference's ``ns-eval-unc`` harness). Per eval image:

* RGB uncertainty metrics (``rgb_uncertainty_metrics``): AUSE over mae, mse
  and rmse, the Gaussian NLL with a std floor of 3e-2, AUCE over the three
  channels with a shared std, the mean variance;
* depth uncertainty metrics (``depth_uncertainty_metrics``): the prediction
  scaled by the dataset's scale, resized to the GT's shape (JAX's bilinear
  resize, ``ops/resize.py``), clamped to [1e-3, gt.max], the NLL on the full
  image, AUSE and AUCE over the pixels with ``depth_gt > 0``;
* PSNR, SSIM and LPIPS (``lpips_rand`` for the random-feature fallback);
* ``num_rays_per_sec`` and ``fps`` on the host clock, after one warm-up
  render;

then the scalars are averaged, the AUSE and AUCE curves accumulated over
the images, and ``write_benchmark_json`` writes the
``{experiment_name, method_name, checkpoint, approximations, results}``
JSON. The metrics run on the device of the render's tensors. The PNGs go
through the port's own codec (``data/png.py``) and colour tables
(``utils/colormaps.py``): the card's machine has neither PIL nor
matplotlib. The plot writers import matplotlib inside themselves, and
``--plot-ause`` asks for it before the first render.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable, Iterable

import numpy as np
import torch

from uncertainty_nerf_gs_torch.data.png import write_png
from uncertainty_nerf_gs_torch.metrics.auce import auce
from uncertainty_nerf_gs_torch.metrics.ause import ause
from uncertainty_nerf_gs_torch.metrics.image_metrics import lpips, psnr, ssim
from uncertainty_nerf_gs_torch.metrics.nll import gaussian_nll
from uncertainty_nerf_gs_torch.ops.resize import resize_bilinear
from uncertainty_nerf_gs_torch.utils import colormaps

AUSE_BINS = 100
AUCE_BINS = 99
CURVE_KEYS = ("err_mae", "err_mse", "err_rmse", "err_var_mae", "err_var_mse", "err_var_rmse")


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ause_curves(var, sq_err, abs_err, mask=None) -> tuple[dict[str, float], dict[str, np.ndarray]]:
    values, curves = {}, {}
    for err_type, err in (("mae", abs_err), ("mse", sq_err), ("rmse", sq_err)):
        _, oracle, by_var, value = ause(var, err, err_type, mask=mask)
        values[f"ause_{err_type}"] = float(value)
        curves[f"err_{err_type}"] = _numpy(oracle)
        curves[f"err_var_{err_type}"] = _numpy(by_var)
    return values, curves


# ---------------------------------------------------------------------------
# per-image metric blocks
# ---------------------------------------------------------------------------


def rgb_uncertainty_metrics(
    rgb_pred: torch.Tensor,
    rgb_std: torch.Tensor,
    rgb_gt: torch.Tensor,
    background: torch.Tensor | None = None,
    min_rgb_std_for_nll: float = 3e-2,
) -> dict[str, Any]:
    """RGB block (reference ``get_unc_metrics_rgb``): rgb_pred and rgb_gt
    (H, W, 3), or rgb_gt (H, W, 4) composited onto ``background`` (3,) by
    its alpha; rgb_std (H, W) or (H, W, 1), shared by the channels."""
    rgb_std = rgb_std.reshape(rgb_pred.shape[:-1])
    if background is not None and rgb_gt.shape[-1] == 4:
        alpha = rgb_gt[..., 3:]
        rgb_gt = rgb_gt[..., :3] * alpha + background * (1.0 - alpha)

    sq_err = torch.sum((rgb_pred - rgb_gt) ** 2, dim=-1)
    abs_err = torch.sum(torch.abs(rgb_pred - rgb_gt), dim=-1)
    var_flat = (rgb_std**2).reshape(-1)
    values, curves = _ause_curves(var_flat, sq_err.reshape(-1), abs_err.reshape(-1))
    nll = gaussian_nll(rgb_pred.reshape(-1, 3), rgb_gt.reshape(-1, 3), rgb_std.reshape(-1),
                       eps=min_rgb_std_for_nll)
    # AUCE over the per-channel Gaussians with the shared std
    std3 = torch.repeat_interleave(rgb_std.reshape(-1, 1), 3, dim=1).reshape(-1)
    auce_dict = auce(rgb_pred.reshape(-1), std3, rgb_gt.reshape(-1))
    return {
        "nll_rgb": float(torch.mean(nll)),
        **values,
        "avg_var": float(torch.mean(var_flat)),
        "curves": curves,
        "auce": {k: _numpy(v) for k, v in auce_dict.items()},
        "images": {
            "abs_err": _numpy(torch.clamp(abs_err, 0.0, 1.0)),
            "rgb_gt": _numpy(rgb_gt),
        },
    }


def depth_uncertainty_metrics(
    depth: torch.Tensor,
    depth_std: torch.Tensor,
    depth_gt,
    scale_a: float = 1.0,
    min_depth_std_for_nll: float = 1.0,
) -> dict[str, Any]:
    """Depth block (reference ``get_unc_metrics_depth``): the prediction
    scaled by ``scale_a``, resized to the GT's shape, clamped to [1e-3,
    gt.max]; the NLL on the clamped full image; AUSE and AUCE over the
    pixels with ``depth_gt > 0``."""
    depth = torch.as_tensor(depth)
    depth = depth.reshape(depth.shape[-2:] if depth.dim() > 2 else depth.shape)
    depth_std = torch.as_tensor(depth_std, device=depth.device).reshape(depth.shape)
    depth_gt = torch.as_tensor(depth_gt, dtype=torch.float32, device=depth.device)
    if depth_gt.shape != depth.shape:
        depth = resize_bilinear(depth, depth_gt.shape)
        depth_std = resize_bilinear(depth_std, depth_gt.shape)

    min_d, max_d = 1e-3, float(torch.max(depth_gt))
    depth = scale_a * depth
    depth_std = scale_a * depth_std
    depth_c = torch.clamp(depth, min_d, max_d)
    nll_img = gaussian_nll(depth_c[..., None], depth_gt[..., None], depth_std[..., None],
                           eps=min_depth_std_for_nll).reshape(depth_c.shape)

    mask = (depth_gt > 0).reshape(-1)
    dm, gm, sm = depth_c.reshape(-1), depth_gt.reshape(-1), depth_std.reshape(-1)
    var = sm**2
    values, curves = _ause_curves(var, (gm - dm) ** 2, torch.abs(gm - dm), mask=mask)
    auce_dict = auce(dm, sm, gm, mask=mask)
    n_valid = torch.clamp(torch.sum(mask), min=1)
    return {
        "nll_depth": float(torch.sum(torch.where(mask, nll_img.reshape(-1), 0.0)) / n_valid),
        **values,
        "avg_var": float(torch.sum(torch.where(mask, var, 0.0)) / n_valid),
        "curves": curves,
        "auce": {k: _numpy(v) for k, v in auce_dict.items()},
        "images": {
            "depth_pred": _numpy(depth_c),
            "depth_gt": _numpy(depth_gt),
            "depth_std": _numpy(depth_std),
            "abs_err": _numpy(torch.abs(depth_c - depth_gt)),
        },
    }


def visualize_ranks(unc: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """BayesRays-style rank map: each pixel's uncertainty replaced by its
    normalized rank."""
    flat = unc.reshape(-1)
    ranks = np.empty_like(flat)
    ranks[np.argsort(flat)] = np.arange(flat.size, dtype=flat.dtype)
    return (ranks / max(flat.size - 1, 1)).reshape(unc.shape)


# ---------------------------------------------------------------------------
# artifacts: PNGs through the port's codec and colour tables; matplotlib is
# imported by the plot writers only
# ---------------------------------------------------------------------------


def _save_png(path: Path, arr: np.ndarray) -> None:
    """A float image in [0, 1] (clipped, then ``* 255`` truncated, as the
    JAX package's ``PIL.Image.fromarray((arr * 255).astype(uint8))``), or
    u8 colours as they are; a 2-D map as gray RGB."""
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, -1)
    write_png(path, arr)


def _jet(x: np.ndarray) -> np.ndarray:
    """u8 colours of matplotlib's jet (``utils/colormaps.py``), equal to
    ``(cm.jet(clip(x, 0, 1))[..., :3] * 255).astype(uint8)``."""
    return colormaps.lookup(np.clip(x, 0.0, 1.0), "jet")


def _viridis(x: np.ndarray) -> np.ndarray:
    """Matplotlib's default imshow colormap, which the reference's depth
    figures use, as ``_jet``."""
    return colormaps.lookup(np.clip(x, 0.0, 1.0), "viridis")


def _require_matplotlib() -> None:
    """Raises, naming the package, where matplotlib cannot be imported: the
    plot writers need it, and ``get_average_uncertainty_metrics`` asks
    before it renders anything."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError("--plot-ause draws its curves with matplotlib, which cannot be imported here "
                          f"({e}); evaluate without --plot-ause, or where matplotlib is installed") from e


def save_imgs_rgb(
    output_path: Path,
    img_num: int,
    rgb_gt: np.ndarray,
    rgb_pred: np.ndarray,
    rgb_std: np.ndarray,
    abs_err: np.ndarray,
    unc_min: float = 0.0,
    unc_max: float = 1.0,
) -> None:
    """GT, prediction, absolute error, the std map clipped to the fixed
    window [unc_min, unc_max] in jet, and the rank maps of the uncertainty
    and the error (the reference's file names)."""
    output_path = Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)
    _save_png(output_path / f"{img_num}_rgb_gt.png", rgb_gt)
    _save_png(output_path / f"{img_num}_rgb_pred.png", rgb_pred)
    _save_png(output_path / f"{img_num}_rgb_abs_err.png", abs_err)
    lo = min(unc_min, unc_max)
    denom = max(abs(unc_max - unc_min), 1e-10)
    std = np.clip((rgb_std - lo) / denom, 0.0, 1.0)
    _save_png(output_path / f"{img_num}_rgb_std.png", _jet(std))
    _save_png(output_path / f"{img_num}_rgb_unc_rank.png", _jet(visualize_ranks(rgb_std)))
    _save_png(output_path / f"{img_num}_rgb_err_rank.png", _jet(visualize_ranks(abs_err)))


def save_imgs_depth(
    output_path: Path,
    img_num: int,
    depth_gt: np.ndarray,
    depth_pred: np.ndarray,
    depth_std: np.ndarray,
    abs_err: np.ndarray,
) -> None:
    """Depth GT, prediction, std and absolute error in viridis: GT and
    prediction share the window [1e-3, gt.max], std and error their own
    maxima."""
    output_path = Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)
    min_d, max_d = 1e-3, max(float(depth_gt.max()), 1e-3 + 1e-6)

    def norm(x, lo, hi):
        return np.clip((x - lo) / max(hi - lo, 1e-10), 0.0, 1.0)

    _save_png(output_path / f"{img_num}_depth_gt.png", _viridis(norm(depth_gt, min_d, max_d)))
    _save_png(output_path / f"{img_num}_depth_pred.png", _viridis(norm(depth_pred, min_d, max_d)))
    _save_png(output_path / f"{img_num}_depth_std.png",
              _viridis(norm(depth_std, 0.0, float(depth_std.max()) or 1.0)))
    _save_png(output_path / f"{img_num}_depth_abs_err.png",
              _viridis(norm(abs_err, 0.0, float(abs_err.max()) or 1.0)))


def plot_auce_curves(output_path: Path, prefix: str, curves: dict[str, np.ndarray]) -> None:
    """Five curve plots and six ``.npy`` files of the AUCE curves."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    output_path = Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)
    alphas = (np.arange(AUCE_BINS) + 1.0) / 100.0
    np.save(output_path / f"{prefix}_alphas.npy", alphas)
    for key in ("coverage_values", "avg_length_values", "coverage_error_values",
                "abs_coverage_error_values", "neg_coverage_error_values"):
        vals = curves[key]
        np.save(output_path / f"{prefix}_{key}.npy", vals)
        fig, ax = plt.subplots(1)
        ax.plot(alphas, vals)
        if key == "coverage_values":
            ax.plot(alphas, 1.0 - alphas, "k--", alpha=0.5)
        ax.set_xlabel("alpha")
        ax.set_ylabel(key)
        fig.savefig(output_path / f"{prefix}_{key}.png", bbox_inches="tight")
        plt.close(fig)


def plot_ause_curves(output_path: Path, prefix: str, curves: dict[str, np.ndarray]) -> None:
    """The averaged sparsification curves: a plot and two ``.npy`` files a
    error type."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    output_path = Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)
    ratios = np.linspace(0.0, 1.0, AUSE_BINS, endpoint=False)
    for err_type in ("mae", "mse", "rmse"):
        fig, ax = plt.subplots(1)
        ax.plot(ratios, curves[f"err_{err_type}"], label="oracle")
        ax.plot(ratios, curves[f"err_var_{err_type}"], label="by variance")
        ax.set_xlabel("ratio removed")
        ax.set_ylabel(err_type)
        ax.legend()
        fig.savefig(output_path / f"{prefix}_ause_{err_type}.png", bbox_inches="tight")
        plt.close(fig)
        np.save(output_path / f"{prefix}_err_{err_type}.npy", curves[f"err_{err_type}"])
        np.save(output_path / f"{prefix}_err_var_{err_type}.npy", curves[f"err_var_{err_type}"])


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EvalOptions:
    """Knobs of the reference's ``EvalUncertainty`` config."""

    output_path: Path = Path("metrics.json")
    render_output_path: Path | None = None
    save_rendered_images: bool = False
    # per-image raw arrays as raw_{i:03d}.npz in render_output_path
    save_raw_outputs: bool = False
    eval_depth_unc: bool = False
    eval_rgb_unc: bool = True
    plot_ause: bool = False
    min_rgb_std_for_nll: float = 3e-2
    min_depth_std_for_nll: float = 1.0
    unc_max: float = 1.0
    unc_min: float = 0.0
    dataset_path: Path | None = None  # GT depth and scale_parameters.txt
    experiment_name: str = "experiment"
    method_name: str = "method"
    checkpoint: str = ""
    # the eval-time approximations behind the numbers (table dtype, strides),
    # written verbatim into the JSON
    approximations: dict | None = None


def get_average_uncertainty_metrics(
    render_fn: Callable[[int], dict[str, torch.Tensor]],
    gt_images: Iterable[np.ndarray],
    options: EvalOptions,
    lpips_params: Any = None,
) -> dict[str, Any]:
    """Evaluates every eval image and averages. ``render_fn(i)`` -> outputs
    with at least ``rgb`` (H, W, 3) (and ``rgb_std`` for the RGB block,
    ``depth``/``depth_std`` for the depth block, optionally
    ``background``); ``gt_images`` (H, W, 3 or 4) floats in [0, 1]. Returns
    ``{"results": averaged scalars, "artifacts": averaged curves}``."""
    if options.plot_ause and options.render_output_path:
        _require_matplotlib()  # before the renders, not after them
    gt_images = list(gt_images)
    num_images = len(gt_images)
    scalars: list[dict[str, float]] = []
    rgb_curves_sum = {k: np.zeros(AUSE_BINS) for k in CURVE_KEYS}
    depth_curves_sum = {k: np.zeros(AUSE_BINS) for k in CURVE_KEYS}
    rgb_auce_sum: dict[str, np.ndarray] = {}
    depth_auce_sum: dict[str, np.ndarray] = {}

    scale_a = 1.0
    if options.eval_depth_unc and options.dataset_path is not None:
        scale_file = Path(options.dataset_path) / "scale_parameters.txt"
        if scale_file.exists():
            scale_a = float(np.loadtxt(scale_file, delimiter=","))

    # a warm-up render, so that image 0's throughput holds no build or
    # first-call cost; reported on its own
    t_first = time.perf_counter()
    if num_images > 0:
        _numpy(render_fn(0)["rgb"])
    first_render_sec = time.perf_counter() - t_first

    for i, gt in enumerate(gt_images):
        t0 = time.perf_counter()
        outputs = render_fn(i)
        _numpy(outputs["rgb"])  # ends in a copy to the host
        dt = time.perf_counter() - t0
        rgb = outputs["rgb"]
        h, w = rgb.shape[:2]
        m: dict[str, float] = {"num_rays_per_sec": h * w / dt, "fps": 1.0 / dt}
        if "raster_overflow" in outputs:
            m["raster_overflow"] = float(outputs["raster_overflow"])

        gt_t = torch.as_tensor(np.asarray(gt), dtype=torch.float32, device=rgb.device)
        gt_rgb = gt_t[..., :3]
        if gt_t.shape[-1] == 4 and "background" in outputs:
            alpha = gt_t[..., 3:]
            gt_rgb = gt_t[..., :3] * alpha + outputs["background"] * (1.0 - alpha)
        m["psnr"] = float(psnr(rgb, gt_rgb))
        m["ssim"] = float(ssim(rgb, gt_rgb))
        # the published LPIPS scale only with loaded weights; the fallback
        # has its own key
        lpips_key = "lpips" if lpips_params is not None else "lpips_rand"
        m[lpips_key] = float(lpips(rgb, gt_rgb, lpips_params))

        if options.save_raw_outputs and options.render_output_path:
            raw_dir = Path(options.render_output_path)
            raw_dir.mkdir(parents=True, exist_ok=True)
            arrays = {"rgb": _numpy(rgb), "gt": _numpy(gt_rgb)}
            for k in ("rgb_std", "depth", "depth_std"):
                if k in outputs:
                    arrays[k] = _numpy(outputs[k])
            np.savez(raw_dir / f"raw_{i:03d}.npz", **arrays)

        if options.eval_rgb_unc and "rgb_std" in outputs:
            r = rgb_uncertainty_metrics(rgb, outputs["rgb_std"], gt_t,
                                        background=outputs.get("background"),
                                        min_rgb_std_for_nll=options.min_rgb_std_for_nll)
            m.update({
                "nll_rgb": r["nll_rgb"],
                "rgb_ause_mae": r["ause_mae"],
                "rgb_ause_mse": r["ause_mse"],
                "rgb_ause_rmse": r["ause_rmse"],
                "rgb_avg_var": r["avg_var"],
                "rgb_auce_abs": float(r["auce"]["auc_abs_error_values"]),
                "rgb_auce_length": float(r["auce"]["auc_length_values"]),
                "rgb_auce_neg": float(r["auce"]["auc_neg_error_values"]),
            })
            for k in rgb_curves_sum:
                rgb_curves_sum[k] += r["curves"][k]
            for k, v in r["auce"].items():
                if np.ndim(v):
                    rgb_auce_sum[k] = rgb_auce_sum.get(k, 0.0) + v
            if options.save_rendered_images and options.render_output_path:
                save_imgs_rgb(options.render_output_path, i, r["images"]["rgb_gt"], _numpy(rgb),
                              _numpy(outputs["rgb_std"]).reshape(h, w), r["images"]["abs_err"],
                              options.unc_min, options.unc_max)

        if options.eval_depth_unc and "depth_std" in outputs:
            gt_depth = None
            if options.dataset_path is not None:
                f = Path(options.dataset_path) / f"depth_gt_{i:02d}.npy"
                if f.exists():
                    gt_depth = np.load(f)
            if gt_depth is not None:
                d = depth_uncertainty_metrics(outputs["depth"], outputs["depth_std"], gt_depth,
                                              scale_a, options.min_depth_std_for_nll)
                m.update({
                    "nll_depth": d["nll_depth"],
                    "depth_ause_mae": d["ause_mae"],
                    "depth_ause_mse": d["ause_mse"],
                    "depth_ause_rmse": d["ause_rmse"],
                    "depth_avg_var": d["avg_var"],
                    "depth_auce_abs": float(d["auce"]["auc_abs_error_values"]),
                })
                for k in depth_curves_sum:
                    depth_curves_sum[k] += d["curves"][k]
                for k, v in d["auce"].items():
                    if np.ndim(v):
                        depth_auce_sum[k] = depth_auce_sum.get(k, 0.0) + v
                if options.save_rendered_images and options.render_output_path:
                    save_imgs_depth(options.render_output_path, i, d["images"]["depth_gt"],
                                    d["images"]["depth_pred"], d["images"]["depth_std"],
                                    d["images"]["abs_err"])
        scalars.append(m)

    keys = set().union(*(m.keys() for m in scalars)) if scalars else set()
    results = {k: float(np.mean([m[k] for m in scalars if k in m])) for k in keys}
    # the JAX package's name for the warm-up render's time (jit compile
    # included there; here the kernels' first calls and builds)
    results["compile_and_first_render_sec"] = first_render_sec
    if any("raster_overflow" in m for m in scalars):
        results["raster_overflow_max"] = float(
            max(m["raster_overflow"] for m in scalars if "raster_overflow" in m))
    artifacts = {
        "rgb_ause_curves": {k: v / num_images for k, v in rgb_curves_sum.items()},
        "depth_ause_curves": {k: v / num_images for k, v in depth_curves_sum.items()},
        "rgb_auce_curves": {k: v / num_images for k, v in rgb_auce_sum.items()},
        "depth_auce_curves": {k: v / num_images for k, v in depth_auce_sum.items()},
    }
    if options.plot_ause and options.render_output_path:
        if options.eval_rgb_unc:
            plot_ause_curves(options.render_output_path, "rgb", artifacts["rgb_ause_curves"])
            if rgb_auce_sum:
                plot_auce_curves(options.render_output_path, "rgb", artifacts["rgb_auce_curves"])
        if options.eval_depth_unc and any(v.sum() for v in depth_curves_sum.values()):
            plot_ause_curves(options.render_output_path, "depth", artifacts["depth_ause_curves"])
            if depth_auce_sum:
                plot_auce_curves(options.render_output_path, "depth", artifacts["depth_auce_curves"])
    return {"results": results, "artifacts": artifacts}


def write_benchmark_json(output_path: Path, results: dict[str, float], options: EvalOptions) -> None:
    """The final JSON, in the reference's schema plus ``approximations``."""
    payload = {
        "experiment_name": options.experiment_name,
        "method_name": options.method_name,
        "checkpoint": options.checkpoint,
        "approximations": options.approximations or {},
        "results": results,
    }
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "w") as f:
        json.dump(payload, f, indent=2)
