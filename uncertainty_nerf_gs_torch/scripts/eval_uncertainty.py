"""`unc-eval` on the card: uncertainty evaluation of trained runs.

Counterpart of ``uncertainty_nerf_gs_tpu/scripts/eval_uncertainty.py``, with
its flags and its JSON. ``main`` reloads each run's ``config.json`` (or
``config.yml``) and latest ``step-*.ckpt`` (``_load_run``), parses the test
split (``_eval_cameras_and_images``), builds the method's predictive
renderer and writes ``{experiment_name, method_name, checkpoint,
approximations, results}`` through ``eval/evaluator.py``. One run renders
through ``build_render_fn``: the plain forward (nerfacto,
active-nerfacto), MC-dropout (``models/mcdropout.py``, with the eval-time
``--mc-samples``), Laplace (``models/laplace.py``; the GGN is read from the
run's ``ggn_v2_{n}.npz`` cache, or fit and written there, in the JAX
package's layout) or the splat render. Several runs are a deep ensemble
(``build_ensemble_render_fn``): the nerfacto family fused (one shared
proposal chain and one member-packed lookup a field, K6 on the card) or per
member, the splat family stacked, at ``--raster-capacity`` probed or set.

The fused ensemble's packed tables take the JAX package's options:
``--table-dtype`` bf16 (the default, as in the JAX package), f32 or int8,
``--table-fold`` and ``--table-split``, recorded in the JSON's
``approximations`` as the JAX package records them. Fold and split are
exact relayouts that change no value; the JAX package refuses
``--table-fold 2/4`` for a TPU compiler's memory, which the port, where a
fold is a view of the same rows, does not need. ``--device`` (an addition:
the card by default) takes ``cpu`` for a try without one.

Usage:
    python -m uncertainty_nerf_gs_torch.scripts.eval_uncertainty \\
        --load-config outputs/run1 [--load-config outputs/run2 ...] \\
        --output-path metrics.json [--mc-samples 10] [--laplace-iters 300]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Callable, Mapping, Sequence

import torch

from uncertainty_nerf_gs_torch.cameras.cameras import Cameras, generate_rays, pixel_grid
from uncertainty_nerf_gs_torch.data.dataparsers import DATAPARSERS
from uncertainty_nerf_gs_torch.data.datasets import load_images
from uncertainty_nerf_gs_torch.engine.checkpointing import (
    latest_checkpoint,
    load_ggn_cache,
    load_latest,
    save_ggn_cache,
)
from uncertainty_nerf_gs_torch.eval.evaluator import (
    EvalOptions,
    get_average_uncertainty_metrics,
    write_benchmark_json,
)
from uncertainty_nerf_gs_torch.interop import stack_params
from uncertainty_nerf_gs_torch.models import splatfacto as sf
from uncertainty_nerf_gs_torch.models.ensemble import ensemble_render, ensemble_render_splat
from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig, NerfactoModel
from uncertainty_nerf_gs_torch.ops.backend import resolve_device
from uncertainty_nerf_gs_torch.parallel.ensemble_fused import (
    build_fused_ensemble_render,
    pack_ensemble_tables,
)


def _nerfacto_full_image_renderer(
    config: NerfactoConfig,
    render_chunk_fn: Callable,
    eval_cameras: Cameras,
    device: str | torch.device | None = None,
) -> Callable[[int], dict[str, torch.Tensor]]:
    """``render(i)`` -> camera i's outputs as (H, W, ...) tensors on the
    device, from ``render_chunk_fn(ray_bundle)`` over chunks of
    ``config.eval_num_rays_per_chunk`` rays; the last chunk is padded with
    pixel (0, 0) and cut off after. The training-only keys are dropped."""
    device = resolve_device(device)
    cameras = eval_cameras.to(device)

    def render(i: int) -> dict[str, torch.Tensor]:
        h, w = cameras.height, cameras.width
        chunk = config.eval_num_rays_per_chunk
        px, py = pixel_grid(h, w, device)
        total = h * w
        pad = (-total) % chunk
        zeros = torch.zeros(pad, dtype=torch.float32, device=device)
        px, py = torch.cat([px, zeros]), torch.cat([py, zeros])
        idx = torch.full((total + pad,), i, dtype=torch.int64, device=device)
        outs: dict[str, list[torch.Tensor]] = {}
        for s in range(0, total + pad, chunk):
            rb = generate_rays(cameras, idx[s:s + chunk], px[s:s + chunk], py[s:s + chunk])
            for k, v in render_chunk_fn(rb).items():
                if k.startswith(("weights", "sdist")) or k == "density_mean":
                    continue
                outs.setdefault(k, []).append(v)
        return {k: torch.cat(v, 0)[:total].reshape((h, w) + v[0].shape[1:]) for k, v in outs.items()}

    return render


def build_ensemble_chunk_fn(
    model: NerfactoModel,
    stacked_params: Mapping[str, torch.Tensor],
    main_stride_scale: float = 0.0,
    table_dtype: str = "bf16",
    table_fold: int = 1,
    ensemble_mode: str = "fused",
    table_split: bool = False,
) -> Callable:
    """The nerfacto-family ensemble's chunk renderer ``rb -> combined
    outputs``: ``ensemble_mode="fused"`` on the cell and hybrid layouts
    packs the members' tables once and renders through
    ``build_fused_ensemble_render``; ``"per_member"``, and the corner
    layout in either mode (it has no cell rows to pack, and the JAX package
    routes it so too), renders each member's own forward
    (``ensemble_render``). ``table_dtype`` ("bf16", the JAX package's
    default, "f32" or "int8"), ``table_fold`` and ``table_split`` shape the
    fused path's packed tables."""
    if ensemble_mode not in ("fused", "per_member"):
        raise ValueError(f"unknown ensemble_mode {ensemble_mode!r}")
    stacked = {k: v for k, v in stacked_params.items() if k != "camera_opt"}
    if ensemble_mode == "fused" and model.config.grid_layout in ("cell", "hybrid"):
        packed = pack_ensemble_tables(model, stacked, table_dtype=table_dtype, table_fold=table_fold,
                                      table_split=table_split)
        fused = build_fused_ensemble_render(model, main_stride_scale=main_stride_scale)

        def chunk_fn(rb):
            return fused(stacked, packed, rb)
    else:

        def chunk_fn(rb):
            return ensemble_render(model, stacked, rb)
    return chunk_fn


def build_splat_render_fn(trainer, eval_cameras: Cameras) -> Callable[[int], dict[str, torch.Tensor]]:
    """``render(i)`` -> the splat trainer's render of eval camera i at the
    full SH degree on the config's fixed background, as (H, W, ...)
    tensors on the trainer's device; the per-Gaussian keys are dropped."""
    cameras = eval_cameras.to(trainer.device)

    @torch.no_grad()
    def render(i: int) -> dict[str, torch.Tensor]:
        cfg = trainer.config
        out = sf.render_splat(
            trainer.params, trainer.splat_state.alive, cameras.camera_to_worlds[i],
            float(cameras.fx[i]), float(cameras.fy[i]), float(cameras.cx[i]), float(cameras.cy[i]),
            cameras.width, cameras.height, cfg, sh_deg=cfg.sh_degree,
            background=sf.fixed_background(cfg, trainer.device),
        )
        return {k: v for k, v in out.items() if k not in ("radii", "visible")}

    return render


def build_chunk_render_fn(
    trainer,
    spec,
    mc_samples: int = 10,
    laplace_iters: int = 300,
    laplace_samples: int = 100,
    prior_prec: float = 1.0,
    seed: int = 0,
    *,
    batch_iter: Callable | None = None,
    draws=None,
    run_dir: Path | None = None,
) -> Callable:
    """The nerfacto family's predictive chunk renderer ``rb -> outputs`` of
    one trained model (``NerfactoTrainer``). ``spec`` names the method by
    its ``MethodSpec`` fields ``family``, ``mc_samples`` and ``laplace``:

    * ``mc_samples > 0``: ``mc_dropout_render`` with ``mc_samples`` (the
      eval-time override; 0 takes the method's) samples, masks from a
      generator seeded ``seed + 7``, or ``draws`` (one mask dict a sample,
      used for every chunk, as the JAX package reuses its key);
    * ``laplace``: the GGN from ``run_dir``'s cache for ``laplace_iters``
      where there is one, else ``fit_laplace`` over ``laplace_iters``
      batches of 4,096 training rays (``batch_iter(step)``, by default
      drawn by the trainer's sampler from a generator seeded ``seed +
      11``), written to the cache when ``run_dir`` is given; then
      ``laplace_render`` with normal draws from a generator seeded ``seed +
      7``, or ``draws`` (``laplace_draws``' layout, every chunk);
    * otherwise the eval forward with the average appearance."""
    if spec.family == "splatfacto":
        raise ValueError("splatfacto renders frames, not ray chunks")
    from uncertainty_nerf_gs_torch.models.laplace import laplace_render
    from uncertainty_nerf_gs_torch.models.mcdropout import mc_dropout_render

    model, config, device = trainer.model, trainer.config, trainer.device
    noise = torch.Generator(device=device).manual_seed(seed + 7)
    if spec.mc_samples > 0:
        m = mc_samples or spec.mc_samples

        def chunk_fn(rb):
            return mc_dropout_render(model, rb, m, generator=None if draws else noise, masks=draws)

        return chunk_fn

    if spec.laplace:
        posterior = None if run_dir is None else load_ggn_cache(run_dir, laplace_iters, device)
        if posterior is None:
            posterior = _fit_ggn(trainer, config, laplace_iters, seed, batch_iter)
            if run_dir is not None:
                save_ggn_cache(run_dir, laplace_iters, posterior)

        def chunk_fn(rb):
            return laplace_render(model, posterior, rb, config, noise=draws,
                                  generator=None if draws else noise, n_samples=laplace_samples,
                                  prior_prec=prior_prec)

        chunk_fn.posterior = posterior
        return chunk_fn

    def chunk_fn(rb):
        return model(rb, train=False, use_average_appearance=True)

    return chunk_fn


def _fit_ggn(trainer, config, laplace_iters: int, seed: int, batch_iter: Callable | None):
    """``fit_laplace`` over ``laplace_iters`` batches, by default 4,096
    training rays each (the reference fits its GGN on its training
    batches) from a generator seeded ``seed + 11``."""
    from uncertainty_nerf_gs_torch.models.laplace import fit_laplace

    if batch_iter is None:
        batches = torch.Generator(device=trainer.device).manual_seed(seed + 11)

        def batch_iter(step):
            batch = trainer.sample_batch(4096, generator=batches)
            return generate_rays(trainer.cameras, batch["camera_indices"], batch["pixel_x"], batch["pixel_y"])

    return fit_laplace(trainer.model, batch_iter, config, n_iters=laplace_iters)


def build_render_fn(trainer, spec, eval_cameras: Cameras, mc_samples: int = 10, laplace_iters: int = 300,
                    laplace_samples: int = 100, prior_prec: float = 1.0, seed: int = 0,
                    **injected) -> Callable[[int], dict[str, torch.Tensor]]:
    """The per-method predictive renderer ``i -> outputs`` of eval camera
    i: the splat family through ``build_splat_render_fn``, the nerfacto
    family through ``build_chunk_render_fn`` in full-image chunks.
    ``injected`` passes ``batch_iter``, ``draws`` and ``run_dir`` on."""
    if spec.family == "splatfacto":
        return build_splat_render_fn(trainer, eval_cameras)
    chunk_fn = build_chunk_render_fn(trainer, spec, mc_samples=mc_samples, laplace_iters=laplace_iters,
                                     laplace_samples=laplace_samples, prior_prec=prior_prec, seed=seed,
                                     **injected)
    return _nerfacto_full_image_renderer(trainer.config, chunk_fn, eval_cameras, trainer.device)


def _apply_raster_capacity(trainers: Sequence, cameras: Cameras, setting) -> None:
    """Set the splat trainers' eval rasterize budgets in place. ``setting``:
    None keeps the run's config; an int sets ``rasterize_capacity`` (the
    row budget back to its default); ``"auto"`` probes the exact tile and
    row maxima on ``cameras`` (``tune_rasterize_capacity``), so that the
    eval renders do not overflow, taking the largest over the members,
    which share one config when stacked."""
    if setting is None:
        return
    if setting == "auto":
        cap = row = 0
        for t in trainers:
            tuned = sf.tune_rasterize_capacity(t.config, t.params, t.splat_state.alive,
                                               cameras.to(t.device))
            cap = max(cap, tuned.rasterize_capacity)
            row = max(row, tuned.rasterize_row_capacity or 0)
        new = dict(rasterize_capacity=cap, rasterize_row_capacity=row)
    else:
        new = dict(rasterize_capacity=int(setting), rasterize_row_capacity=None)
    for t in trainers:
        t.config = dataclasses.replace(t.config, **new)
    print(f"[eval raster-capacity] capacity={trainers[0].config.rasterize_capacity}"
          f" row_capacity={trainers[0].config.rasterize_row_capacity}")


def build_ensemble_splat_render_cam(trainers: Sequence, width: int, height: int) -> Callable:
    """The splat deep ensemble, by pose: ``render_cam(c2w, fx, fy, cx, cy)``
    -> the combined outputs (``ensemble_render_splat``) of the trainers'
    members, stacked once on the first trainer's device, at its config on
    its fixed background."""
    stacked = stack_params([{k: v.detach() for k, v in t.params.items()} for t in trainers])
    stacked_alive = torch.stack([t.splat_state.alive for t in trainers])
    cfg0 = trainers[0].config
    background = sf.fixed_background(cfg0, stacked_alive.device)

    @torch.no_grad()
    def render_cam(c2w, fx, fy, cx, cy) -> dict[str, torch.Tensor]:
        return ensemble_render_splat(stacked, stacked_alive, c2w, fx, fy, cx, cy, width, height, cfg0,
                                     background=background)

    return render_cam


# -- runs from disk and the CLI --------------------------------------------------


def _load_run_config(run_dir: Path) -> dict:
    """A run's config: ``config.json``, else ``config.yml`` (the reference
    writes YAML; the train CLIs of both packages write both files)."""
    run_dir = Path(run_dir)
    if (run_dir / "config.json").exists():
        return json.loads((run_dir / "config.json").read_text())
    if (run_dir / "config.yml").exists():
        text = (run_dir / "config.yml").read_text()
        try:
            return json.loads(text)
        except json.JSONDecodeError:
            import yaml  # block-style YAML, from the JAX package's writer

            return yaml.safe_load(text)
    raise FileNotFoundError(f"no config.json/config.yml under {run_dir}")


def _load_run(run_dir: Path, device: str | torch.device | None = None):
    """(trainer, spec, run config, checkpoint step) of a run: its trainer
    rebuilt from the config on ``device`` and restored from its latest
    checkpoint (the nerfacto family's weights and step; the splat family's
    whole state)."""
    from uncertainty_nerf_gs_torch.scripts.train import build_trainer

    run_dir = Path(run_dir)
    run_cfg = _load_run_config(run_dir)
    trainer, spec, _ = build_trainer(
        run_cfg["method"], run_cfg["data"], run_cfg["dataparser"],
        run_cfg.get("seed", 0), run_cfg.get("parser_kwargs"), run_cfg.get("overrides"),
        camera_opt=run_cfg.get("camera_opt", "default"), device=device,
    )
    got = load_latest(run_dir)
    if got is None:
        raise FileNotFoundError(f"no checkpoint under {run_dir}")
    state, step = got
    if spec.family == "splatfacto":
        trainer.restore(state)
    else:
        trainer.restore({"params": state["params"], "step": state["step"]})
    return trainer, spec, run_cfg, step


def _eval_cameras_and_images(run_cfg: dict):
    outputs = DATAPARSERS[run_cfg["dataparser"]](Path(run_cfg["data"]), "test",
                                                 **(run_cfg.get("parser_kwargs") or {}))
    return outputs, load_images(outputs)


def _camera_render(render_cam: Callable, cameras: Cameras) -> Callable[[int], dict[str, torch.Tensor]]:
    def render(i: int) -> dict[str, torch.Tensor]:
        return render_cam(cameras.camera_to_worlds[i], float(cameras.fx[i]), float(cameras.fy[i]),
                          float(cameras.cx[i]), float(cameras.cy[i]))

    return render


def build_ensemble_render_fn(
    run_dirs: Sequence[Path],
    main_stride_scale: float = 0.0,
    table_dtype: str = "bf16",
    table_fold: int = 1,
    ensemble_mode: str = "fused",
    table_split: bool = False,
    raster_capacity=None,
    device: str | torch.device | None = None,
):
    """The eval-time deep ensemble of M runs: (render(i), the test split's
    outputs, its images). The nerfacto family renders through
    ``build_ensemble_chunk_fn``, the splat family through
    ``build_ensemble_splat_render_cam`` at ``raster_capacity``."""
    trainers, specs = [], []
    for d in run_dirs:
        t, spec, _, _ = _load_run(d, device)
        trainers.append(t)
        specs.append(spec)
    spec, base = specs[0], trainers[0]
    eval_outputs, eval_images = _eval_cameras_and_images(_load_run_config(Path(run_dirs[0])))
    cameras = eval_outputs.cameras.to(base.device)
    if spec.family == "splatfacto":
        _apply_raster_capacity(trainers, cameras, raster_capacity)
        render_cam = build_ensemble_splat_render_cam(trainers, cameras.width, cameras.height)
        return _camera_render(render_cam, cameras), eval_outputs, eval_images
    stacked = stack_params([{k: v.detach() for k, v in t.params().items()} for t in trainers])
    chunk_fn = build_ensemble_chunk_fn(base.model, stacked, main_stride_scale, table_dtype, table_fold,
                                       ensemble_mode, table_split)
    render = _nerfacto_full_image_renderer(base.config, chunk_fn, cameras, base.device)
    return render, eval_outputs, eval_images


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description="uncertainty evaluation")
    ap.add_argument("--load-config", action="append", required=True,
                    help="run dir (repeat for ensembles, >=2 members)")
    ap.add_argument("--output-path", default="metrics.json")
    ap.add_argument("--render-output-path", default=None)
    ap.add_argument("--save-rendered-images", action="store_true")
    ap.add_argument("--save-raw-outputs", action="store_true",
                    help="dump per-image raw arrays (raw_XXX.npz)")
    ap.add_argument("--eval-depth-unc", action="store_true")
    ap.add_argument("--plot-ause", action="store_true")
    ap.add_argument("--mc-samples", type=int, default=10)
    ap.add_argument("--laplace-iters", type=int, default=300)
    ap.add_argument("--laplace-samples", type=int, default=100)
    ap.add_argument("--prior-prec", type=float, default=1.0)
    ap.add_argument("--dataset-path", default=None,
                    help="dir with depth_gt_XX.npy + scale_parameters.txt")
    ap.add_argument("--lpips-weights", default=None,
                    help=".npz of converted official AlexNet LPIPS weights; without it scores are "
                         "reported as lpips_rand, not lpips")
    ap.add_argument("--experiment-name", default="experiment")
    ap.add_argument("--unc-min", type=float, default=0.0,
                    help="lower edge of the fixed std-map color window")
    ap.add_argument("--unc-max", type=float, default=1.0,
                    help="upper edge of the fixed std-map color window")
    ap.add_argument("--table-dtype", default="bf16", choices=("bf16", "f32", "int8"),
                    help="fused ensemble eval-table precision (int8: per-level scales folded into the "
                         "trilerp weights)")
    ap.add_argument("--table-fold", type=int, default=1,
                    help="fused eval tables: cells folded per row (an exact relayout, a view here)")
    ap.add_argument("--table-split", action="store_true",
                    help="fused eval tables: lane-split each level into parts (an exact relayout, views "
                         "here)")
    ap.add_argument("--main-stride-scale", type=float, default=0.0,
                    help="fused-ensemble render: evaluate the main field's coarse grid levels at "
                         "strided ray anchors (0 = exact)")
    ap.add_argument("--raster-capacity", default=None,
                    help="splat eval rasterize capacity: an integer, or 'auto' to probe the "
                         "overflow-free per-tile maxima on the eval cameras")
    ap.add_argument("--ensemble-mode", default="fused", choices=("fused", "per-member"),
                    help="'fused' shares one proposal chain across members; 'per-member' runs each "
                         "member's own chain (the reference's semantics)")
    ap.add_argument("--device", default=None,
                    help="torch device to evaluate on; the card by default, 'cpu' for a try without one")
    args = ap.parse_args(argv)
    if args.table_fold < 1:
        ap.error(f"--table-fold must be at least 1, got {args.table_fold}")
    device = resolve_device(args.device)

    lpips_params = None
    if args.lpips_weights:
        from uncertainty_nerf_gs_torch.ops.lpips import load_params

        lpips_params = load_params(args.lpips_weights)

    run_dirs = [Path(p) for p in args.load_config]
    if len(run_dirs) > 1:
        render_fn, eval_outputs, eval_images = build_ensemble_render_fn(
            run_dirs, main_stride_scale=args.main_stride_scale, table_dtype=args.table_dtype,
            table_fold=args.table_fold, ensemble_mode=args.ensemble_mode.replace("-", "_"),
            table_split=args.table_split, raster_capacity=args.raster_capacity, device=device,
        )
        method_name = "ensemble"
        ckpt = ";".join(str(latest_checkpoint(d)) for d in run_dirs)
    else:
        trainer, spec, run_cfg, _ = _load_run(run_dirs[0], device)
        eval_outputs, eval_images = _eval_cameras_and_images(run_cfg)
        if spec.family == "splatfacto":
            _apply_raster_capacity([trainer], eval_outputs.cameras, args.raster_capacity)
        render_fn = build_render_fn(
            trainer, spec, eval_outputs.cameras, args.mc_samples, args.laplace_iters,
            args.laplace_samples, args.prior_prec, run_dir=run_dirs[0],
        )
        method_name = spec.name
        ckpt = str(latest_checkpoint(run_dirs[0]))

    # the eval-time approximations behind the numbers, as the JAX package
    # records them
    fused = len(run_dirs) > 1 and args.ensemble_mode == "fused"
    approximations = {
        "table_dtype": args.table_dtype if fused else "f32",
        "main_stride_scale": args.main_stride_scale if fused else 0.0,
        "proposal_anchor_stride": fused,
        "table_fold": args.table_fold if len(run_dirs) > 1 else 1,
        "table_split": bool(args.table_split) if fused else False,
        "n_members": len(run_dirs),
        "shared_proposal_chain": fused,
    }
    options = EvalOptions(
        output_path=Path(args.output_path),
        approximations=approximations,
        render_output_path=Path(args.render_output_path) if args.render_output_path else None,
        save_rendered_images=args.save_rendered_images,
        save_raw_outputs=args.save_raw_outputs,
        eval_depth_unc=args.eval_depth_unc,
        plot_ause=args.plot_ause,
        unc_min=args.unc_min,
        unc_max=args.unc_max,
        dataset_path=Path(args.dataset_path) if args.dataset_path else None,
        experiment_name=args.experiment_name,
        method_name=method_name,
        checkpoint=ckpt,
    )
    out = get_average_uncertainty_metrics(render_fn, eval_images, options, lpips_params=lpips_params)
    write_benchmark_json(options.output_path, out["results"], options)
    print(json.dumps(out["results"], indent=2, default=float))
    return out


if __name__ == "__main__":
    main()
