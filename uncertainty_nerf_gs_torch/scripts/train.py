"""`unc-train` on the card: train any registered method on a parsed dataset.

Counterpart of ``uncertainty_nerf_gs_tpu/scripts/train.py``, with its flags:
the method and dataparser registries resolve the model and the data, the
trainer runs with a ``step-*.ckpt`` checkpoint every ``--steps-per-save``
steps (``engine/checkpointing.py``), and ``config.json`` is written next to
the checkpoints so that ``eval_uncertainty`` can reload the run.
``config.yml`` holds the same JSON text: JSON is YAML 1.2 flow style, so the
JAX package's ``yaml.safe_load`` reads it, and the card's machine has no
PyYAML. ``events.jsonl`` logs the losses (``utils/writer.py``).

``--steps-per-launch`` (default 50, as in the JAX package) runs the
nerfacto family's steps K a launch, one replayed CUDA graph on the card;
``--grad-checkpoint`` recomputes the forward in the backward; ``--load-dir``
resumes from a run's latest checkpoint (parameters, Adam state, step and
the trainer's generator). ``--device`` (an addition: the card by default)
takes ``cpu`` for a try without one.

The sparse-view parsers switch the nerfacto family to
``grid_layout="hybrid"`` with ``face_consistency_mult=1.0`` unless
``--overrides`` names a ``grid_layout``, as the JAX package does. Refused,
with the ROADMAP item that ports it: ``--viewer-port`` (queue 1, item 9).

Usage:
    python -m uncertainty_nerf_gs_torch.scripts.train active-nerfacto \\
        --data /path/to/scene --dataparser blender-data \\
        --max-num-iterations 30000 --output-dir outputs/run1 --seed 0
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch

from uncertainty_nerf_gs_torch.configs.methods import METHODS, get_method
from uncertainty_nerf_gs_torch.data.dataparsers import DATAPARSERS
from uncertainty_nerf_gs_torch.data.datasets import load_images, load_masks
from uncertainty_nerf_gs_torch.engine.checkpointing import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from uncertainty_nerf_gs_torch.ops.backend import resolve_device
from uncertainty_nerf_gs_torch.utils.writer import ScalarWriter

# Dataparsers whose point is few-view supervision; the nerfacto family trains
# them with the hybrid layout and the face-consistency loss (build_trainer).
SPARSE_VIEW_DATAPARSERS = frozenset({"sparse-nerfstudio", "sparse-blender", "sparse-mipnerf360"})


def build_trainer(method_name: str, data: Path, dataparser: str,
                  seed: int = 0, parser_kwargs: dict | None = None,
                  config_overrides: dict | None = None,
                  camera_opt: str = "default",
                  grad_checkpoint: bool = False,
                  device: str | torch.device | None = None):
    """Resolve method + dataparser and construct the trainer on ``device``
    (``None``: the card). ``camera_opt``: "default" follows the method spec,
    "on"/"off" force it. Returns (trainer, spec, the train split's
    DataparserOutputs)."""
    device = resolve_device(device)
    spec = get_method(method_name)
    if camera_opt != "default":
        spec = dataclasses.replace(spec, use_camera_optimizer=(camera_opt == "on"))
    outputs = DATAPARSERS[dataparser](Path(data), "train", **(parser_kwargs or {}))
    images = load_images(outputs)

    cfg = spec.model_config
    if (spec.family == "nerfacto" and dataparser in SPARSE_VIEW_DATAPARSERS
            and "grid_layout" not in (config_overrides or {})):
        # corner sharing is a protective prior under few-view supervision:
        # the coarse levels as canonical corner grids, and the penalty that
        # softly restores it at the hashed ones
        cfg = dataclasses.replace(cfg, grid_layout="hybrid", face_consistency_mult=1.0)
    if config_overrides:
        cfg = dataclasses.replace(cfg, **config_overrides)

    if spec.family == "splatfacto":
        from uncertainty_nerf_gs_torch.engine.splat_trainer import SplatfactoTrainer

        trainer = SplatfactoTrainer(
            config=cfg, cameras=outputs.cameras, images=images, seed=seed,
            points=outputs.metadata.get("points3D_xyz"),
            point_colors=outputs.metadata.get("points3D_rgb"),
            device=device,
        )
    else:
        from uncertainty_nerf_gs_torch.engine.trainer import NerfactoTrainer

        cfg = dataclasses.replace(cfg, num_images=len(outputs.cameras))
        trainer = NerfactoTrainer(
            config=cfg, cameras=outputs.cameras, images=images, seed=seed,
            use_camera_optimizer=spec.use_camera_optimizer, masks=load_masks(outputs),
            gradient_checkpointing=grad_checkpoint, device=device,
        )
    return trainer, spec, outputs


def main(argv: list[str] | None = None) -> Path:
    ap = argparse.ArgumentParser(description="train an uncertainty method")
    ap.add_argument("method", choices=sorted(METHODS))
    ap.add_argument("--data", required=True)
    ap.add_argument("--dataparser", default="blender-data", choices=sorted(DATAPARSERS))
    ap.add_argument("--output-dir", default="outputs/run")
    ap.add_argument("--max-num-iterations", type=int, default=None)
    ap.add_argument("--steps-per-save", type=int, default=None)
    ap.add_argument("--steps-per-eval-image", type=int, default=0,
                    help="render train image 0 every N steps and log its PSNR")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--load-dir", default=None,
                    help="resume from the latest step-*.ckpt in this dir (parameters, optimizer "
                         "state, step and the trainer's generator)")
    ap.add_argument("--camera-opt", default="default", choices=["default", "on", "off"],
                    help="override the method's camera-optimizer setting")
    ap.add_argument("--log-every", type=int, default=500)
    ap.add_argument("--grad-checkpoint", action="store_true",
                    help="nerfacto family: recompute the model forward in the backward "
                         "(torch.utils.checkpoint), trading operations for memory")
    ap.add_argument("--steps-per-launch", type=int, default=50,
                    help="nerfacto family: train steps a launch, one CUDA graph replayed K times "
                         "on the card with one host read of the losses; 1 = a step at a time. "
                         "Bit-identical either way. Splat training ignores it.")
    ap.add_argument("--viewer-port", type=int, default=0,
                    help="the live training viewer's port; 0 = off (not ported yet)")
    ap.add_argument("--viewer-downscale", type=int, default=4)
    ap.add_argument("--parser-kwargs", type=json.loads, default={},
                    help="JSON dict forwarded to the dataparser")
    ap.add_argument("--overrides", type=json.loads, default={},
                    help="JSON dict of model-config overrides")
    ap.add_argument("--device", default=None,
                    help="torch device to train on; the card by default, 'cpu' for a try without one")
    args, extra = ap.parse_known_args(argv)
    if args.viewer_port:
        raise NotImplementedError("the live viewer is not ported yet (ROADMAP, queue 1, item 9)")

    # tyro-style dotted flags (`--model.beta-min 0.02`, or the reference's
    # `--pipeline.model.X`), merged over --overrides JSON
    if extra:
        from uncertainty_nerf_gs_torch.configs.flags import parse_dotted_flags

        dotted, special = parse_dotted_flags(extra, get_method(args.method).model_config)
        args.overrides = {**args.overrides, **dotted}
        if "camera_opt" in special:
            args.camera_opt = special["camera_opt"]

    trainer, spec, _ = build_trainer(
        args.method, args.data, args.dataparser, args.seed,
        args.parser_kwargs, args.overrides, camera_opt=args.camera_opt,
        grad_checkpoint=args.grad_checkpoint, device=args.device,
    )
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    run_cfg = {
        "method": args.method,
        "data": str(args.data),
        "dataparser": args.dataparser,
        "parser_kwargs": args.parser_kwargs,
        "overrides": args.overrides,
        "seed": args.seed,
        "camera_opt": args.camera_opt,
    }
    text = json.dumps(run_cfg, indent=2)
    (out_dir / "config.json").write_text(text)
    (out_dir / "config.yml").write_text(text + "\n")

    writer = ScalarWriter(out_dir / "events.jsonl")
    total = args.max_num_iterations or spec.max_num_iterations
    save_every = args.steps_per_save or spec.steps_per_save
    t0 = time.perf_counter()
    done = start = 0
    if args.load_dir:
        ckpt_path = latest_checkpoint(Path(args.load_dir))
        if ckpt_path is None:
            raise FileNotFoundError(f"no step-*.ckpt under {args.load_dir}")
        ckpt = load_checkpoint(ckpt_path)
        trainer.restore(ckpt)
        done = start = int(ckpt["step"])
        print(f"resumed from {ckpt_path} at step {done}")
    while done < total:
        n = min(save_every, total - done)
        if spec.family == "splatfacto":
            losses = trainer.train(n, log_every=args.log_every, writer=writer)
        else:
            losses = trainer.train(n, num_rays_per_batch=spec.num_rays_per_batch, log_every=args.log_every,
                                   writer=writer, steps_per_launch=max(1, args.steps_per_launch))
        done += n
        save_checkpoint(out_dir, done, trainer.state_dict())
        if args.steps_per_eval_image and done % args.steps_per_eval_image == 0:
            from uncertainty_nerf_gs_torch.metrics.image_metrics import psnr

            img = trainer.render_image(0)
            p = float(psnr(torch.as_tensor(img["rgb"]), trainer.images[0].cpu()))
            writer.write(done, {"eval_psnr_train0": p})
            print(f"[{done}] train-view psnr={p:.2f}")
        rate = (done - start) / (time.perf_counter() - t0)
        print(f"[{done}/{total}] {rate:.1f} steps/s " + " ".join(f"{k}={v:.4f}" for k, v in losses.items()))
    writer.close()
    print(f"training done: {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
