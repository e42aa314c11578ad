"""The splat path's spans and counters (``utils/tracing.py``), on the CPU.

Under ``tracing.profile``, two ``SplatfactoTrainer`` steps, a refine and a
capacity retune leave each ``ungs.splat.`` span as often as its counter
moved, the step's stages inside its step span, and the counters at the
shapes (the buffer's capacity, the tiles and their slots). With no profile
active every span is the shared null context, and the steps' losses are
the same either way."""

import contextlib
import json

import numpy as np
import torch

from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras
from uncertainty_nerf_gs_torch.engine.splat_trainer import SplatfactoTrainer
from uncertainty_nerf_gs_torch.models.splatfacto import SplatfactoConfig
from uncertainty_nerf_gs_torch.utils import tracing

H, W, CAPACITY, BUDGET = 40, 48, 128, 96
TILES = 3 * 3  # 48 x 40 in 16 x 16 tiles, the last row of tiles 8 pixels high
CONFIG = SplatfactoConfig(capacity=CAPACITY, num_random=100, random_scale=0.6, rasterize_capacity=BUDGET,
                          uncertainty_channels=1, sh_degree=3, background_color="random")
STAGES = ("loss", "backward", "update", "stats", "project", "rasterize")


def _trainer():
    cams = hemisphere_cameras(2, H, W, radius=2.5, seed=1)
    images = np.random.default_rng(0).uniform(size=(2, H, W, 3)).astype(np.float32)
    return SplatfactoTrainer(CONFIG, cams, images, seed=3, device="cpu")


def _work(trainer):
    losses = [trainer.train_step() for _ in range(2)]
    trainer.refine()
    trainer.retune_capacity()
    return losses


def _spans(log_dir):
    events = json.loads((log_dir / "trace.json").read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("ungs.splat.")]


def test_splat_spans_follow_their_counters(tmp_path):
    trainer = _trainer()
    with tracing.profile(tmp_path):
        _work(trainer)
    spans = _spans(tmp_path)
    counts = json.loads((tmp_path / "counts.json").read_text())
    seen = {}
    for name, _, _ in spans:
        seen[name] = seen.get(name, 0) + 1
    assert seen == {"ungs.splat.step": 2, **{f"ungs.splat.{s}": 2 for s in STAGES}, "ungs.splat.refine": 1,
                    "ungs.splat.retune": 1}
    assert counts == {"splat_steps": 2, "gaussians": 2 * CAPACITY, "tiles": 2 * TILES,
                      "tile_slots": 2 * TILES * BUDGET, "refines": 1, "retunes": 1}
    steps = [(a, b) for n, a, b in spans if n == "ungs.splat.step"]
    for name, a, b in spans:
        if name.split(".")[-1] in STAGES:
            assert any(s <= a and b <= e for s, e in steps), name


def test_splat_spans_off_are_the_null_context_and_change_no_loss(tmp_path, monkeypatch):
    traced = _trainer()
    with tracing.profile(tmp_path):
        traced_losses = _work(traced)
    assert isinstance(tracing.span("ungs.splat.step", splat_steps=1), contextlib.nullcontext)

    def broken(*args, **kwargs):
        raise AssertionError("record_function called with no profile active")

    monkeypatch.setattr(torch.profiler, "record_function", broken)
    before = tracing.counts()
    plain = _trainer()
    assert _work(plain) == traced_losses
    assert tracing.counts() == before
    for k, v in plain.params.items():
        assert torch.equal(v, traced.params[k]), k
