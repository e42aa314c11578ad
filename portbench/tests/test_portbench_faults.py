"""A run whose timed path is broken underneath comes out not correct: the
planted faults a cell can have, and each cell's control. The harness is
driven on the CPU at tiny widths, past its look for a card."""

import time

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

SEED = 2**31 + 123


def correct(name, tmp_path, **config):
    cell = tiny.cell(name)
    cell["config"].update(config)
    return harness.run_cell(cell, SEED, 0.2, False, torch.device("cpu"), time.perf_counter(), tmp_path)["correct"]


def test_sound_runs_are_correct(tmp_path):
    assert all(correct(name, tmp_path) for name in ("nerfacto-train", "nerfacto-eval", "ensemble5-eval"))


def test_a_step_that_leaves_the_state_unchanged(tmp_path, monkeypatch):
    from uncertainty_nerf_gs_torch.engine import optimizers

    monkeypatch.setattr(optimizers.ScheduledAdam, "step", lambda self, closure=None: None)
    assert not correct("nerfacto-train", tmp_path)


def test_half_the_batch_left_out(tmp_path, monkeypatch):
    from uncertainty_nerf_gs_torch.engine import trainer

    loss = trainer.nerfacto_loss

    def half(outputs, batch, config):
        n = batch["image"].shape[0] // 2

        def cut(v):
            if isinstance(v, list):
                return [t[:n] for t in v]
            return v[:n] if torch.is_tensor(v) and v.dim() > 0 else v

        return loss({k: cut(v) for k, v in outputs.items()}, {k: cut(v) for k, v in batch.items()}, config)

    monkeypatch.setattr(trainer, "nerfacto_loss", half)
    assert not correct("nerfacto-train", tmp_path)


@pytest.mark.parametrize("name", ["nerfacto-eval", "ensemble5-eval"])
def test_an_answer_altered_where_it_is_produced(name, tmp_path, monkeypatch):
    from uncertainty_nerf_gs_torch.ops import raymarch

    render_rgb = raymarch.render_rgb
    monkeypatch.setattr(raymarch, "render_rgb", lambda *a, **k: render_rgb(*a, **k) + 1e-2)
    assert not correct(name, tmp_path)


def test_ensemble_control_int8_tables(tmp_path):
    assert not correct("ensemble5-eval", tmp_path, table_dtype="int8")


@pytest.mark.card
@pytest.mark.parametrize("name", ["nerfacto-train", "nerfacto-eval"])
def test_tf32_control(name, card, tmp_path):
    """The reference with TF32 products in the program's place reads above
    the limits, at a size a test run holds on the card."""
    cell = tiny.cell(name)
    cell["config"]["model"].update(num_levels=8, max_res=512, log2_hashmap_size=14, hidden_dim=64,
                                   hidden_dim_color=64, geo_feat_dim=15, appearance_embed_dim=32)
    if name == "nerfacto-train":
        cell["traffic"].update(rays_per_step=1024)
    else:
        cell["config"]["model"]["eval_num_rays_per_chunk"] = 4096
        cell["traffic"].update(height=64, width=64, check_chunks=1)
    drv = harness.driver(cell["traffic"]["driver"])
    readings = drv.calibrate(cell, SEED, card)[0]
    from portbench.yardstick import compare

    assert not compare.judge(readings, harness.limits(drv))[0]


@pytest.mark.card
@pytest.mark.parametrize("broken", [False, True])
def test_the_checked_stretch_runs_the_captured_step(broken, card, tmp_path, monkeypatch):
    """On the card the stretch set-up checks ends in replays of the captured
    step that the window times: a replay that runs nothing comes out not
    correct."""
    if broken:
        monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", lambda self: None)
    result = harness.run_cell(tiny.cell("nerfacto-train"), SEED, 0.2, False, card, time.perf_counter(), tmp_path)
    assert result["diagnostics"]["checked"]["replayed_steps"] == 1
    assert result["correct"] is not broken, result["checks"]
