"""The splat-train cell's own pieces: the cell made from its files, its
five readers and the two accepted ones it reports on a hand-made
trace, its driver's limits beside the accepted ones, its bounds by hand,
the reference's block-wise gradient against its one-block gradient, a run
of the tiny cell on the CPU, the driver's calibration at a tiny size, and
on the card the traced run's image gaps under their limits.

``test_portbench_harness.py`` holds every cell of ``BENCHMARK.json`` to the
nerfacto cells' model keys and ``tiny.py``'s list, which this cell has
neither of; the first and the tiny run here check it in their place."""

import json
import math
import time
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.drivers import splat_train
from portbench.reference import splatfacto as ref
from portbench.tests import tiny_splat
from portbench.yardstick import compare, splat_bounds, trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# the cell's own readers, each left out where the span count misses the steps
OWN = ("step_host_ms.splat_train", "rasterize_ms.splat_train", "backward_ms.splat_train", "composite_fwd_roofline",
       "composite_bwd_roofline")
# the accepted training readers the cell joins through their workloads
ACCEPTED = ("device_idle_share.train", "adam_ms.train")
READERS = OWN + ACCEPTED
SEED = 2**31 + 3141


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(at, corr, kernel, start, dur):
    return [_x("cuda_runtime", "cudaLaunchKernel", at, 1.0, corr), _x("kernel", kernel, start, dur, corr)]


# The marked stretch 100-300 holds two steps (100.5-190, 195-295); in each,
# the rasterizer (110-130, 200-220) launches K2 and a sort, the backward
# (140-160, 230-250) K3, the update (165-175, 255-265) an Adam kernel.
# Busy 85 us of 200; host in the steps 189.5 us.
EVENTS = [
    _x("user_annotation", trace.SPAN, 100.0, 200.0),
    _x("user_annotation", "ungs.splat.step", 100.5, 89.5),
    _x("user_annotation", "ungs.splat.rasterize", 110.0, 20.0),
    _x("user_annotation", "ungs.splat.backward", 140.0, 20.0),
    _x("user_annotation", "ungs.splat.update", 165.0, 10.0),
    _x("user_annotation", "ungs.splat.step", 195.0, 100.0),
    _x("user_annotation", "ungs.splat.rasterize", 200.0, 20.0),
    _x("user_annotation", "ungs.splat.backward", 230.0, 20.0),
    _x("user_annotation", "ungs.splat.update", 255.0, 10.0),
    *_launch(111.0, 1, "void (anonymous namespace)::composite_fwd_kernel<6>(float const*)", 120.0, 10.0),
    *_launch(112.0, 7, "void at::native::radixSortKVInPlace(float*)", 131.0, 8.0),
    *_launch(141.0, 3, "void (anonymous namespace)::composite_bwd_kernel<6>(float const*)", 150.0, 20.0),
    *_launch(166.0, 5, "void multi_tensor_apply_kernel(float*)", 172.0, 4.0),
    *_launch(201.0, 2, "void (anonymous namespace)::composite_fwd_kernel<6>(float const*)", 210.0, 12.0),
    *_launch(231.0, 4, "void (anonymous namespace)::composite_bwd_kernel<6>(float const*)", 240.0, 25.0),
    *_launch(256.0, 6, "void multi_tensor_apply_kernel(float*)", 268.0, 6.0),
]
HAND = {"device_idle_share.train": 100.0 * (1 - 85.0 / 200.0), "step_host_ms.splat_train": 189.5e-3 / 2,
        "rasterize_ms.splat_train": 30e-3 / 2, "backward_ms.splat_train": 45e-3 / 2,
        "adam_ms.train": 10e-3 / 2, "composite_fwd_roofline": 100.0 * 2e-3 * 2 / 22e-3,
        "composite_bwd_roofline": 100.0 * 9e-3 * 2 / 45e-3}


def _profiled(events, kind, units, monkeypatch, tmp_path):
    monkeypatch.setattr(trace, "_events", lambda fn, workdir: events)
    t = trace.profile(lambda: None, tmp_path, kind, units)
    t.bound_ms_per_unit.update(composite_fwd=2e-3, composite_bwd=9e-3)
    return t


def test_the_cell_is_made_from_its_files():
    from uncertainty_nerf_gs_torch.ops import composite

    cell = harness.load_cell(tiny_splat.NAME, ROOT)
    assert {w["name"]: (w["config"], w["traffic"], w["chips"]) for w in BENCH["workloads"]}[tiny_splat.NAME] == (
        tiny_splat.CONFIG, tiny_splat.TRAFFIC, 1)
    assert [m["name"] for m in cell["end_to_end"]] == ["train_step_ms", "setup_s"]
    assert {m["name"] for m in cell["per_layer"]} == set(READERS)
    assert harness.driver(cell["traffic"]["driver"]) is splat_train and splat_train.KIND == "train"
    assert splat_train.program_config(cell["config"]["model"]).capacity == 1 << 19
    assert cell["config"]["model"]["sh_degree"] == 3 and cell["config"]["state"]["live"] == 300_000
    # the compositing rules the configuration states are the program's
    rules = cell["config"]["compositing"]
    assert (rules["alpha_clamp"], rules["alpha_min"], rules["exit_batch"], rules["exit_transmittance"]) == (
        composite.ALPHA_CLAMP, composite.ALPHA_MIN, composite.K_CHUNK, composite.EXIT_EPS)


@pytest.mark.parametrize("name", READERS)
def test_readers_by_hand(name, monkeypatch, tmp_path):
    read = harness.reader(name)
    assert read(_profiled(EVENTS, "train", 2, monkeypatch, tmp_path)) == pytest.approx(HAND[name])
    assert read(_profiled(EVENTS, "eval", 2, monkeypatch, tmp_path)) is None
    if name in OWN:
        # a span count that misses the steps, or no spans: nothing read
        assert read(_profiled(EVENTS, "train", 3, monkeypatch, tmp_path)) is None
        plain = [e for e in EVENTS if not e["name"].startswith("ungs.")]
        assert read(_profiled(plain, "train", 2, monkeypatch, tmp_path)) is None


def test_limits_sit_beside_the_accepted_ones():
    assert not set(splat_train.LIMITS) & set(compare.LIMITS)
    assert harness.limits(splat_train) == {**compare.LIMITS, **splat_train.LIMITS}
    assert splat_train.LIMITS["splat_overflow"] == 0
    # the depth variance is judged apart from the other channels, whose limit is far tighter
    assert splat_train.LIMITS["splat_image_gap"] < 1e-3 * splat_train.LIMITS["splat_depth_var_gap"]


def test_image_readings_split_the_depth_variance():
    def img(**scale):
        return {k: torch.full((4, 5), scale.get(k, 1.0)) for k in splat_train.StepRecorder.OUTPUTS}

    prog = {"losses": [1.0], "grad": {"means": torch.ones(3)}, "change": {"means": torch.ones(3)}}
    line, _ = splat_train.readings(prog, prog, [(img(depth_var=1 + 2**-5), img()), (img(rgb=1 + 2**-10), img())], 0)
    assert line["splat_depth_var_gap"] == 2**-5
    assert line["splat_image_gap"] == 2**-10
    assert compare.judge(line, harness.limits(splat_train))[0] is False


def test_bounds_by_hand():
    # 1,000 rows composited over 10 tiles, C = 6: forward 34 operations a
    # pair, backward 80; bytes of the rows, pix, counts, outputs (and for
    # K3 the outputs and their gradients again, and the composited rows'
    # gradients; no slot past them)
    fwd_bytes = 4 * (1000 * 12 + 10 * 256 * 2 + 10) + 4 * 10 * 256 * 7
    bwd_bytes = 4 * (1000 * 12 + 10 * 256 * 2 + 10) + 4 * (2 * 10 * 256 * 7 + 1000 * 12)
    assert splat_bounds.composite_bytes(1000, 10, 6, False) == fwd_bytes
    assert splat_bounds.composite_bytes(1000, 10, 6, True) == bwd_bytes
    assert splat_bounds.composite_bound_ms(1000, 10, 6, False) == pytest.approx(
        1e3 * max(fwd_bytes / 3.35e12, 1000 * 256 * 34 / 67e12))
    assert splat_bounds.composite_bound_ms(1000, 10, 6, True) == pytest.approx(
        1e3 * max(bwd_bytes / 3.35e12, 1000 * 256 * 80 / 67e12))


def test_blockwise_gradient_equals_one_block():
    cell = tiny_splat.cell()
    cfg, dev = cell["config"], torch.device("cpu")
    sc = splat_train.training_views(cell["traffic"], SEED, dev)
    state = splat_train.seeded_state(cfg, SEED, dev)
    cam = {"c2w": sc["c2w"][1], "fx": float(sc["focal"][1]), "fy": float(sc["focal"][1]), "cx": float(sc["cx"][1]),
           "cy": float(sc["cy"][1]), "width": sc["width"], "height": sc["height"]}
    args = (state["params"], state["alive"], cam, torch.tensor([0.2, 0.5, 0.9]), sc["images"][1],
            splat_train.reference_config(cfg), 3)
    one = ref.step_gradients(*args, block_limit=1 << 40)
    many = ref.step_gradients(*args, block_limit=1)  # a tile a block
    assert len(ref.blocks(one["counts"], 1)) == int((one["counts"] > 0).sum()) > 1
    assert many["loss"] == one["loss"]
    for k, g in one["grads"].items():
        assert torch.count_nonzero(g) > 0, k
        torch.testing.assert_close(many["grads"][k], g, rtol=1e-5, atol=1e-6 * float(g.abs().max()))


def test_tiny_cell_runs_correct_on_the_cpu(tmp_path):
    cell = tiny_splat.cell()
    result = harness.run_cell(cell, SEED, 0.2, False, torch.device("cpu"), time.perf_counter(), tmp_path)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    # on the CPU there is no device trace to record
    assert set(result["metrics"]) == {m["name"] for m in cell["end_to_end"]} == {"train_step_ms", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    assert set(result["checks"]) == set(splat_train.LIMITS)
    assert result["diagnostics"]["unjudged"] == []
    probes = result["diagnostics"]["probes"]
    assert probes["end"]["overflow"] == 0 and probes["start"]["tile_max"] <= probes["start"]["rasterize_capacity"]


def test_calibration_control_passes_and_faults_fail():
    cell = tiny_splat.cell()
    bar = harness.limits(splat_train)
    lines = {line["reading"]: line for line in splat_train.calibrate(cell, SEED, torch.device("cpu"))}
    assert compare.judge(lines["control_float64"], bar)[0] is True
    for fault in ("fault_payload_bf16", "fault_budget_cut", "fault_sh_degree_2"):
        assert compare.judge(lines[fault], bar)[0] is False, fault
    assert all(f"exit_batch_{b}" in lines for b in splat_train.EXIT_BATCHES)
    assert math.isfinite(lines["reference_seconds"]["value"])


@pytest.mark.card
def test_traced_run_image_gap_on_the_card(card, tmp_path):
    """The tiny cell through the kernels, traced: correct, its image gaps
    under their limits, and the seven readers find what they read."""
    cell = tiny_splat.cell()
    cell["per_layer"] = [{"name": name, "unit": "-"} for name in READERS]
    result = harness.run_cell(cell, SEED, 0.5, True, card, time.perf_counter(), tmp_path)
    assert result["correct"] is True
    for name in ("splat_image_gap", "splat_depth_var_gap"):
        assert result["checks"][name]["value"] <= splat_train.LIMITS[name]
    assert set(result["metrics"]) == set(READERS)
