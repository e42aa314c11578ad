"""The harness finds each cell's files by name, the benchmark file keeps to
its contract's shape, a run's last line has the keys it must have, and a
driver's own limits judge its own readings and never an accepted one."""

import json
import re
import time
import types
from pathlib import Path

import pytest
import torch

from portbench import harness, run
from portbench.tests import tiny
from portbench.yardstick import compare, trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_file_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in BENCH["end_to_end"]] \
        + [m["name"] for m in BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()


@pytest.mark.parametrize("name", CELLS)
def test_cells_are_found_by_name(name):
    cell = harness.load_cell(name, ROOT)
    assert harness.driver(cell["traffic"]["driver"]).KIND in ("train", "eval")
    assert cell["config"]["model"]["eval_num_rays_per_chunk"] == 1 << 15
    assert [m["name"] for m in cell["end_to_end"]][-1] == "setup_s" and len(cell["end_to_end"]) == 2
    assert cell["per_layer"]
    harness.program_config(cell["config"]["model"])  # every key is one of the program's


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    empty = trace.Trace(kind="none", units=1, kernels=[], busy_s=0.0, window_s=0.0, launches=0,
                        idle_by_host_op={})
    assert harness.reader(metric)(empty) is None


def test_cells_are_made_from_file_names_alone():
    cell = harness.make_cell("x", "active-nerfacto", "eval-images-800")
    assert cell["config"]["method"] == "active-nerfacto" and cell["traffic"]["poses"] == 200
    assert cell["end_to_end"] == [] and cell["per_layer"] == []
    with pytest.raises(ValueError):
        harness.driver("../run")


def test_end_to_end_variants_report_the_drivers_quantity():
    quantities = {"train_step_ms", "eval_image_ms", "eval_device_ms", "setup_s"}
    assert {m["name"].split(".")[0] for m in BENCH["end_to_end"]} <= quantities


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", CELLS[0], "--seed", str(2**31 + 5), "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name", CELLS)
def test_result_line_keys(name, tmp_path):
    result = harness.run_cell(tiny.cell(name), 2**31 + 9, 0.2, False, torch.device("cpu"), time.perf_counter(),
                              tmp_path)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    # on the CPU there is no device trace to record
    assert set(result["metrics"]) == {m["name"] for m in tiny.cell(name)["end_to_end"] if m["source"] == "host_clock"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())
    json.dumps(run._finite(result), allow_nan=False)


def test_tiny_cells_name_the_benchmarks_files():
    for w in BENCH["workloads"]:
        assert tiny.CELLS[w["name"]] == (w["config"], w["traffic"])


def test_accepted_limits_are_the_calibrated_four():
    assert compare.LIMITS == {"first_loss_gap": 1e-6, "grad_gap": 3e-5, "update_gap": 5e-2, "image_gap": 5e-4}


def _stub(readings, limits=None):
    """A driver whose window produced ``readings``."""
    drv = types.ModuleType("portbench.drivers.stub")
    drv.KIND = "eval"
    if limits is not None:
        drv.LIMITS = limits
    drv.drive = lambda *a: {"attempted": 1, "failed": 0, "peak": 0, "metrics": {}, "readings": dict(readings)}
    return drv


def _run_stub(drv, monkeypatch, tmp_path):
    monkeypatch.setattr(harness, "driver", lambda name: drv)
    cell = harness.make_cell("stub", "active-nerfacto", "eval-images-800")
    return harness.run_cell(cell, 2**31 + 11, 0.1, False, torch.device("cpu"), time.perf_counter(), tmp_path)


@pytest.mark.parametrize("gap, correct", [(5e-4, True), (2e-3, False)])
def test_a_drivers_own_limit_is_judged(gap, correct, monkeypatch, tmp_path):
    drv = _stub({"splat_gap": gap, "image_gap": 0.0, "splat_gpa": 1.0}, limits={"splat_gap": 1e-3})
    assert harness.limits(drv) == {**compare.LIMITS, "splat_gap": 1e-3}
    result = _run_stub(drv, monkeypatch, tmp_path)
    assert result["correct"] is correct
    assert result["checks"] == {"splat_gap": {"value": gap, "limit": 1e-3}, "image_gap": {"value": 0.0, "limit": 5e-4}}
    assert result["diagnostics"]["unjudged"] == ["splat_gpa"]


def test_a_driver_may_not_repeat_an_accepted_limit(monkeypatch, tmp_path):
    drv = _stub({"image_gap": 0.3}, limits={"image_gap": 0.5, "splat_gap": 1e-3})
    with pytest.raises(ValueError, match="image_gap"):
        harness.limits(drv)
    with pytest.raises(ValueError, match="image_gap"):
        _run_stub(drv, monkeypatch, tmp_path)
    assert compare.LIMITS["image_gap"] == 5e-4


def test_a_driver_without_limits_is_judged_on_the_accepted_ones(monkeypatch, tmp_path):
    result = _run_stub(_stub({"image_gap": 1e-4, "loss_gap": 0.2}), monkeypatch, tmp_path)
    assert result["correct"] is True and list(result["checks"]) == ["image_gap"]
    assert result["diagnostics"]["unjudged"] == ["loss_gap"]
    assert _run_stub(_stub({"splat_gap": 0.0}), monkeypatch, tmp_path)["correct"] is False


@pytest.mark.parametrize("name, unjudged", [("nerfacto-train", ["loss_gap"]), ("nerfacto-eval", [])])
def test_accepted_drivers_leave_only_the_uncompared_loss_unjudged(name, unjudged, tmp_path):
    result = harness.run_cell(tiny.cell(name), 2**31 + 13, 0.2, False, torch.device("cpu"), time.perf_counter(),
                              tmp_path)
    assert result["diagnostics"]["unjudged"] == unjudged
    assert set(result["checks"]) | set(unjudged) == set(result["diagnostics"]["readings"])


def test_window_metric_reads_the_runs_window():
    t = trace.Trace(kind="eval", units=3, kernels=[], busy_s=0.0, window_s=0.0, launches=0, idle_by_host_op={},
                    window={"eval_image_ms": 204.5, "setup_s": 17.0})
    assert harness.reader("image_ms.eval_single")(t) == 204.5
    t.kind = "train"
    assert harness.reader("image_ms.eval_single")(t) is None


@pytest.mark.card
def test_device_busy_matches_the_full_profile(card, tmp_path):
    """The window's record of device operations alone finds the same busy
    time and operations as the traced stretch's full profile."""
    a = torch.randn(2048, 2048, device=card)

    def work():
        for _ in range(20):
            (a @ a).cos()

    work()
    busy_s, ops = trace.device_busy(work)
    t = trace.profile(work, tmp_path, "eval", 1)
    assert ops == len(t.kernels) >= 40
    assert abs(busy_s - t.busy_s) <= 0.05 * t.busy_s
