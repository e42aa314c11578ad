"""The harness finds each cell's files by name, the benchmark file keeps to
its contract's shape, and a run's last line has the keys it must have."""

import json
import re
import time
from pathlib import Path

import pytest
import torch

from portbench import harness, run
from portbench.tests import tiny
from portbench.yardstick import trace

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
    quantities = {"train_step_ms", "eval_image_ms", "setup_s"}
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
    assert set(result["metrics"]) == {m["name"] for m in tiny.cell(name)["end_to_end"]}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())
    json.dumps(run._finite(result), allow_nan=False)


def test_tiny_cells_name_the_benchmarks_files():
    for w in BENCH["workloads"]:
        assert tiny.CELLS[w["name"]] == (w["config"], w["traffic"])
