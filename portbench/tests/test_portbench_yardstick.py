"""The frozen bound, FLOP and trace arithmetic against hand counts."""

import json
from pathlib import Path

import pytest
import torch

from portbench.yardstick import bounds, flops, peaks, trace

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def test_grid_bound_counts_bytes_once():
    # 10 positions, 2 levels, F = 2, 3 distinct cells: positions 120 B, cells
    # 3 x 8 x 2 x 4 = 192 B, features 10 x 2 x 2 x 4 = 160 B
    fwd = 120 + 192 + 160
    assert bounds.grid_bound_ms(10, 2, 2, 3, backward=False) == pytest.approx(
        1e3 * max(fwd / peaks.HBM_BYTES_PER_S, 20 * (25 + 32) / peaks.F32_FLOPS))
    bwd = fwd + 192 + 120
    assert bounds.grid_bound_ms(10, 2, 2, 3, backward=True) == pytest.approx(
        1e3 * max(bwd / peaks.HBM_BYTES_PER_S, 20 * (25 + 16 + 32 + 75) / peaks.F32_FLOPS))


def test_k6_bound_counts_rows_at_their_bytes():
    # 4 samples, 2 levels, M = 5, F = 2, 6 lookups, 3 distinct bf16 rows, one strided level
    nbytes = 16 * 4 + 3 * 8 * 5 * 2 * 2 + 4 * 5 * 4 * 2 * 2
    ops = 6 * (25 + 16 * 2 * 5) + 4 * (6 + 3 * 2 * 5)
    got = bounds.k6_bound_ms(4, 2, 5, 2, 6, 3, 2, strided_levels=1)
    assert got == pytest.approx(1e3 * max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.F32_FLOPS))


def test_distinct_cells_counts_each_level_apart():
    pos = torch.tensor([[0.1, 0.1, 0.1], [0.2, 0.1, 0.1], [0.9, 0.9, 0.9]])
    # res 2: the first two share a cell; res 16: all three differ
    assert bounds.distinct_cells(pos, [2, 16], 4096) == 2 + 3


def test_forward_flops_by_hand():
    model = json.loads((CONFIGS / "active-nerfacto.json").read_text())["model"]
    proposal = 10 * 16 + 16 * 1
    field = 32 * 64 + 64 * (1 + 15 + 1) + 63 * 64 + 64 * 64 + 64 * 3
    assert flops.forward_flops_per_ray(model) == 2 * (256 * proposal + 96 * proposal + 48 * field)
    ens = json.loads((CONFIGS / "nerfacto-ensemble5.json").read_text())["model"]
    field_ens = field - 64
    assert flops.forward_flops_per_ray(ens, 5) == 5 * 2 * (352 * proposal + 48 * field_ens)


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_read_trace_busy_idle_and_launches():
    events = [
        _event("user_annotation", trace.SPAN, 100.0, 50.0),
        _event("cpu_op", "aten::copy_", 100.0, 15.0),
        _event("cuda_runtime", "cudaLaunchKernel", 101.0, 2.0),
        _event("cuda_runtime", "cudaGraphLaunch", 120.0, 2.0),
        _event("kernel", "void k_a(float*)", 110.0, 10.0),
        _event("kernel", "void k_b(float*)", 115.0, 10.0),
        _event("kernel", "spin_kernel", 90.0, 5.0),
        _event("gpu_memcpy", "Memcpy DtoH", 140.0, 20.0),
    ]
    t = trace.read_trace(events, "eval", 2)
    assert t.window_s == pytest.approx(60e-6)
    assert t.busy_s == pytest.approx(35e-6)
    assert t.launches == 2
    assert t.runtime_ms == pytest.approx({"cudaLaunchKernel": 0.002, "cudaGraphLaunch": 0.002})
    # idle 100-110 while copy_ ran, 125-140 with nothing running
    assert t.idle_by_host_op["aten::copy_"] == pytest.approx(10e-6)
    assert sum(t.idle_by_host_op.values()) == pytest.approx(25e-6)
    assert t.device_ms(r"k_") == pytest.approx(0.02)
    assert [n for n, _ in t.breakdown()["device_ops"]] == ["Memcpy DtoH", "k_a", "k_b"]
