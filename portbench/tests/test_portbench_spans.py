"""The program's ``ungs.`` spans in a profiled stretch: they change nothing
that an accepted reader reads, except that an idle gap which began in plain
Python inside a span is labelled with the span's name; ``read_spans``
attributes gaps and correlated device operations to the enclosing spans;
and on the card the spans of an eval image and of a training launch with
its capture are in the benchmark's trace, matched to device operations,
without changing a loss."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import harness
from portbench.tests import tiny
from portbench.yardstick import spans, trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NO_HOST = "(no host operation)"


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# The marked stretch 100-300: device operations at 110-120 (launched at 101),
# 140-150 (a graph launched at 131), a copy at 152-165 (launched at 150) and
# 200-210 (launched at 181); the host in aten::mul at 120-125 and otherwise
# in plain Python. Idle gaps begin at 100, 120, 150, 165 and 210.
BASE = [
    _x("user_annotation", trace.SPAN, 100.0, 200.0),
    _x("cuda_runtime", "cudaLaunchKernel", 101.0, 2.0, corr=1),
    _x("kernel", "void k_a(float*)", 110.0, 10.0, corr=1),
    _x("cpu_op", "aten::mul", 120.0, 5.0),
    _x("cuda_runtime", "cudaGraphLaunch", 131.0, 12.0, corr=2),
    _x("kernel", "void gemm_b(float*)", 140.0, 10.0, corr=2),
    _x("cuda_runtime", "cudaMemcpyAsync", 150.0, 5.0, corr=3),
    _x("gpu_memcpy", "Memcpy DtoH", 152.0, 13.0, corr=3),
    _x("cuda_runtime", "cudaLaunchKernel", 181.0, 2.0, corr=4),
    _x("kernel", "void k_c(float*)", 200.0, 10.0, corr=4),
]
# the spans: an image over 105-290 with chunks at 106-160 and 170-250, the
# members' stage at 175-190 inside the second chunk
SPANS = [
    _x("user_annotation", "ungs.render.image", 105.0, 185.0),
    _x("user_annotation", "ungs.render.chunk", 106.0, 54.0),
    _x("user_annotation", "ungs.render.chunk", 170.0, 80.0),
    _x("user_annotation", "ungs.ensemble.members", 175.0, 15.0),
]


def _read(events, kind):
    t = trace.read_trace(events, kind, 2)
    t.flops_per_unit, t.peak_flops = 1e9, 67e12
    t.bound_ms_per_unit.update(cell_lookup_bwd=1e-3, cell_lookup_fwd=1e-3, packed_cell_lookup=1e-3)
    return t


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_spans_change_no_accepted_reading(kind):
    plain, marked = _read(BASE, kind), _read(BASE + SPANS, kind)
    for name in ("units", "kernels", "busy_s", "window_s", "launches", "runtime_ms"):
        assert getattr(marked, name) == getattr(plain, name), name
    for m in BENCH["per_layer"]:
        assert harness.reader(m["name"])(marked) == harness.reader(m["name"])(plain), m["name"]
    moved = {k: v for k, v in marked.idle_by_host_op.items() if k.startswith(spans.PREFIX)}
    # 165-200 began between the chunks, 210-300 inside the second chunk
    assert moved == pytest.approx({"ungs.render.image": 35e-6, "ungs.render.chunk": 90e-6})
    assert marked.idle_by_host_op[NO_HOST] == pytest.approx(plain.idle_by_host_op[NO_HOST] - 125e-6)
    others = {k: v for k, v in plain.idle_by_host_op.items() if k != NO_HOST}
    assert others == pytest.approx({"aten::mul": 20e-6, "cudaMemcpyAsync": 2e-6})
    assert {k: v for k, v in marked.idle_by_host_op.items() if k in others} == others


def test_read_spans_attributes_gaps_and_kernels_to_enclosing_spans():
    s = spans.read_spans(BASE + SPANS)
    assert s.count == {"ungs.render.image": 1, "ungs.render.chunk": 2, "ungs.ensemble.members": 1}
    assert s.host_s == pytest.approx({"ungs.render.image": 185e-6, "ungs.render.chunk": 134e-6,
                                      "ungs.ensemble.members": 15e-6})
    # the gap at 100 began before the image; 120-140 and 150-152 in the first
    # chunk, 165-200 between the chunks, 210-300 in the second chunk (a gap
    # counts where it began)
    assert s.idle_s == pytest.approx({spans.OUTSIDE: 10e-6, "ungs.render.image": 147e-6,
                                      "ungs.render.chunk": 112e-6})
    # k_a was launched before the image; the graph and the copy in the first
    # chunk, k_c in the members' stage
    assert s.device_s == pytest.approx({"ungs.render.image": 33e-6, "ungs.render.chunk": 33e-6,
                                        "ungs.ensemble.members": 10e-6})


def test_read_spans_without_spans():
    s = spans.read_spans(BASE)
    assert s.count == {} and s.device_s == {}
    t = trace.read_trace(BASE, "eval", 1)
    assert s.idle_s == pytest.approx({spans.OUTSIDE: t.window_s - t.busy_s})


def _traced(fn, units, kind, monkeypatch, tmp_path):
    """``fn`` profiled as the benchmark profiles a stretch, and its events."""
    seen = []
    read = trace.read_trace

    def keep(events, kind, units):
        seen.append(events)
        return read(events, kind, units)

    monkeypatch.setattr(trace, "read_trace", keep)
    t = trace.profile(fn, tmp_path, kind, units)
    return t, spans.read_spans(seen[0])


@pytest.mark.card
def test_spans_on_the_card(card, monkeypatch, tmp_path):
    """A one-model eval image and a training launch with its capture, each
    in the benchmark's profile: the spans are there, device operations are
    matched to them, and the replays' losses equal an unprofiled trainer's
    bit for bit."""
    from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras
    from uncertainty_nerf_gs_torch.engine.trainer import WARMUP_STEPS, NerfactoTrainer
    from uncertainty_nerf_gs_torch.scripts.eval_uncertainty import _nerfacto_full_image_renderer

    cfg = harness.program_config(tiny.cell("nerfacto-eval")["config"]["model"])
    cams = hemisphere_cameras(cfg.num_images, 16, 20, seed=1)
    images = np.random.default_rng(0).uniform(size=(cfg.num_images, 16, 20, 3)).astype(np.float32)

    def trainer():
        return NerfactoTrainer(cfg, cams, images, seed=3, device=card)

    model = trainer().model
    render = _nerfacto_full_image_renderer(cfg, lambda rb: model(rb, train=False, use_average_appearance=True),
                                           cams, card)
    render(0)
    _, s = _traced(lambda: render(1), 1, "eval", monkeypatch, tmp_path)
    chunks = -(-16 * 20 // cfg.eval_num_rays_per_chunk)
    assert s.count["ungs.render.image"] == 1 and s.count["ungs.render.chunk"] == chunks
    assert s.count["ungs.nerfacto.field"] == chunks
    for name in ("ungs.render.image", "ungs.render.chunk", "ungs.nerfacto.proposals", "ungs.nerfacto.field"):
        assert s.device_s.get(name, 0.0) > 0.0, name

    steps = WARMUP_STEPS + 3
    plain, traced = [], []
    trainer().train(steps, 256, steps_per_launch=steps, callback=lambda i, row: plain.append(row))
    tr = trainer()
    _, s = _traced(lambda: tr.train(steps, 256, steps_per_launch=steps, callback=lambda i, row: traced.append(row)),
                   steps, "train", monkeypatch, tmp_path)
    assert traced == plain
    assert s.count["ungs.train.launch"] == 1 and s.count["ungs.train.capture"] == 1
    assert s.count["ungs.train.warmup"] == 1 and s.count["ungs.train.replay"] == 3
    assert s.device_s["ungs.train.replay"] > 0.0 and s.device_s["ungs.train.warmup"] > 0.0
    assert s.device_s["ungs.train.launch"] >= s.device_s["ungs.train.replay"] + s.device_s["ungs.train.warmup"]
