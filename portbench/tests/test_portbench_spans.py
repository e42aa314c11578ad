"""The program's ``ungs.`` spans in a profiled stretch: they change nothing
that an accepted reader reads, except that an idle gap which began in plain
Python inside a span is labelled with the span's name; ``read_spans``
attributes gaps and correlated device operations to the enclosing spans;
``profile`` keeps them and the counters that moved on its Trace, which the
accepted readers do not read and the span metrics' readers do; and on the
card the spans of an eval image and of a training launch with its capture
are in the benchmark's trace, matched to device operations and to the
counters, without changing a loss."""

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
SPAN_METRICS = ("render_host_ms.eval_single", "render_idle_ms.eval", "render_idle_ms.eval_single", "members_ms.eval",
                "launch_turnaround_ms.train")
ACCEPTED = [m["name"] for m in BENCH["per_layer"] if m["name"] not in SPAN_METRICS]


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


def _dress(t):
    """What a driver sets on a Trace for the FLOP and bound readers."""
    t.flops_per_unit, t.peak_flops = 1e9, 67e12
    t.bound_ms_per_unit.update(cell_lookup_bwd=1e-3, cell_lookup_fwd=1e-3, packed_cell_lookup=1e-3)
    return t


def _read(events, kind):
    return _dress(trace.read_trace(events, kind, 2))


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_spans_change_no_accepted_reading(kind):
    plain, marked = _read(BASE, kind), _read(BASE + SPANS, kind)
    for name in ("units", "kernels", "busy_s", "window_s", "launches", "runtime_ms"):
        assert getattr(marked, name) == getattr(plain, name), name
    for name in ACCEPTED:
        assert harness.reader(name)(marked) == harness.reader(name)(plain), name
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


# a launch over 100.5-295 with two replays of the captured step: 118-135
# (the gap at 120 began there) and 160-170 (the gap at 165)
TRAIN_SPANS = [
    _x("user_annotation", "ungs.train.launch", 100.5, 194.5),
    _x("user_annotation", "ungs.train.replay", 118.0, 17.0),
    _x("user_annotation", "ungs.train.replay", 160.0, 10.0),
]


def _profiled(events, kind, units, monkeypatch, tmp_path, counters=None, fn=lambda: None):
    """``trace.profile`` of ``fn`` as a stretch whose exported events are ``events``."""

    def fake_events(fn, workdir):
        fn()
        return events

    monkeypatch.setattr(trace, "_events", fake_events)
    return trace.profile(fn, tmp_path, kind, units, counters=counters)


def test_profile_keeps_the_spans_and_the_counts_that_moved(monkeypatch, tmp_path):
    totals = {"images": 4, "chunks": 80, "kernel_builds": 3}

    def work():
        totals["images"] += 1
        totals["chunks"] += 20
        totals["rays"] = 640_000

    t = _profiled(BASE + SPANS, "eval", 1, monkeypatch, tmp_path, counters=lambda: dict(totals), fn=work)
    assert t.spans == spans.read_spans(BASE + SPANS)
    assert t.counts == {"images": 1, "chunks": 20, "rays": 640_000}
    plain = trace.read_trace(BASE + SPANS, "eval", 1)
    for name in ("kernels", "busy_s", "window_s", "launches", "idle_by_host_op", "runtime_ms"):
        assert getattr(t, name) == getattr(plain, name), name
    assert _profiled(BASE, "eval", 1, monkeypatch, tmp_path).counts == {}


@pytest.mark.parametrize("kind", ["train", "eval"])
@pytest.mark.parametrize("name", ACCEPTED)
def test_accepted_readers_ignore_the_spans_and_counts(name, kind, monkeypatch, tmp_path):
    events = BASE + SPANS + TRAIN_SPANS
    moving = iter([{}, {"images": 2, "replays": 2}])
    full = _dress(_profiled(events, kind, 2, monkeypatch, tmp_path, counters=lambda: next(moving)))
    assert full.spans.count and full.counts
    assert harness.reader(name)(full) == harness.reader(name)(_read(events, kind))


# hand counts over BASE with SPANS, one image: the image span's host 185 us,
# its idle 147 us, 10 us of device time launched in the members' stage; over
# BASE with TRAIN_SPANS, two steps: window 200 us, busy 43 us, 55 us of idle
# began in a replay, one launch
SPAN_READINGS = {"render_host_ms.eval_single": ("eval", SPANS, 1, 0.185),
                 "render_idle_ms.eval": ("eval", SPANS, 1, 0.147),
                 "render_idle_ms.eval_single": ("eval", SPANS, 1, 0.147),
                 "members_ms.eval": ("eval", SPANS, 1, 0.010),
                 "launch_turnaround_ms.train": ("train", TRAIN_SPANS, 2, 0.102)}


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metrics_by_hand(name, monkeypatch, tmp_path):
    assert {m["name"] for m in BENCH["per_layer"]} >= set(SPAN_METRICS)
    kind, marks, units, value = SPAN_READINGS[name]
    read = harness.reader(name)
    assert read(_profiled(BASE + marks, kind, units, monkeypatch, tmp_path)) == pytest.approx(value)
    # a span count that misses the units, the other kind, or no spans: nothing read
    assert read(_profiled(BASE + marks, kind, units + 1, monkeypatch, tmp_path)) is None
    assert read(_profiled(BASE + marks, "train" if kind == "eval" else "eval", units, monkeypatch, tmp_path)) is None
    assert read(trace.read_trace(BASE + marks, kind, units)) is None


def test_members_and_turnaround_need_their_own_spans(monkeypatch, tmp_path):
    no_members = [e for e in SPANS if e["name"] != "ungs.ensemble.members"]
    assert harness.reader("members_ms.eval")(_profiled(BASE + no_members, "eval", 1, monkeypatch, tmp_path)) is None
    no_launch = [e for e in TRAIN_SPANS if e["name"] != "ungs.train.launch"]
    t = _profiled(BASE + no_launch, "train", 2, monkeypatch, tmp_path)
    assert harness.reader("launch_turnaround_ms.train")(t) is None


@pytest.mark.card
def test_spans_on_the_card(card, tmp_path):
    """A one-model eval image and a training launch with its capture, each
    in the benchmark's profile: the spans are there, device operations are
    matched to them, the counters moved with them, and the replays' losses
    equal an unprofiled trainer's bit for bit."""
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
    t = trace.profile(lambda: render(1), tmp_path, "eval", 1, counters=harness.program_counts)
    s = t.spans
    chunks = -(-16 * 20 // cfg.eval_num_rays_per_chunk)
    assert s.count["ungs.render.image"] == 1 and s.count["ungs.render.chunk"] == chunks
    assert t.counts["images"] == 1 and t.counts["chunks"] == chunks and t.counts["rays"] == 16 * 20
    assert s.count["ungs.nerfacto.field"] == chunks
    for name in ("ungs.render.image", "ungs.render.chunk", "ungs.nerfacto.proposals", "ungs.nerfacto.field"):
        assert s.device_s.get(name, 0.0) > 0.0, name

    steps = WARMUP_STEPS + 3
    plain, traced = [], []
    trainer().train(steps, 256, steps_per_launch=steps, callback=lambda i, row: plain.append(row))
    tr = trainer()
    t = trace.profile(lambda: tr.train(steps, 256, steps_per_launch=steps, callback=lambda i, row: traced.append(row)),
                      tmp_path, "train", steps, counters=harness.program_counts)
    s = t.spans
    assert traced == plain
    assert t.counts["launches"] == 1 and t.counts["captures"] == 1 and t.counts["replays"] == 3
    assert s.count["ungs.train.launch"] == 1 and s.count["ungs.train.capture"] == 1
    assert s.count["ungs.train.warmup"] == 1 and s.count["ungs.train.replay"] == 3
    assert s.device_s["ungs.train.replay"] > 0.0 and s.device_s["ungs.train.warmup"] > 0.0
    assert s.device_s["ungs.train.launch"] >= s.device_s["ungs.train.replay"] + s.device_s["ungs.train.warmup"]
