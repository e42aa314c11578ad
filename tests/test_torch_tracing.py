"""The port's spans and work counters (``utils/tracing.py``), on the CPU.

Off (no profile active), a span is the shared null context and records
nothing; the renders and a training launch run with
``torch.profiler.record_function`` broken. On, under ``torch.profiler``,
the exported trace nests the renderer's spans over the model's, the
counters move by what the spans did, and every output and loss equals the
untraced run's bit for bit."""

import contextlib
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from torch_parity import small_config_kwargs
from uncertainty_nerf_gs_torch.cameras.cameras import generate_rays
from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras
from uncertainty_nerf_gs_torch.engine.trainer import NerfactoTrainer
from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig
from uncertainty_nerf_gs_torch.scripts.eval_uncertainty import _nerfacto_full_image_renderer, build_ensemble_chunk_fn
from uncertainty_nerf_gs_torch.utils import tracing

H, W, N, CHUNK, SAMPLES = 6, 7, 2, 16, 8  # 42 rays: 3 chunks, the last padded by 6
CONFIG = NerfactoConfig(**small_config_kwargs(num_images=N, num_proposal_samples=(16, 8), num_nerf_samples=SAMPLES,
                                              eval_num_rays_per_chunk=CHUNK))
CAMERAS = hemisphere_cameras(N, H, W, seed=1)


def _trainer():
    images = np.random.default_rng(0).uniform(size=(N, H, W, 3)).astype(np.float32)
    return NerfactoTrainer(CONFIG, CAMERAS, images, seed=3, use_camera_optimizer=True, device="cpu")


def _one_model():
    model = _trainer().model
    return _nerfacto_full_image_renderer(CONFIG, lambda rb: model(rb, train=False, use_average_appearance=True),
                                         CAMERAS, device="cpu")


def _ensemble():
    """Two members fused: the trainer's weights and a perturbed copy."""
    model = _trainer().model
    g = torch.Generator().manual_seed(5)
    stacked = {k: torch.stack([v, v + 0.01 * torch.randn(v.shape, generator=g)]) if v.is_floating_point()
               else torch.stack([v, v]) for k, v in model.state_dict().items()}
    return _nerfacto_full_image_renderer(CONFIG, build_ensemble_chunk_fn(model, stacked), CAMERAS, device="cpu")


def _launches():
    """Five steps at two a launch: three launches on the CPU's loop."""
    trainer = _trainer()
    losses = []
    trainer.train(5, 32, steps_per_launch=2, callback=lambda i, row: losses.append(row["total_loss"]))
    return losses, {k: v.clone() for k, v in trainer.params().items()}


def _moved(before):
    return {k: n - before.get(k, 0) for k, n in tracing.counts().items() if n != before.get(k, 0)}


def _profiled(fn, tmp_path):
    """``fn()`` under ``torch.profiler``: its result, the ``ungs.`` spans of
    the exported trace as (name, start, end), and the counters' change."""
    before = tracing.counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith(tracing.PREFIX)]
    return out, spans, _moved(before)


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _each_inside(spans, inner, outer):
    """Every ``inner`` span lies inside one ``outer`` span."""
    outers = _named(spans, outer)
    return all(any(a <= s and e <= b for _, a, b in outers) for _, s, e in _named(spans, inner))


def _assert_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_span_off_is_the_shared_null_context(monkeypatch):
    null = tracing.span("ungs.render.image", images=1)
    assert isinstance(null, contextlib.nullcontext) and tracing.span("ungs.train.launch") is null

    def broken(*args, **kwargs):
        raise AssertionError("record_function called with no profile active")

    monkeypatch.setattr(torch.profiler, "record_function", broken)
    before = tracing.counts()
    _one_model()(1)
    _ensemble()(0)
    _launches()
    assert tracing.counts() == before


class _Ops(TorchDispatchMode):
    """The tensor operations run inside the block, by name."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def test_spans_add_no_tensor_operation():
    """``NerfactoModel._forward`` with its spans (and their counters) runs
    the operations of its three stages and no other, profiled or not."""
    model = _trainer().model
    rb = generate_rays(CAMERAS, torch.zeros(CHUNK, dtype=torch.int64), torch.arange(CHUNK, dtype=torch.float32),
                       torch.zeros(CHUNK))
    with torch.no_grad(), _Ops() as stages:
        planes = model._with_planes(rb)
        rs, _, _ = model._proposals(planes, 1.0, {})
        field_out = model.field(rs.positions, planes.directions, planes.camera_indices,
                                use_average_appearance=True, dropout=None)
        model._render(field_out, rs, {}, None, None, False)
    with _Ops() as plain:
        model(rb, train=False, use_average_appearance=True)
    with profile(activities=[ProfilerActivity.CPU]), _Ops() as traced:
        model(rb, train=False, use_average_appearance=True)
    assert plain.names == stages.names
    assert [n for n in traced.names if not n.startswith("profiler.")] == stages.names


def test_one_model_render_spans_nest(tmp_path):
    _, spans, moved = _profiled(lambda: _one_model()(1), tmp_path)
    chunks = -(-H * W // CHUNK)
    assert {n: len(_named(spans, n)) for n, _, _ in spans} == {
        "ungs.render.image": 1, "ungs.render.chunk": chunks, "ungs.render.assemble": 1,
        "ungs.nerfacto.proposals": chunks, "ungs.nerfacto.field": chunks, "ungs.nerfacto.composite": chunks}
    assert _each_inside(spans, "ungs.render.chunk", "ungs.render.image")
    assert _each_inside(spans, "ungs.render.assemble", "ungs.render.image")
    for stage in ("proposals", "field", "composite"):
        assert _each_inside(spans, f"ungs.nerfacto.{stage}", "ungs.render.chunk")
    assert moved == {"images": 1, "rays": H * W, "padded_rays": chunks * CHUNK - H * W, "chunks": chunks,
                     "samples": chunks * CHUNK * SAMPLES}


def test_fused_ensemble_render_spans_nest(tmp_path):
    _, spans, moved = _profiled(lambda: _ensemble()(0), tmp_path)
    chunks = -(-H * W // CHUNK)
    for stage in ("proposals", "lookup", "members", "combine"):
        assert len(_named(spans, f"ungs.ensemble.{stage}")) == chunks
        assert _each_inside(spans, f"ungs.ensemble.{stage}", "ungs.render.chunk")
    assert not [n for n, _, _ in spans if n.startswith("ungs.nerfacto.")]
    assert moved == {"images": 1, "rays": H * W, "padded_rays": chunks * CHUNK - H * W, "chunks": chunks}


def test_launch_spans_and_counts(tmp_path):
    _, spans, moved = _profiled(_launches, tmp_path)
    assert {n: len(_named(spans, n)) for n, _, _ in spans} == {
        "ungs.train.launch": 3, "ungs.train.read": 3, "ungs.train.rows": 3,
        "ungs.nerfacto.proposals": 5, "ungs.nerfacto.field": 5, "ungs.nerfacto.composite": 5}
    for inner in ("ungs.train.read", "ungs.nerfacto.proposals", "ungs.nerfacto.field", "ungs.nerfacto.composite"):
        assert _each_inside(spans, inner, "ungs.train.launch")
    assert moved == {"launches": 3, "steps": 5, "host_reads": 3, "samples": 5 * 32 * SAMPLES}


def test_profile_writes_trace_and_counts(tmp_path):
    render = _one_model()
    with tracing.profile(tmp_path / "run"):
        assert not isinstance(tracing.span("ungs.render.image"), contextlib.nullcontext)
        render(0)
    events = json.loads((tmp_path / "run" / "trace.json").read_text())["traceEvents"]
    assert [e for e in events if e.get("name") == "ungs.render.image" and e.get("cat") == "user_annotation"]
    chunks = -(-H * W // CHUNK)
    assert json.loads((tmp_path / "run" / "counts.json").read_text()) == {
        "images": 1, "rays": H * W, "padded_rays": chunks * CHUNK - H * W, "chunks": chunks,
        "samples": chunks * CHUNK * SAMPLES}


@pytest.mark.parametrize("path", ["one_model", "ensemble", "launches"])
def test_tracing_changes_no_number(path, tmp_path):
    run = {"one_model": lambda: _one_model()(1), "ensemble": lambda: _ensemble()(1), "launches": _launches}[path]
    off = run()
    on, spans, _ = _profiled(run, tmp_path)
    assert spans
    if path == "launches":
        assert off[0] == on[0]
        _assert_equal(off[1], on[1])
    else:
        _assert_equal(off, on)


def test_counts_from_many_threads():
    """Spans closing on more threads than cores, switching often, lose no
    count."""
    threads, each = 16, 3000

    def work():
        for _ in range(each):
            with tracing.span("ungs.render.chunk", chunks=1):
                pass

    interval = sys.getswitchinterval()
    before = tracing.counts()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert _moved(before) == {"chunks": threads * each}
