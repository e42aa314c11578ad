"""Spans and work counters of the port, on the profiler's clock.

``span(name, **counters)`` marks a stretch of the program's host code at a
layer boundary. It is on while a ``torch.profiler`` profile is active: any
profile of the program shows its spans, ``profile(log_dir)`` below and a
benchmark's or a test's profile alike, and nothing has to switch them on.

* Off, ``span`` checks one flag and returns one shared null context: it
  reads no clock, makes no profiler call and records nothing.
* On, the span is a ``torch.profiler.record_function`` range. The profiler
  writes it as a ``user_annotation`` event into the same trace as the
  device's kernels, copies and memsets, on the same clock. When it closes
  it adds its counters to ``counts()``; a range's argument string does not
  reach an exported trace, so the counts live here.

Every name starts with ``ungs.``, so a reader of a trace tells the
program's spans from the profiler's own operators by that prefix. The
spans are coarse, one a layer boundary and none a kernel call:

* ``ungs.render.image``: ``scripts/eval_uncertainty.py``'s full-image
  renderer, a whole ``render(i)`` (``images``; ``rays``, h w;
  ``padded_rays``, the last chunk's pad);
* ``ungs.render.chunk``: each chunk, its rays and the chunk function
  (``chunks``); ``ungs.render.assemble``: the chunks joined into the image;
* ``ungs.nerfacto.proposals``, ``.field`` (``samples``, the main field's)
  and ``.composite``: ``models/nerfacto.py``'s ``NerfactoModel._forward``;
* ``ungs.ensemble.proposals`` (the shared chain), ``.lookup`` (the main
  field's member-packed lookup), ``.members`` (the members' MLPs and
  compositing) and ``.combine``: ``parallel/ensemble_fused.py``'s fused
  render;
* ``ungs.train.launch``: ``engine/trainer.py``'s ``NerfactoTrainer._launch``
  (``launches``, ``steps``); inside it ``ungs.train.warmup`` (the eager
  steps before the capture), ``ungs.train.capture`` (``captures``),
  ``ungs.train.replay`` (a replay of the graph and its loss copy,
  ``replays``) and ``ungs.train.read`` (the host read of the losses,
  ``host_reads``); ``ungs.train.rows``: ``train``'s loop over a launch's
  rows (writer, log, callback);
* ``ungs.splat.step``: ``engine/splat_trainer.py``'s
  ``SplatfactoTrainer.train_step``, a whole step (``splat_steps``); inside
  it ``ungs.splat.loss`` (``splatfacto_loss``), ``ungs.splat.backward``
  (``total.backward()``), ``ungs.splat.update`` (the attribute Adams and
  the camera Adam) and ``ungs.splat.stats`` (``accumulate_stats``);
  ``ungs.splat.refine`` (``refines``) and ``ungs.splat.retune``
  (``retunes``), from the step's schedule or called on their own;
* ``ungs.splat.project``: ``models/splatfacto.py``'s ``render_splat``, the
  projection and the SH colours (``gaussians``, the buffer's capacity);
  ``ungs.splat.rasterize``: its depth sort, tile cull, pack and K2
  (``tiles``, T; ``tile_slots``, T x ``rasterize_capacity``);
* ``ungs.backend.build``: ``ops/backend.py``'s ``nvcc`` runs
  (``kernel_builds``, one a source compiled).

A profile holds as many spans of a name as its counter moved: as many
``ungs.render.image`` spans as ``images``, and so on. ``ops/backend.py``'s
``launch_counts`` count the hand-written kernels' launches, on or off.
"""

from __future__ import annotations

import contextlib
import json
import threading
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "ungs."
_NULL = contextlib.nullcontext()
_counts: dict[str, int] = {}
_counts_lock = threading.Lock()  # a live viewer's renders run spans on another thread


def counts() -> dict[str, int]:
    """The counters' totals since the process started (a copy)."""
    with _counts_lock:
        return dict(_counts)


class _Span:
    __slots__ = ("_name", "_counters", "_range")

    def __init__(self, name: str, counters: dict[str, int]):
        self._name, self._counters = name, counters

    def __enter__(self):
        self._range = torch.profiler.record_function(self._name)
        self._range.__enter__()

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        with _counts_lock:
            for key, n in self._counters.items():
                _counts[key] = _counts.get(key, 0) + n
        return False


def span(name: str, **counters: int):
    """A profiler range named ``name`` that adds ``counters`` to
    ``counts()`` when it closes, while a profile is active; the shared null
    context otherwise. The caller evaluates ``counters`` either way: pass
    numbers it already holds or reads from shapes, never a tensor operation
    (a computed property such as ``RaySamples.positions`` launches
    kernels)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, counters)


@contextlib.contextmanager
def profile(log_dir: Path | str):
    """Profiles the block (host activity and, on a card, the device's) with
    the spans on, and writes ``trace.json`` (Chrome trace format, open it in
    Perfetto or ``chrome://tracing``) and ``counts.json`` (the counters'
    change over the block) into ``log_dir``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    before = counts()
    with torch_profile(activities=activities) as prof:
        yield prof
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(log_dir / "trace.json"))
    moved = {k: n - before.get(k, 0) for k, n in counts().items() if n != before.get(k, 0)}
    (log_dir / "counts.json").write_text(json.dumps(moved, indent=1, sort_keys=True) + "\n")
