"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--k4-against OTHER_CHECKOUT | --splat-repeatable-only [CHECKOUT] | --sparse-only |
                           --corner-only | --ensemble-train-only] [--corner-against OTHER_CHECKOUT]

Builds the port's hand-written CUDA kernels from ``uncertainty_nerf_gs_torch/
csrc`` with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, all started
together) and holds each against its plain PyTorch version on the card:
the PDF resampler (K1) on dense and ragged rays, on the render's rows
shared by every ray (stride 0), at one bin, one query, 4,096 bins and all
weights zero, bit for bit (both versions sum in float64 in K1's order),
timed beside its launch floor (an empty kernel with its grid); the tile
compositor's forward (K2) and backward (K3) on the full-width splat scene's
packed tiles, a saturated scene, a tile the saturation exit cuts short, a
tile with no rows, a one-channel payload, and hand-built tiles whose row
counts end ragged against K3's row groups and K2/K3's 128-row batches at 1,
5, 6 and 16 channels; K3 twice on the same full-width inputs, bit for bit;
and the hash-grid lookup (K4 forward, K5 backward) at the main path's three
shapes, a ragged count, F = 4 and F = 1, with K4 required equal to its
plain version bit for bit (also at the positions of real training forwards
and of a render's eval chunks, captured by forward hooks, where it is timed
too), K5 launched twice on every case and required bit for bit, its
hand-written sort held equal to ``torch.sort(stable=True)``, and K5 also run
and timed on the training forwards' positions. Then it drives both slices of the port
at full width with random weights from a seed: two 256x256 images and five
training steps of active-nerfacto through ``NerfactoTrainer``, and two
640x480 images and five training steps of active-splatfacto (65,536
Gaussian slots) through ``SplatfactoTrainer``, checks from the launch
counters that each went through its kernels, holds each against the same
work on the plain versions (inside ``backend.plain_versions()``, where no
kernel may launch: the forwards bit for bit, the training step's gradients
within a bar; the flipped rays are counted by field and the first
resampler's inputs replayed), requires two
nerfacto training steps from one restored state to be bit-identical, lists
what ``torch.use_deterministic_algorithms(True, warn_only=True)`` flags in
a step, and profiles one image and one step. Last, the deep ensemble at
full width (``bench.py::bench_ensemble_render``'s model, five members from
numpy seeds 0-4): the member-packed lookup (K6) bit for bit against its
plain version and against five K4 launches on the members' own tables (the
three fields' shapes, a ragged count, M = 1 and 3, F = 1 and 4, and every
launch of two real fused chunks), its strided entry bit for bit against
its plain version (the three fields' full-width shapes with the
proposals' strides and the field's at MAIN_STRIDE_SCALE, F = 1 and 4, and
every strided launch of real chunks, the field strided too), each timed
beside its bound and ``index_select`` of the same rows; the fused (K1 2, K6
3 a chunk, also with the field strided) and the per-member chunk on the
kernel path against the plain path bit for bit, with their launch plans;
five identical members against the single model; and both modes
through ``get_average_uncertainty_metrics`` over two images (finite
metrics, the JSON written), profiled and timed in turns. Then the joint
ensemble step (``run_ensemble_train``): five active-nerfacto members at the
method's width from ``init_ensemble_params``, trained by
``build_ensemble_train_step`` on a shared 4,096-ray batch (K1 10, K4 15, K5
15 a step): 2 eager steps, then 50 a launch as one captured CUDA graph,
beside a lone trainer's 50-step launch; the memory of an eager step and of
the capture against a lone trainer's plus the other members' weights,
gradients and moments;
members 0 and 4 of a step against lone single-member steps bit for bit; two
steps from one state bit for bit; 5 steps as one launch against 5 eager
steps bit for bit; the step profiled one at a time and at 50 a launch; one
256x256 image through ``build_ensemble_render`` chunk by chunk equal to
``ensemble_render``'s bit for bit; and the mesh forms on a one-rank mesh
through NCCL (a file rendezvous in a temporary directory): the train step,
the per-member render, the fused render and the splat bands, each bit for
bit equal to its unsharded form (a multi-card check needs a machine with
several cards). After the splat
phase come two more at the same width: active-splatfacto past warmup
(65,000 live Gaussians in 131,072 slots, the capacity tuner at start and
every 20 steps, the camera optimizer, refines at steps 20, 30, 60 and 70
and opacity resets at 40 and 80 in 80 steps; K2 and K3 on every step, each
refine's counts and time, the replaced slots' Adam moments zeroed, the
opacities' Adam count restarted, the first refine replayed on the CPU with
equal masks, K2 and K3 timed at the tuned capacity), and the splat deep
ensemble (five members from numpy seeds 0-4 with their own alive masks,
through ``build_ensemble_splat_render_cam`` at probed eval budgets: K2
five times an image, against the plain path, five identical members
against the single model, ``get_average_uncertainty_metrics`` over two
images). The splat phases also run the packed-row gather's backward
(``csrc/packed_rows.cu``): launched on every splat training step, twice and
bit for bit against its plain version at 384, at the tuned capacity and at
the splat ensemble's eval capacity, captured in a CUDA graph and replayed
on another step's inputs copied in place (another live count) bit for bit,
timed beside ``F.embedding``'s backward and its byte bound; two splat steps from one
restored snapshot are required bit-identical at 384 and after the first
and the last refine, and what ``use_deterministic_algorithms`` flags in a
splat step is listed. After active-nerfacto come its sister methods at full
width: one chunk in float32 and with bf16 MLPs (``mixed_precision``),
deviation and times printed; nerfacto-mcdropout (five steps, K1 2, K4 3,
K5 3 a step; a step repeated bit for bit; a chunk at 10 MC samples bit for
bit against the plain path with the same masks; an image at 10 samples
with K1 2 and K4 3 a chunk, timed and profiled beside a deterministic
one); nerfacto-laplace (``fit_laplace`` over 300 batches of 4,096 rays,
timed and profiled; its GGN and a chunk's render bit for bit against the
plain path; an image at 100 samples and density draws). Last comes the
CLI phase (``run_cli``), driven through the entry points a user calls: a
Blender tree written by the port's ``write_blender_dataset`` (8 + 4 views
at 256x256), full-width active-nerfacto trained by ``scripts.train.main``
(300 steps, a checkpoint every 100, 50 steps a launch as one captured CUDA
graph replayed), a run stopped at 200 and resumed with ``--load-dir``
whose last checkpoint must equal the straight run's bit for bit, 50 steps
at 50 a launch against 50 single steps from one snapshot (losses and
state bit for bit, the same K1/K4/K5 launches, each timed and profiled),
one step with gradient checkpointing against one without (gradients bit
for bit; the peak memory at 4,096 and 16,384 rays), then
``scripts.eval_uncertainty.main`` on the run, on a fused two-member
ensemble with a seed-1 run (K6), on nerfacto-mcdropout at 10 samples, on
nerfacto-laplace twice (the second from the GGN cache, the same metrics)
and on active-splatfacto (K2/K3 and the packed-row backward in its
training, ``--raster-capacity auto``), every metric finite. Last comes the
sparse phase (``run_sparse``), the sparse-view study through the same entry
points: a 100 + 4-view Blender tree at 256x256, full-width active-nerfacto
trained with ``--dataparser sparse-blender`` (12 views; the run's rebuilt
trainer has the hybrid layout and the face-consistency loss, which
``events.jsonl`` logs), 300 steps at 50 a launch and a seed-1 run of 100;
K4 and K5 at the hybrid shapes (per-level tables: the main field's 8
dense levels up to 153^3 cells beside 8 hashed, the proposals' 4 + 1 and
3 + 2), K4 bit for bit and its cell read back, K5 twice bit for bit and
within GRID_GRAD_TOL, at uniform positions and a sparse step's, timed
beside their bounds; a sparse step against its plain path (the face loss
among the losses), two steps from one state bit-identical, 50 steps as
one graph launch against 50 single steps, the step profiled and
``dense_corner_to_cell_rows`` timed on its own; then
``scripts.eval_uncertainty.main`` on the run and on the fused two-member
ensemble at bf16 (the default), f32 and int8 (K1 2, K6 3 a chunk),
``--table-fold 2`` and ``--table-split`` equal to the unfolded metrics
bit for bit, K6 on each dtype's per-level tables bit for bit against its
plain version and timed beside its bound, and for the record the 12-view
PSNR beside a run of the cell layout. Between the CLI and the sparse
phases come two more on the CLI phase's tree (``run_corner``,
``run_tools``; the tree is removed after them). The corner phase: the
corner (tcnn) layout's lookup, K7 (``hash_lookup_fwd``) bit for bit
against its plain version at the three fields' full-width corner shapes, a
ragged count, F = 1 and 4, at uniform and at training forwards' positions
and on tables whose entries hold their own slot; K8 (its deterministic
backward) twice bit for bit and within GRID_GRAD_TOL of autograd, also
at positions three quarters of which lie in one tiny cube, its
positions-only mode's g_pos equal to its own; K5's positions-only mode
(a kernel of its own) bit for bit against its full backward and
``cell_lookup_positions_vjp_reference``; K7, K8 and both positions-only modes timed
beside their bounds (K8 by CUDA events), K7 beside ``F.embedding_bag`` and
K8 beside ``index_put_(accumulate=True)`` of its pairs; full-width
active-nerfacto with ``--overrides '{"grid_layout": "corner"}'`` trained
by ``scripts.train.main`` (300 steps at 50 a launch: K1 2, K7 3, K8 3 a
step; a seed-1 run of 100), a step against its plain path, two steps from
one state, 50 steps as one graph launch against 50 single steps, the step
profiled; the two runs evaluated as an ensemble (per member: K1 2 and K7 3
a chunk a member) with ``--save-rendered-images`` (every PNG decodes) and
the run alone, its PSNR beside the cell-layout CLI run's. The tools
phase: ``scripts.render.main`` (orbit and interpolate; rgb, depth, rgb_std)
on a nerfacto and a splat run, every PNG frame equal to the render
function's u8 image, every GIF decoded by ``data/gif.py``;
``scripts.pose_gradient.main`` on a cell and a corner run (K5 / K8 in
their positions-only mode, one chunk's Jacobian against the plain path's,
on the corner run a finite difference at fixed sample distances);
``scripts.viewer`` served on a single run and a fused two-member ensemble,
every mode's PNG equal to ``render_pose``'s image; and
``scripts.train.main --viewer-port`` with frames requested through the
run, whose checkpoint equals a run without the viewer bit for bit. Exits
non-zero, with no result line, when there is no card, any phase fails or
a kernel of the path never launched. The last line of standard output is
a JSON object naming the device; the line before it the card's name and
power limit; before that a ``{"kernels": [...]}`` line with each kernel's
launches (the CLI, corner and tools phases' by run, a captured step's
times its replays; the sparse phase's hybrid K4/K5, each table dtype's K6,
and K5's and K8's positions-only modes as entries of their own), error,
times and bound, a ``{"corner": ..., "tools": ...}`` line, a ``{"cli":
...}`` line with each CLI run's wall time, rate and metrics, a
``{"sparse": ...}`` line with the sparse phase's, and an
``{"ensemble_train": ...}`` line with the joint step's times and memory.

``--k4-against OTHER_CHECKOUT`` also builds that checkout's ``uncertainty_
nerf_gs_torch/csrc/hash_grid.cu`` (for example the parent commit unpacked
with ``git archive``; it must have the same ``cell_lookup_fwd_f32`` and
``packed_cell_lookup_fwd_f32`` entry points), holds its K4 within TOL and
its K6 bit for bit against the plain versions and times them in turns with
this checkout's at every shape and position set K4 and K6 are timed at; a
checkout without K6's strided entry makes the strided lookup as its own
code did, a K6 launch a level and the lerp as PyTorch ops.

``--sparse-only`` runs only the sparse phase (``run_sparse``) and prints
its kernel entries; ``--corner-only`` the corner phase (``run_corner``) on
a tree of its own; ``--ensemble-train-only`` the joint ensemble step, its
render and the mesh forms (``run_ensemble_train``) and their launches.

``--corner-against OTHER_CHECKOUT`` also builds that checkout's
``hash_grid.cu`` and ``packed_rows.cu`` (the parent commit unpacked with
``git archive``, whose K7/K8 and K5 entry points take the same arguments),
holds its K7 bit for bit and its K8 within GRID_GRAD_TOL against the plain
versions, and times both in turns with this checkout's at the corner step's
training positions; its K5 positions-only mode and its packed-row backward
(either layout of that source's entry points) are held bit for bit and
timed in turns with this checkout's at the same inputs, by CUDA events and
the profiler.

``--splat-repeatable-only [CHECKOUT]`` runs only the splat repeatability
check in its three places, with CHECKOUT's package in place of this one
(for example the parent commit unpacked with ``git archive``), prints each
result without requiring it, and ends in a JSON line of the results.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
if len(sys.argv) == 3 and sys.argv[1] == "--splat-repeatable-only":
    # another checkout's package (the parent's, for example) in place of this one's
    sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
from torch_parity import (  # noqa: E402  (the tolerances the CPU tests hold)
    GRID_GRAD_TOL,
    MAX_FLIPPED_RAY_SHARE,
    TRAIN_GRAD_L2,
    OUTPUT_TOLS,
    PACKED_FAMILIES,
    SPLAT_FWD_ATOL,
    SPLAT_FWD_TOL,
    SPLAT_GRAD_TOL,
    SPLAT_OUTPUT_TOLS,
    TOL,
    composite_vjp_float64,
    grad_l2_error,
    grad_mismatch,
)

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
MIN_SET_BYTES = 100_000_000  # timed input sets pass twice the 50 MB L2
SENTINEL_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, args_list, reps: int = 20) -> float:
    """Mean time of ``fn(*args)`` back to back in ms by CUDA events, cycling
    over ``args_list``, after a warm-up."""
    for args in args_list:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*args_list[i % len(args_list)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_kernels(fn) -> tuple[dict[str, tuple[int, float]], float]:
    """Runs ``fn`` once under torch.profiler. Returns {kernel or copy name:
    (count, device us)} for the device activity it traced, and the wall
    seconds of the profiled run (the profiler's own cost included)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # a sentinel first: the profiler has been seen to drop a profiled
        # run's first device kernel; the sentinel is left out of the result
        torch.cuda._sleep(100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for e in prof.key_averages():
        if SENTINEL_KERNEL in e.key:
            continue
        # a user annotation (Optimizer.step#Adam.step) spans kernels counted
        # on their own
        if "CUDA" not in str(getattr(e, "device_type", "")) or getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            kernels[e.key] = (e.count, us)
    return kernels, wall


def kernel_times(name, kernel, plain, sets, symbol, kernels_per_call=1) -> dict:
    """A kernel's and its plain version's time per call over ``sets``: device
    time from the profiler where it traced the device, else CUDA events. The
    kernel's time is the sum of every device kernel whose name holds
    ``symbol`` (a pipeline of several kernels shares one prefix), per call;
    ``parts`` holds each of them, ``others`` what else the wrapper ran (a
    zero-fill) per call. The profiler has been seen to drop a profiled run's
    first device kernel (with two input sets, one of a kernel's two
    launches; ``device_kernels`` now runs a sentinel kernel first): where it
    traced fewer than ``kernels_per_call`` a call, the traced launches are
    scaled up to the calls made, and the count is printed."""
    event_ms = time_ms(kernel, sets)
    plain_event_ms = time_ms(plain, sets)
    traced, _ = device_kernels(lambda: [kernel(*a) for a in sets])
    own = {k: v for k, v in traced.items() if symbol in k}
    plain_traced, _ = device_kernels(lambda: [plain(*a) for a in sets])
    launched, expected = sum(c for c, _ in own.values()), kernels_per_call * len(sets)
    scale = expected / launched if launched else 1.0
    per_call = {k: 1e-3 * us / len(sets) for k, (_, us) in traced.items()}
    parts = {k: scale * v for k, v in per_call.items() if k in own}
    others = {k: v for k, v in per_call.items() if k not in own}
    if launched != expected:
        print(f"{name}: the profiler traced {launched} of the kernel's {expected} device kernels")
    if own and plain_traced:
        ms = sum(parts.values())
        plain_ms = 1e-3 * sum(us for _, us in plain_traced.values()) / len(sets)
        source = "profiler" if launched == expected else "profiler, scaled"
    else:
        print(f"{name}: the profiler traced no device time; times are CUDA events")
        ms, plain_ms, source = event_ms, plain_event_ms, "events"
    return dict(ms=ms, plain_ms=plain_ms, event_ms=event_ms, plain_event_ms=plain_event_ms,
                ms_from=source, parts=parts, others=others,
                kernel_launches=launched / len(sets))


def device_ms(fn, sets, symbol) -> float:
    """Device time per call of ``fn`` over ``sets``: the profiler's time of
    the kernels whose name holds ``symbol`` (every kernel it traced for
    ""), else CUDA events."""
    event_ms = time_ms(fn, sets)
    traced, _ = device_kernels(lambda: [fn(*a) for a in sets])
    own = [us for k, (_, us) in traced.items() if symbol in k]
    return 1e-3 * sum(own) / len(sets) if own else event_ms


def ptxas_summary(report: str, symbol: str) -> list[str]:
    """``ptxas -v``'s lines (registers, shared memory, stack and spills) for
    each instantiation of the kernels whose mangled name holds ``symbol``."""
    out, current = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1]
        elif "Function properties for" in line:
            current = line.rsplit(" ", 1)[-1].strip()
        elif current and symbol in current and any(
                k in line for k in ("registers", "stack frame", "spill")):
            out.append(f"{current}: {line.split('info    :')[-1].strip()}")
    return out


def kernel_name(key: str) -> str:
    """A device kernel's name without its namespace, return type and
    arguments: ``cell_lookup_bwd_scatter_kernel<false>``."""
    head = key.split("(unsigned", 1)[0].split("(float", 1)[0].split("(int", 1)[0]
    return head.replace("void ", "").replace("(anonymous namespace)::", "").strip()


def profile_top(label, fn, port_symbols, top=15) -> dict:
    """``fn`` once under torch.profiler: the device's busy and idle share,
    the kernels that take the most device time, and the port's own. Returns
    the traced kernels."""
    kernels, wall = device_kernels(fn)
    if not kernels:
        print(f"profile {label}: the profiler traced no device time; idle share not measured")
        return kernels
    busy = 1e-6 * sum(us for _, us in kernels.values())
    print(f"profile {label}: wall {1e3 * wall:.1f} ms under the profiler, device busy "
          f"{1e3 * busy:.1f} ms, idle share {1 - busy / wall:.3f}")
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    for name, (count, us) in ranked[:top]:
        print(f"  {1e-3 * us:9.3f} ms {us / (1e6 * busy):6.1%} x{count:<5d} {name[:110]}")
    for name, (count, us) in ranked:
        for label_, symbol in port_symbols.items():
            if symbol in name:
                print(f"  port kernel {label_}: {1e-3 * us:.3f} ms {us / (1e6 * busy):.1%} x{count} "
                      f"{kernel_name(name)}")
    return kernels


# -- K1: the PDF resampler against its plain version --------------------------


def resample_inputs(num_rays, num_bins, num_queries, gen, device, shared_u=False,
                    shared_edges=False, all_zero=False):
    """Weights rand**4 with two all-zero rows (every row with ``all_zero``),
    sorted random edges, and the eval path's queries u = clip((arange(N) +
    0.5) / N, 0, 1 - 1e-6). ``shared_u`` and ``shared_edges`` hand them over
    as the render does: one row expanded over every ray (stride 0)."""
    w = torch.rand(num_rays, num_bins, generator=gen, device=device) ** 4
    w[0] = 0.0
    w[num_rays // 2] = 0.0
    if all_zero:
        w.zero_()
    e = torch.sort(
        torch.rand(1 if shared_edges else num_rays, num_bins + 1, generator=gen, device=device),
        dim=1,
    ).values.expand(num_rays, num_bins + 1)
    u = (torch.arange(num_queries, dtype=torch.float32, device=device) + 0.5) / num_queries
    u = torch.clamp(u, 0.0, 1.0 - 1e-6).expand(num_rays, num_queries)
    return w, e, u if shared_u else u.contiguous()


def resample_bytes(num_rays, num_bins, num_queries, shared_u=False, shared_edges=False) -> int:
    """Bytes one call must move: each input read once (a shared row once),
    the output written once."""
    edge_rows = 1 if shared_edges else num_rays
    u_rows = 1 if shared_u else num_rays
    return 4 * (num_rays * num_bins + edge_rows * (num_bins + 1) + (u_rows + num_rays) * num_queries)


def resample_bound_ms(num_rays, num_bins, num_queries, **layout) -> tuple[float, str]:
    """Least time for one call and what sets it: its bytes against the
    float32 work (padding, normalising and scanning each bin; a binary search
    and the interpolation per query)."""
    nbytes = resample_bytes(num_rays, num_bins, num_queries, **layout)
    ops = num_rays * (4 * num_bins + num_queries * (np.log2(num_bins + 1) + 6))
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def floor_times(num_rays, num_bins, device, reps: int = 50) -> dict:
    """K1's launch floor: the empty kernel with K1's grid, block and shared
    memory, by the profiler's device time (and CUDA events back to back)."""
    from uncertainty_nerf_gs_torch.ops.pdf_resample import launch_floor

    event_ms = time_ms(launch_floor, [(num_rays, num_bins, device)], reps)
    traced, _ = device_kernels(lambda: [launch_floor(num_rays, num_bins, device)
                                        for _ in range(reps)])
    own = [v for k, v in traced.items() if "pdf_resample_floor" in k]
    ms = 1e-3 * own[0][1] / own[0][0] if own else event_ms
    return dict(ms=ms, event_ms=event_ms, ms_from="profiler" if own else "events")


# (name, rays, bins, queries, layout): the dense shapes of PR 1-3's checks,
# ragged R, the render's layouts (u shared at both stages, the first stage's
# edges shared too), one bin, one query, MAX_BINS, every row zero; two bins
# and 600 bins (several 256-bin tiles, a cdf padded past the last tile)
RESAMPLE_CASES = [
    ("dense", 4096, 256, 97, {}), ("dense", 4096, 96, 49, {}),
    ("dense", 4099, 256, 97, {}), ("dense", 4099, 96, 49, {}),
    ("shared_u", 4096, 96, 49, dict(shared_u=True)),
    ("shared_edges", 4096, 256, 97, dict(shared_edges=True)),
    ("render_stage1", 4096, 256, 97, dict(shared_u=True, shared_edges=True)),
    ("one_bin", 4096, 1, 49, {}), ("one_query", 4096, 96, 1, {}),
    ("max_bins", 7, 4096, 97, dict(shared_u=True)),
    ("all_zero", 4096, 96, 49, dict(all_zero=True)),
    ("two_bins", 4096, 2, 97, {}), ("tiles", 512, 600, 33, {}),
]
# the timed shapes: the dense ones compare with PR 1-3; the render's layouts
# are what the main path launches, stage 1 then stage 2 of a chunk
RESAMPLE_TIMED = [
    ("dense", (4096, 256, 97), {}), ("dense", (4096, 96, 49), {}),
    ("render", (4096, 256, 97), dict(shared_u=True, shared_edges=True)),
    ("render", (4096, 96, 49), dict(shared_u=True)),
]


def check_resampler(device) -> dict:
    from uncertainty_nerf_gs_torch.ops.pdf_resample import (
        resample_edges,
        resample_edges_reference,
    )

    worst, failed = 0.0, []
    for i, (name, *shape, layout) in enumerate(RESAMPLE_CASES):
        gen = torch.Generator(device=device).manual_seed(SEED + i)
        w, e, u = resample_inputs(*shape, gen, device, **layout)
        got = resample_edges(w, e, u)
        want = resample_edges_reference(w, e, u)
        # both float32 versions against the same arithmetic in float64
        exact = resample_edges_reference(w.double(), e.double(), u.double())
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        differ = int((got != want).sum())
        step = torch.diff(got, dim=1).min().item() if shape[2] > 1 else 0.0
        print(f"resample {name} {tuple(shape)} strides u {u.stride()} edges {e.stride()}: "
              f"max_abs_err {err:.3e}, {differ} of {got.numel()} edges not bit-identical (kernel "
              f"to float64 {(got - exact).abs().max().item():.3e}, plain to float64 "
              f"{(want - exact).abs().max().item():.3e}), least step {step:.3e}")
        if not (torch.isclose(got, want, **TOL).all() and torch.isfinite(got).all()):
            failed.append(f"{name} {tuple(shape)}: kernel disagrees, {err:.3e}")
        # the plain version sums in K1's order, and K1 contracts nothing to
        # an fma: the two give the same bits
        if differ:
            failed.append(f"{name} {tuple(shape)}: {differ} edges differ from the plain version's bits")
        if step < -1e-6:
            failed.append(f"{name} {tuple(shape)}: a row decreases by {step:.3e}")
        worst = max(worst, err)
    if failed:
        raise AssertionError("resample " + "; ".join(failed))

    per_launch = []
    for i, (name, shape, layout) in enumerate(RESAMPLE_TIMED):
        gen = torch.Generator(device=device).manual_seed(SEED + 100 + i)
        num_sets = -(-MIN_SET_BYTES // resample_bytes(*shape, **layout))
        sets = [resample_inputs(*shape, gen, device, **layout) for _ in range(num_sets)]
        times = kernel_times("resample", resample_edges, resample_edges_reference, sets,
                             "pdf_resample_kernel")
        floor = floor_times(shape[0], shape[1], device)
        bound, bound_by = resample_bound_ms(*shape, **layout)
        nbytes = resample_bytes(*shape, **layout)
        print(f"resample {name} {shape} {layout}: kernel {times['ms']:.4f} ms on the device "
              f"({times['event_ms']:.4f} ms a call back to back), plain {times['plain_ms']:.4f} ms "
              f"({times['plain_event_ms']:.4f}), bound {bound:.4f} ms ({bound_by}: "
              f"{nbytes / 1e6:.2f} MB), launch floor {floor['ms']:.4f} ms "
              f"({floor['event_ms']:.4f} back to back)")
        per_launch.append(dict(layout=name, shape=list(shape), bound_ms=bound, bound_by=bound_by,
                               bytes=nbytes, floor_ms=floor["ms"], floor_event_ms=floor["event_ms"],
                               **times))
    return dict(max_abs_err=worst, per_launch=per_launch)


# -- K2 / K3: the tile compositor against its plain versions -------------------

# float32 operations per composited row x pixel pair (csrc/composite_tiles.cu).
# Forward: the Gaussian and its exp, the gates and the blend. Backward, the
# least work of this VJP given the forward's outputs: the recomputed
# Gaussian with its exp and gates (16), 1 - alpha, w and T (4), g_w (2C + 1),
# the prefix (2), the gradient's gate (3), g_alpha (5), g_sigma (1), the six
# partials added into the row sums (24) and w g_img added likewise (2C)
FWD_OPS_PER_PAIR = lambda c: 22 + 2 * c  # noqa: E731
BWD_OPS_PER_PAIR = lambda c: 56 + 4 * c  # noqa: E731
# row counts of the ragged-end tiles: 1 row, one either side of K3's row
# groups (4 rows at 16 channels, else 8), and of the 128-row batches, K - 1, K
RAGGED_COUNTS = (1, 3, 5, 7, 9, 127, 128, 129, 383, 384)
RAGGED_CHANNELS = (1, 5, 6, 16)


def composite_bound_ms(rows: int, packed, backward: bool) -> tuple[float, str, int, float]:
    """Least time for one K2 (or K3) call on these inputs and what sets it:
    the bytes of the composited rows, pix, counts and outputs (K3 also reads
    the forward's outputs and their gradients and writes every row of
    g_packed) against the float32 operations of the composited row x pixel
    pairs. Returns (ms, "bytes" or "operations", bytes, operations)."""
    t, k, d = packed.shape
    c = d - 6
    nbytes = 4 * (rows * d + t * 256 * 2 + t)
    pairs = rows * 256
    if backward:
        nbytes += 4 * (2 * t * 256 * (c + 1) + t * k * d)
        ops = pairs * BWD_OPS_PER_PAIR(c)
    else:
        nbytes += 4 * t * 256 * (c + 1)
        ops = pairs * FWD_OPS_PER_PAIR(c)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations"), nbytes, ops


def saturated_case(device, gen):
    """The JAX package's saturation scene (tests/test_splat.py:471-483): 300
    near-opaque Gaussians on 32x32 at capacity 512, projected and packed by
    the port."""
    from uncertainty_nerf_gs_torch.ops.gaussians import project_gaussians
    from uncertainty_nerf_gs_torch.ops.rasterize import select_and_pack

    n = 300
    means = torch.stack([
        torch.rand(n, generator=gen, device=device) * 2 - 1,
        torch.rand(n, generator=gen, device=device) * 1.6 - 0.8,
        torch.rand(n, generator=gen, device=device) * 2.5 + 1.5,
    ], dim=-1)
    scales = 0.02 + 0.1 * torch.rand(n, 3, generator=gen, device=device)
    quats = torch.randn(n, 4, generator=gen, device=device)
    proj = project_gaussians(means, scales, quats, torch.eye(4, device=device),
                             50.0, 50.0, 16.0, 16.0, 32, 32)
    opac = (0.2 + 0.7 * torch.rand(n, generator=gen, device=device)) * proj.compensation
    opac = torch.clamp(opac * 20.0, max=0.995)
    payload = torch.rand(n, 5, generator=gen, device=device)
    sp = select_and_pack(proj, opac, payload, 32, 32, capacity=512)
    return sp.packed, sp.pix, sp.counts


def exit_case(device, gen, pix):
    """Two tiles at capacity 384: 300 wide, opaque rows over tile 0, so that
    the saturation exit skips its last 172; tile 1 empty."""
    packed = torch.zeros(2, 384, 12, device=device)
    packed[0, :300, :2] = 4.0 + 8.0 * torch.rand(300, 2, generator=gen, device=device)
    packed[0, :300, 2] = packed[0, :300, 4] = 1e-3
    packed[0, :300, 5] = 0.5 + 0.49 * torch.rand(300, generator=gen, device=device)
    packed[0, :300, 6:] = torch.rand(300, 6, generator=gen, device=device)
    return packed, pix[:2].contiguous(), torch.tensor([300, 0], dtype=torch.int32, device=device)


def ragged_case(device, gen, pix, c):
    """Tiles of capacity 384 whose counts are RAGGED_COUNTS, with c payload
    channels: faint (opacity 0.01-0.1), anisotropic Gaussians spread over
    and around each tile, so that every live row is composited."""
    t, k = len(RAGGED_COUNTS), 384
    origin = pix[:t, :1, :]  # the first pixel center of each tile
    packed = torch.zeros(t, k, 6 + c, device=device)
    u = lambda *shape: torch.rand(*shape, generator=gen, device=device)  # noqa: E731
    packed[:, :, :2] = origin + u(t, k, 2) * 24.0 - 4.0
    packed[:, :, 2] = 0.01 + 0.3 * u(t, k)
    packed[:, :, 4] = 0.01 + 0.3 * u(t, k)
    packed[:, :, 3] = (u(t, k) - 0.5) * torch.sqrt(packed[:, :, 2] * packed[:, :, 4])
    packed[:, :, 5] = 0.01 + 0.09 * u(t, k)
    packed[:, :, 6:] = u(t, k, c)
    counts = torch.tensor(RAGGED_COUNTS, dtype=torch.int32, device=device)
    packed[torch.arange(k, device=device)[None, :] >= counts[:, None].long()] = 0.0  # dead rows
    return packed, pix[:t].contiguous(), counts


def print_families(g, ref_g, exact=None) -> None:
    """Per column family of g_packed: its largest and median nonzero |g|,
    the absolute part of its bar, the kernel's error, both float32 versions'
    distance to float64 (where ``exact`` is given), the entries outside the
    bar and outside the elementwise bar, and the share of its nonzero
    entries on which a zeroed family would fail the bar."""
    for fam, cols in PACKED_FAMILIES.items():
        got, want = g[..., cols], ref_g[..., cols]
        mag = want.abs()
        nonzero = mag[mag > 0]
        top = mag.max().item()
        median = nonzero.median().item() if nonzero.numel() else 0.0
        outside = int(grad_mismatch(got, want).sum())
        elementwise = int((~torch.isclose(got, want, **SPLAT_GRAD_TOL)).sum())
        zeroed = grad_mismatch(torch.zeros_like(want), want)[mag > 0]
        caught = zeroed.float().mean().item() if zeroed.numel() else 0.0
        to64 = "" if exact is None else (
            f" (kernel to float64 {(got - exact[..., cols]).abs().max().item():.3e}, plain to float64 "
            f"{(want - exact[..., cols]).abs().max().item():.3e})")
        print(f"  {fam}: largest |g| {top:.3e}, median nonzero {median:.3e}, absolute bar "
              f"{SPLAT_GRAD_TOL['atol'] * top:.3e}; max_abs_err {(got - want).abs().max().item():.3e}"
              f"{to64}; {outside} outside the bar, {elementwise} outside it elementwise; a zeroed "
              f"family fails on {caught:.1%} of its nonzero entries")


def scene_tiles(trainer, gen):
    """The trainer's packed tiles of camera 0 at its rasterize budgets, as
    render_splat packs them, with random colours and uncertainties."""
    from uncertainty_nerf_gs_torch.models import splatfacto as sf
    from uncertainty_nerf_gs_torch.ops.rasterize import select_and_pack

    cfg = trainer.config
    params = {k: v.detach() for k, v in trainer.params.items()}
    w, h = trainer.cameras.width, trainer.cameras.height
    with torch.no_grad():
        proj = sf._project(params, trainer.splat_state.alive, *trainer.camera(0), w, h, cfg)
        opac = torch.sigmoid(params["opacities"]) * proj.compensation
        depth = proj.depths
        n = depth.shape[0]
        payload = torch.cat([torch.rand(n, 3, generator=gen, device=gen.device), depth[:, None],
                             depth[:, None] ** 2, 0.5 + torch.rand(n, 1, generator=gen, device=gen.device)], 1)
        return select_and_pack(proj, opac, payload, w, h, cfg.rasterize_capacity, cfg.rasterize_row_capacity)


def compare_composite(name, packed, pix, counts, gen, exact: bool = True) -> dict:
    """K2 and K3 against their plain versions on one set of packed tiles,
    with random output gradients; both backwards read their total from K2's
    outputs, as the main path's does. K2 within SPLAT_FWD_ATOL, K3 within
    SPLAT_GRAD_TOL of each column family's largest entry, everything
    finite: ``ok``. ``exact`` also prints each family's distance to the
    plain version in float64 (memory grows with tiles x capacity x 256, so
    the main path's large capacities leave it out)."""
    from uncertainty_nerf_gs_torch.ops import composite as tc

    t, _, d = packed.shape
    g_img = torch.randn(t, 256, d - 6, generator=gen, device=gen.device)
    g_alpha = torch.randn(t, 256, generator=gen, device=gen.device)
    img, alpha = tc.composite_fwd(packed, pix, counts)
    ref_img, ref_alpha = tc.composite_tiles_reference(packed, pix, counts)
    g = tc.composite_bwd(packed, pix, counts, img, alpha, g_img, g_alpha)
    ref_g = tc.composite_tiles_vjp_reference(packed, pix, counts, img, alpha, g_img, g_alpha)
    # the plain forward and backward in float64, to see which float32
    # version is the closer
    ex = composite_vjp_float64(packed, pix, counts, g_img, g_alpha) if exact else None
    rows = tc.executed_rows(packed, pix, counts)
    torch.cuda.synchronize()
    e_f = max((img - ref_img).abs().max().item(), (alpha - ref_alpha).abs().max().item())
    e_b = (g - ref_g).abs().max().item()
    bad = grad_mismatch(g, ref_g, families=PACKED_FAMILIES)
    print(f"composite {name} {tuple(packed.shape)}: fwd max_abs_err {e_f:.3e}; bwd max_abs_err "
          f"{e_b:.3e}, {int(bad.sum())} entries outside atol 1e-4 x the family's largest "
          f"|g| + rtol 1e-3; rows composited {int(rows.sum())} of {int(counts.sum())} live, "
          f"max alpha {alpha.max().item():.6f}")
    print_families(g, ref_g, ex)
    finite = all(bool(torch.isfinite(x).all()) for x in (img, alpha, g))
    return dict(ok=finite and e_f <= SPLAT_FWD_ATOL and not bad.any(), fwd_err=e_f, bwd_err=e_b,
                img=img, alpha=alpha, g=g, g_img=g_img, g_alpha=g_alpha, rows=rows)


def check_compositor(trainer, device) -> dict:
    """K2 and K3 against their plain versions on every case; times and
    bounds at full width (C = 6 and the indirection pass's C = 1)."""
    from uncertainty_nerf_gs_torch.ops import composite as tc

    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    # the full-width scene's packed tiles, camera 0
    cfg = trainer.config
    full = scene_tiles(trainer, gen)
    zero_packed, zero_counts = full.packed.clone(), full.counts.clone()
    zero_packed[0], zero_counts[0] = 0.0, 0
    cases = {
        "full_width": (full.packed, full.pix, full.counts),
        "full_width_c1": (full.packed[:, :, :7].contiguous(), full.pix, full.counts),
        "saturated": saturated_case(device, gen),
        "exit": exit_case(device, gen, full.pix),
        "zero_count": (zero_packed, full.pix, zero_counts),
    }
    for c in RAGGED_CHANNELS:
        cases[f"ragged_c{c}"] = ragged_case(device, gen, full.pix, c)
    fwd_err = bwd_err = 0.0
    failed = []
    for name, (packed, pix, counts) in cases.items():
        k = packed.shape[1]
        res = compare_composite(name, packed, pix, counts, gen)
        img, alpha, g, rows, e_f, e_b = (res[x] for x in ("img", "alpha", "g", "rows", "fwd_err", "bwd_err"))
        if not res["ok"]:
            failed.append(f"{name}: a kernel disagrees with its plain version")
        if name == "exit" and rows.tolist() != [128, 0]:
            failed.append(f"exit: rows {rows.tolist()}, expected [128, 0]")
        if name == "zero_count" and (img[0].abs().max() != 0 or g[0].abs().max() != 0):
            failed.append("zero_count: the empty tile is not zero")
        if name.startswith("ragged"):
            dead = torch.arange(k, device=device)[None, :] >= counts[:, None].long()
            if rows.tolist() != list(RAGGED_COUNTS) or g[dead].abs().max() != 0:
                failed.append(f"{name}: rows {rows.tolist()}, or a dead row has a gradient")
        if name == "full_width":
            # no atomics: a second launch gives the same bits
            again = tc.composite_bwd(packed, pix, counts, img, alpha, res["g_img"], res["g_alpha"])
            same = torch.equal(g, again)
            print(f"composite {name}: a second K3 launch is bit-identical: {same}")
            if not same:
                failed.append("full_width: two K3 launches on the same inputs differ")
        fwd_err, bwd_err = max(fwd_err, e_f), max(bwd_err, e_b)
    # K2 evaluates each Gaussian as the plain version does, so that both take
    # the same gate decisions: on one-row tiles w = alpha exactly, and K2's
    # alpha must equal the plain one bit for bit
    differ = evaluated = nonzero = 0
    for r in range(0, cfg.rasterize_capacity, 48):
        one = full.packed[:, r:r + 1].contiguous()
        live = (full.counts > r).to(torch.int32)
        _, a = tc.composite_fwd(one, full.pix, live)
        _, ref_a = tc.composite_tiles_reference(one, full.pix, live)
        differ += int((a != ref_a).sum())
        evaluated += int(live.sum()) * 256
        nonzero += int((ref_a > 0).sum())
    print(f"composite gates: K2's alpha of single rows differs from the plain version's in "
          f"{differ} of {evaluated} Gaussian evaluations ({nonzero} nonzero)")
    if differ:
        failed.append("gates: K2 evaluates a Gaussian otherwise than the plain version")
    if failed:
        raise AssertionError("composite " + "; ".join(failed))

    times = {name: composite_times(name, *cases[name], gen) for name in ("full_width", "full_width_c1")}
    return dict(fwd_err=fwd_err, bwd_err=bwd_err, times=times)


def composite_times(name, packed, pix, counts, gen, backward: bool = True) -> dict:
    """K2's (and with ``backward`` K3's) time per call against their plain
    versions and bounds, over input sets like these that pass
    MIN_SET_BYTES."""
    from uncertainty_nerf_gs_torch.ops import composite as tc

    t, k, d = packed.shape
    per_set = 4 * (packed.numel() * 2 + pix.numel() + t * 256 * (d - 5) * 4)
    sets = []
    for _ in range(-(-MIN_SET_BYTES // per_set)):
        p = packed.clone()
        p[:, :, 6:] += 1e-3 * torch.rand(p[:, :, 6:].shape, generator=gen, device=gen.device)
        pix_, counts_ = pix.clone(), counts.clone()
        sets.append((p, pix_, counts_, *tc.composite_fwd(p, pix_, counts_),
                     torch.randn(t, 256, d - 6, generator=gen, device=gen.device),
                     torch.randn(t, 256, generator=gen, device=gen.device)))
    rows = int(tc.executed_rows(packed, pix, counts).sum())
    fwd = kernel_times(f"{name} K2", tc.composite_fwd, tc.composite_tiles_reference,
                       [s[:3] for s in sets], "composite_fwd_kernel")
    out = dict(fwd=fwd)
    if backward:
        out.update(bwd=kernel_times(f"{name} K3", tc.composite_bwd, tc.composite_tiles_vjp_reference,
                                    sets, "composite_bwd_kernel"))
    for label, key in (("K2", "fwd"), ("K3", "bwd"))[:len(out)]:
        tm = out[key]
        bound, bound_by, nbytes, ops = composite_bound_ms(rows, packed, key == "bwd")
        tm.update(bound_ms=bound, bound_by=bound_by, bytes=nbytes, operations=ops,
                  shape=list(packed.shape), rows=rows)
        print(f"{label} {name} {tuple(packed.shape)}, {rows} rows composited: kernel "
              f"{tm['ms']:.4f} ms on the device ({tm['event_ms']:.4f} ms a call back to back), "
              f"plain {tm['plain_ms']:.4f} ms ({tm['plain_event_ms']:.4f}), bound {bound:.4f} ms "
              f"({bound_by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP)")
    return out


# -- K4 / K5: the hash-grid cell lookup against its plain versions -------------

# float32 operations per lookup (csrc/hash_grid.cu): scaled, frac, the axis
# weights and the 8 corner weights (25), then K4's 8 F multiply-adds; K5's
# 8 F scatter products and, with the position gradient, the 8 F-wide dots
# and the weight derivatives (3 x 8 x 3), times res
K4_OPS = lambda f: 25 + 16 * f  # noqa: E731
K5_KERNELS = 12  # device kernels a K5 call at the main path's shapes (3 sort passes)
K5_OPS = lambda f, pos: 25 + 8 * f + ((16 * f + 75) if pos else 0)  # noqa: E731


def grid_shapes(cfg) -> list[tuple]:
    """(field, levels, max_res, log2 table size, samples per ray) of the
    main path's three lookups: the proposals', then the main field's."""
    fields = [(f"proposal_{i}", a["num_levels"], a["max_res"], a["log2_hashmap_size"], n)
              for i, (a, n) in enumerate(zip(cfg.proposal_net_args, cfg.num_proposal_samples))]
    return fields + [("field", cfg.num_levels, cfg.max_res, cfg.log2_hashmap_size,
                      cfg.num_nerf_samples)]


def grid_inputs(levels, max_res, log2, n, gen, device, features=2):
    """Cells uniform in +-2 (interop.draw_params' scale), positions uniform
    in [0, 1]^3 whose first rows sit on the cube's corners, at 0 and 1, a
    little outside it, and on cell faces k / res of every level."""
    from uncertainty_nerf_gs_torch.ops.encodings import hash_grid_resolutions

    res = hash_grid_resolutions(levels, 16, max_res)
    table = 2**log2
    n_rows = -(-table // (128 // (8 * features)))
    cells = torch.rand(levels, n_rows, 128, generator=gen, device=device) * 4.0 - 2.0
    return cells, lookup_positions(res, n, gen, device), tuple(int(r) for r in res), table


def lookup_positions(res, n, gen, device) -> torch.Tensor:
    """(n, 3) positions uniform in [0, 1]^3 whose first rows sit on the
    cube's corners, at 0 and 1, a little outside it, and on cell faces k /
    res of every level of ``res``."""
    pos = torch.rand(n, 3, generator=gen, device=device)
    edge = [[0, 0, 0], [1, 1, 1], [1, 0, 1], [0.5, 1, 0], [-1e-7, 0.5, 1 + 1e-7], [1 + 1e-7, -1e-7, 0.3]]
    for r in res:
        k = torch.arange(int(r) + 1, device=device, dtype=torch.float32)
        faces = (k / float(r))[torch.randint(0, int(r) + 1, (3, 3), generator=gen, device=device)]
        edge += faces.tolist()
    edge = torch.tensor(edge, dtype=torch.float32, device=device)[:n]
    pos[: edge.shape[0]] = edge
    return pos


def encoded_cells(cells, features):
    """Cells whose corners all hold their own cell index k as (k % 1024,
    k // 1024, 0, ...), or as k at F = 1: a lookup's features then round to
    its cell."""
    levels, n_rows, _ = cells.shape
    k = torch.arange(n_rows * 128 // (8 * features), device=cells.device, dtype=torch.float32)
    code = torch.zeros(levels, k.shape[0], 8, features, device=cells.device)
    if features == 1:
        assert k.shape[0] <= 2**16, "k must round back exactly from one float"
        code[..., 0] = k[None, :, None]
    else:
        code[..., 0] = (k % 1024)[None, :, None]
        code[..., 1] = torch.div(k, 1024, rounding_mode="floor")[None, :, None]
    return code.reshape(cells.shape)


def decoded_cells(code) -> torch.Tensor:
    """(L, n) int64: the cell each lookup read, from K4's (n, L, F) output
    on ``encoded_cells``."""
    chosen = torch.round(code[..., 0])
    if code.shape[-1] > 1:
        chosen = chosen + 1024 * torch.round(code[..., 1])
    return chosen.long().t()


def grid_lookups(pos, res, table):
    """(L, n) int64: each lookup's cell, by the plain ``cell_indices``;
    ``table`` one size or a per-level list (the hybrid layout's)."""
    from uncertainty_nerf_gs_torch.ops.encodings import cell_indices

    sizes = table if isinstance(table, (list, tuple)) else [table] * len(res)
    return torch.stack([cell_indices(pos, r, t)[0] for r, t in zip(res, sizes)])


def level_mismatch(got, want, tol=GRID_GRAD_TOL) -> int:
    """Entries of a (L, ...) cell gradient outside ``tol`` relative to the
    largest entry of their own level."""
    return sum(int(grad_mismatch(g, w, tol).sum()) for g, w in zip(got, want))


def grid_bound_ms(n, levels, features, unique_cells, backward) -> tuple[float, str, int, int]:
    """Least time of one call on these inputs: positions read once, each
    cell that a lookup reads (K5: adds into) moved once, features (K5: their
    gradients) once; K5 also reads the touched cells and writes the
    positions' gradient. Returns (ms, bound_by, bytes, operations)."""
    lookups = n * levels
    cell_bytes = unique_cells * 8 * features * 4
    nbytes = 12 * n + cell_bytes + 4 * features * lookups
    ops = lookups * K4_OPS(features)
    if backward:
        nbytes += cell_bytes + 12 * n
        ops = lookups * K5_OPS(features, True)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations"), nbytes, ops


def k5_against_plain(cells, pos, res, table, f, g_out) -> dict:
    """K5 twice with the position gradient and once without, against the
    plain backward: the errors, the entries outside GRID_GRAD_TOL (a cell
    table level by level), and whether the three launches gave the same
    bits (the cell gradient with and without the position gradient too)."""
    from uncertainty_nerf_gs_torch.ops import encodings as enc

    g_cells, g_pos = enc.cell_lookup_bwd(cells, pos, res, table, f, g_out, True)
    again_cells, again_pos = enc.cell_lookup_bwd(cells, pos, res, table, f, g_out, True)
    g_only, none = enc.cell_lookup_bwd(cells, pos, res, table, f, g_out, False)
    ref_cells, ref_pos = enc.cell_lookup_vjp_reference(cells, pos, res, table, f, g_out)
    torch.cuda.synchronize()
    # level by level: a stacked gradient's levels, or per-level tables' own
    g, again, only, ref = (list(x) for x in (g_cells, again_cells, g_only, ref_cells))
    return dict(
        e_c=max((a - b).abs().max().item() for a, b in zip(g, ref)), e_p=(g_pos - ref_pos).abs().max().item(),
        top_c=max(b.abs().max().item() for b in ref), top_p=ref_pos.abs().max().item(),
        bad_c=level_mismatch(g, ref),
        bad_p=int(grad_mismatch(g_pos, ref_pos, GRID_GRAD_TOL).sum()),
        finite=bool(all(torch.isfinite(a).all() for a in g) and torch.isfinite(g_pos).all()),
        same=all(torch.equal(a, b) for a, b in zip(g, again)) and torch.equal(g_pos, again_pos),
        same_without_pos=none is None and all(torch.equal(a, b) for a, b in zip(only, g)),
    )


def check_sort(pos, res, table) -> dict:
    """K5's keys against ``cell_keys_reference``, and its hand-written
    stable sort against ``torch.sort(stable=True)`` of the same keys (the
    yardstick only; the port never calls it): keys, sorted keys and the
    permutation must be equal. Also the runs the reduction sees: distinct
    keys and the longest run."""
    from uncertainty_nerf_gs_torch.ops import encodings as enc

    keys, sorted_keys, perm = (t.long() for t in enc.cell_lookup_sort(pos, res, table))
    want = enc.cell_keys_reference(pos, res, table)
    ref = torch.sort(want, stable=True)
    _, runs = torch.unique_consecutive(ref.values, return_counts=True)
    return dict(keys_equal=torch.equal(keys, want), sorted_equal=torch.equal(sorted_keys, ref.values),
                perm_equal=torch.equal(perm, ref.indices), distinct=int(runs.numel()),
                longest_run=int(runs.max()), bits=enc.key_bits(len(res), table)[1])


def k5_yardsticks(cells, sets, res, table, f) -> dict:
    """PyTorch's own calls for parts of K5's work, timed as yardsticks (the
    port calls neither): ``torch.sort(stable=True)`` of K5's keys (int32),
    and ``index_put_(accumulate=True)`` (PyTorch's deterministic scatter) of
    each lookup's 8 F precomputed contributions into the cells. Both are
    partial: neither computes the keys, the weights or the position
    gradient."""
    from uncertainty_nerf_gs_torch.ops import encodings as enc

    levels = len(res)
    keys = [(enc.cell_keys_reference(p, res, table).to(torch.int32),) for p, _ in sets]
    sort_ms = time_ms(lambda k: torch.sort(k, stable=True), keys)
    per_level = cells.shape[1] * 128 // (8 * f)
    puts = []
    for p, g in sets:
        idx, contrib = [], []
        for lvl, r in enumerate(res):
            i, w = enc.cell_indices(p, r, table)
            idx.append(i + lvl * per_level)
            contrib.append(w[:, :, None] * g[:, lvl * f:(lvl + 1) * f][:, None, :])
        puts.append((torch.stack(idx, 1).reshape(-1), torch.stack(contrib, 1).reshape(-1, 8 * f)))
    target = torch.zeros_like(cells).view(-1, 8 * f)
    put_ms = time_ms(lambda i, c: target.index_put_((i,), c, accumulate=True), puts)
    return dict(sort_ms=sort_ms, index_put_ms=put_ms, levels=levels)


def capture_lookup_positions(trainer, steps: int = 2) -> list[list[torch.Tensor]]:
    """The positions each ``CellHashEncoding`` is queried at in ``steps``
    training forwards of NERF_RAYS rays (fresh batches and draws from the
    trainer's generator, no update), by a forward hook on each encoding:
    per forward, [proposal 0, proposal 1, field] as (n, 3). They cluster
    along the rays and around the surfaces the proposals find, as a real
    step's do."""
    from uncertainty_nerf_gs_torch.cameras.cameras import generate_rays
    from uncertainty_nerf_gs_torch.models.nerfacto import proposal_anneal_factor

    seen: list[torch.Tensor] = []
    hooks = [field.encoding.register_forward_hook(
        lambda mod, args, out: seen.append(args[0].detach().reshape(-1, 3).clone()))
        for field in trainer.model._fields()]
    sets = []
    try:
        for _ in range(steps):
            seen.clear()
            batch = trainer.sample_batch(NERF_RAYS)
            with torch.no_grad():
                rb = generate_rays(trainer.cameras, batch["camera_indices"], batch["pixel_x"],
                                   batch["pixel_y"], pose_adjustment=trainer.camera_opt)
                trainer.model(rb, train=True, generator=trainer._generator,
                              proposal_anneal=proposal_anneal_factor(trainer.step, trainer.config))
            sets.append(list(seen))
    finally:
        for h in hooks:
            h.remove()
    return sets


def capture_render_positions(trainer, idx: int = 1) -> list[list[torch.Tensor]]:
    """The positions each ``CellHashEncoding`` is queried at in two eval
    chunks of ``render_image(idx)`` (the middle chunk of the image and the
    next), by a forward hook on each encoding: per chunk, [proposal 0,
    proposal 1, field] as (n, 3)."""
    fields = trainer.model._fields()
    chunks = -(-trainer.cameras.height * trainer.cameras.width // trainer.config.eval_num_rays_per_chunk)
    keep = {chunks // 2, chunks // 2 + 1}
    calls, seen = [0], {}

    def hook(mod, args, out):
        chunk = calls[0] // len(fields)
        if chunk in keep:
            seen.setdefault(chunk, []).append(args[0].detach().reshape(-1, 3).clone())
        calls[0] += 1

    hooks = [field.encoding.register_forward_hook(hook) for field in fields]
    try:
        trainer.render_image(idx)
    finally:
        for h in hooks:
            h.remove()
    return [seen[c] for c in sorted(keep)]


# The float32 entry points of a checkout from before per-level tables (the
# parent of the change that gave K4, K5 and K6 per-level tables, and K6 bf16
# and int8 rows): one stacked table, one size.
_VP, _VI, _VL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
OTHER_ARGTYPES = {
    "cell_lookup_fwd_f32": [_VP, _VP, _VP, _VI, _VI, _VL, _VI, _VI, _VP, _VP],
    "packed_cell_lookup_fwd_f32": [_VP, _VP, _VP, _VI, _VI, _VI, _VI, _VI, _VP, _VP],
    "packed_cell_lookup_strided_fwd_f32": [_VP, _VP, _VP, _VP, _VI, _VI, _VI, _VI, _VI, _VI, _VP, _VP, _VP],
}


def other_k4(checkout):
    """Starts ``nvcc`` on another checkout's ``hash_grid.cu`` (for example
    the parent commit unpacked with ``git archive``) with the port's flags,
    into ``build/torch_kernels/``. Returns a function that waits for it,
    prints its K4's and K6's ``ptxas -v`` lines and returns that library's
    K4 and K6 calls, ``.k4(cells, positions, res, table, f)`` and
    ``.k6(packed, positions, res, table)`` (no launch counted), and
    ``.k6_strided(packed, positions, t_mid, res, table, strides)``: the
    strided lookup as that checkout's K6 makes it where it has no strided
    entry (a K6 launch a level, the lerp as PyTorch ops)."""
    import hashlib
    from types import SimpleNamespace

    from uncertainty_nerf_gs_torch.ops import backend
    from uncertainty_nerf_gs_torch.ops import encodings as enc

    src = Path(checkout).resolve() / "uncertainty_nerf_gs_torch" / "csrc" / "hash_grid.cu"
    backend.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = backend.BUILD_DIR / f"other_k4-{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so"
    proc = subprocess.Popen([backend._nvcc(), *backend.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
                             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        for label, symbol in (("K4", "cell_lookup_fwd_kernel"), ("K6", "packed_lookup_")):
            for line in ptxas_summary(log, symbol):
                print(f"other {label} ptxas: {line}")
        lib = ctypes.CDLL(str(out))
        k4, k6 = lib.cell_lookup_fwd_f32, lib.packed_cell_lookup_fwd_f32
        for fn, name in ((k4, "cell_lookup_fwd_f32"), (k6, "packed_cell_lookup_fwd_f32")):
            fn.argtypes, fn.restype = OTHER_ARGTYPES[name], ctypes.c_int
        strided = getattr(lib, "packed_cell_lookup_strided_fwd_f32", None)

        def run_k4(cells, pos, res, table, f):
            got = torch.empty((pos.shape[0], cells.shape[0] * f), dtype=torch.float32, device=cells.device)
            err = k4(pos.data_ptr(), cells.data_ptr(), got.data_ptr(), pos.shape[0], cells.shape[0],
                     cells.shape[1] * 128, table, f, (ctypes.c_int * len(res))(*res),
                     backend.current_stream_handle(cells.device))
            if err != 0:
                raise RuntimeError(f"the other K4's launch failed: CUDA error {err}")
            return got

        def run_k6(packed, pos, res, table, scales=None):
            if isinstance(packed, (list, tuple)):  # the plain strided version's one level
                packed, table = torch.stack(list(packed)), table[0]
            levels, _, _, m, f = packed.shape
            got = torch.empty((m, pos.shape[0], levels * f), dtype=torch.float32, device=packed.device)
            err = k6(pos.data_ptr(), packed.data_ptr(), got.data_ptr(), pos.shape[0], levels, table, m, f,
                     (ctypes.c_int * levels)(*res), backend.current_stream_handle(packed.device))
            if err != 0:
                raise RuntimeError(f"the other K6's launch failed: CUDA error {err}")
            return got

        def run_k6_strided(packed, pos, t_mid, res, table, strides):
            if strided is not None:
                strided.argtypes = OTHER_ARGTYPES["packed_cell_lookup_strided_fwd_f32"]
                levels, _, _, m, f = packed.shape
                got = torch.empty((m, *pos.shape[:2], levels * f), dtype=torch.float32, device=packed.device)
                err = strided(pos.data_ptr(), t_mid.data_ptr(), packed.data_ptr(), got.data_ptr(),
                              pos.shape[0], pos.shape[1], levels, table, m, f, (ctypes.c_int * levels)(*res),
                              (ctypes.c_int * levels)(*strides), backend.current_stream_handle(packed.device))
                if err != 0:
                    raise RuntimeError(f"the other strided K6's launch failed: CUDA error {err}")
                return got
            plain, enc.packed_cell_lookup_reference = enc.packed_cell_lookup_reference, run_k6
            try:
                return enc.packed_cell_lookup_strided_reference(packed, pos, t_mid, res, table, strides)
            finally:
                enc.packed_cell_lookup_reference = plain

        return SimpleNamespace(k4=run_k4, k6=run_k6, k6_strided=run_k6_strided)

    return finish


def k4_times(name, cells, sets, res, table, f, positions, other=None) -> dict:
    """K4 and its plain version per call over ``sets`` of (positions, g_out),
    beside the bound of the first set's distinct cells, the bound counting
    every lookup's cell, and ``index_select`` of the same rows (the
    yardstick; the port never calls it). With ``other`` (``other_k4``), that
    K4 is held within TOL of the plain version and timed in turns with this
    one, other, this, this, other (``turns_ms``)."""
    from uncertainty_nerf_gs_torch.ops import encodings as enc

    n, levels = sets[0][0].shape[0], len(res)
    tm = kernel_times(f"{name} K4 {positions}", lambda p, g: enc.cell_lookup_fwd(cells, p, res, table, f),
                      lambda p, g: enc.cell_lookup_reference(cells, p, res, table, f), sets,
                      "cell_lookup_fwd_kernel")
    blocks = [t.reshape(-1, 8, f) for t in cells]  # the levels of a stacked table, or per-level tables
    lib_sets = [[grid_lookups(p, res, table)] for p, _ in sets]
    library_ms = time_ms(lambda ix: [blocks[l].index_select(0, ix[l]) for l in range(levels)], lib_sets)
    uniq = sum(int(torch.unique(row).numel()) for row in lib_sets[0][0])
    bound, bound_by, nbytes, ops = grid_bound_ms(n, levels, f, uniq, False)
    every, _, every_bytes, _ = grid_bound_ms(n, levels, f, n * levels, False)
    tm.update(field=name, positions=positions, shape=[n, levels, f, table], bound_ms=bound,
              bound_by=bound_by, bytes=nbytes, operations=ops, unique_cells=uniq,
              every_lookup_bound_ms=every, library_ms=library_ms)
    print(f"K4 {name} ({n} samples x {levels} levels, {positions} positions): kernel "
          f"{tm['ms']:.4f} ms on the device ({tm['event_ms']:.4f} ms a call back to back), "
          f"plain {tm['plain_ms']:.4f} ms ({tm['plain_event_ms']:.4f}), bound {bound:.4f} ms "
          f"({bound_by}: {nbytes / 1e6:.1f} MB, {uniq} distinct cells of {n * levels} lookups; "
          f"{every:.4f} ms, {every_bytes / 1e6:.1f} MB counting every lookup's cell); "
          f"index_select of the same rows, {levels} calls, {library_ms:.4f} ms")
    if other is not None:
        for p, _ in sets:
            want = enc.cell_lookup_reference(cells, p, res, table, f)
            if not torch.isclose(other.k4(cells, p, res, table, f), want, **TOL).all():
                raise AssertionError(f"{name} {positions}: the other K4 disagrees with the plain version")
        runs = dict(other=lambda p, g: other.k4(cells, p, res, table, f),
                    this=lambda p, g: enc.cell_lookup_fwd(cells, p, res, table, f))
        tm["turns_ms"] = turns = dict(other=[], this=[])
        for version in ("other", "this", "this", "other"):
            turns[version].append(device_ms(runs[version], sets, "cell_lookup_fwd_kernel"))
        print(f"K4 {name} {positions} positions in turns: " + ", ".join(
            f"{v} {' / '.join(f'{t:.4f}' for t in ts)} ms" for v, ts in turns.items()))
    return tm


def check_hash_grid(cfg, device, clustered, rendered, other=None) -> dict:
    """K4 and K5 against their plain versions at the main path's three
    shapes (4,096 rays), a ragged count, F = 4 and F = 1: K4's features equal
    to the plain version's bit for bit, its cell choice too (from cells that
    encode their own index); K5's cell gradient within GRID_GRAD_TOL of each
    level's largest entry, its position gradient within GRID_GRAD_TOL of its
    largest entry, and a second K5 launch bit for bit. At the three
    full-width shapes also K5's sort against torch.sort(stable=True), K4 bit
    for bit and K5 on ``clustered`` (the positions of real training
    forwards, ``capture_lookup_positions``), and K4 bit for bit on
    ``rendered`` (an image's eval chunks, ``capture_render_positions``).
    Times per launch at the main path's shapes: K4 on uniform, training and
    render positions, K5 on uniform and training positions, beside the
    bound, index_select of the same rows (K4) and K5's two partial
    yardsticks; with ``other`` (``other_k4``), that K4 in turns with this
    one at every position set."""
    from uncertainty_nerf_gs_torch.ops import encodings as enc

    rays = cfg.eval_num_rays_per_chunk
    cases = [(name, levels, max_res, log2, rays * spr, 2, True)
             for name, levels, max_res, log2, spr in grid_shapes(cfg)]
    cases += [("ragged", cfg.num_levels, cfg.max_res, cfg.log2_hashmap_size, 1001, 2, False),
              ("f4", 4, 512, 12, 777, 4, False), ("f1", 4, 512, 12, 777, 1, False)]
    fwd_err = bwd_err = 0.0
    failed, per_launch = [], []
    for i, (name, levels, max_res, log2, n, f, timed) in enumerate(cases):
        gen = torch.Generator(device=device).manual_seed(SEED + 200 + i)
        cells, pos, res, table = grid_inputs(levels, max_res, log2, n, gen, device, f)
        got = enc.cell_lookup_fwd(cells, pos, res, table, f)
        want = enc.cell_lookup_reference(cells, pos, res, table, f)
        idx = grid_lookups(pos, res, table)
        code = enc.cell_lookup_fwd(encoded_cells(cells, f), pos, res, table, f).reshape(n, levels, f)
        chosen = decoded_cells(code)
        g_out = torch.randn(n, levels * f, generator=gen, device=device)
        k5 = k5_against_plain(cells, pos, res, table, f, g_out)
        e_f = (got - want).abs().max().item()
        differ = int((got != want).sum())
        flips = int((chosen != idx).sum())
        print(f"hash_grid {name} n={n} L={levels} F={f} table 2^{log2}: K4 max_abs_err {e_f:.3e}, "
              f"{differ} of {got.numel()} features not bit-identical to the plain version's, "
              f"{flips} of {idx.numel()} cell choices differ; K5 cells max_abs_err {k5['e_c']:.3e} "
              f"(largest |g| {k5['top_c']:.3e}, {k5['bad_c']} outside the level bar), "
              f"positions max_abs_err {k5['e_p']:.3e} (largest |g| {k5['top_p']:.3e}, "
              f"{k5['bad_p']} outside); a second K5 launch bit-identical: {k5['same']}, "
              f"without the position gradient: {k5['same_without_pos']}")
        # K4 sums the corners in the plain version's tree and contracts
        # nothing to an fma: the two give the same bits
        if differ or not torch.isfinite(got).all():
            failed.append(f"{name}: {differ} K4 features differ from the plain version's bits")
        if flips:
            failed.append(f"{name}: K4 chose another cell in {flips} lookups")
        if k5["bad_c"] or k5["bad_p"] or not k5["finite"]:
            failed.append(f"{name}: K5 disagrees with the plain backward")
        if not (k5["same"] and k5["same_without_pos"]):
            failed.append(f"{name}: two K5 launches on the same inputs differ")
        fwd_err, bwd_err = max(fwd_err, e_f), max(bwd_err, k5["e_c"], k5["e_p"])
        if not timed:
            continue
        sort = check_sort(pos, res, table)
        print(f"hash_grid {name}: K5's keys equal cell_keys_reference: {sort['keys_equal']}; its sort "
              f"equals torch.sort(stable=True): keys {sort['sorted_equal']}, permutation "
              f"{sort['perm_equal']} ({sort['bits']}-bit keys, {sort['distinct']} distinct cells, "
              f"longest run {sort['longest_run']})")
        if not (sort["keys_equal"] and sort["sorted_equal"] and sort["perm_equal"]):
            failed.append(f"{name}: K5's keys or sort differ from the reference")
        # the positions of real training forwards, g_out from the generator
        c_sets = [(c[i], torch.randn(c[i].shape[0], levels * f, generator=gen, device=device))
                  for c in clustered]
        c_k5 = k5_against_plain(cells, c_sets[0][0], res, table, f, c_sets[0][1])
        c_sort = check_sort(c_sets[0][0], res, table)
        print(f"hash_grid {name} clustered (a training forward's positions): K5 cells max_abs_err "
              f"{c_k5['e_c']:.3e} ({c_k5['bad_c']} outside), positions {c_k5['e_p']:.3e} "
              f"({c_k5['bad_p']} outside); bit-identical {c_k5['same']}; sort equal "
              f"{c_sort['sorted_equal'] and c_sort['perm_equal']} ({c_sort['distinct']} distinct "
              f"cells, longest run {c_sort['longest_run']})")
        if c_k5["bad_c"] or c_k5["bad_p"] or not (c_k5["finite"] and c_k5["same"]):
            failed.append(f"{name} clustered: K5 disagrees with the plain backward or itself")
        if not (c_sort["keys_equal"] and c_sort["sorted_equal"] and c_sort["perm_equal"]):
            failed.append(f"{name} clustered: K5's keys or sort differ from the reference")
        bwd_err = max(bwd_err, c_k5["e_c"], c_k5["e_p"])
        # the positions the main path feeds K4: a training forward's and a
        # render chunk's
        r_sets = [(r[i], torch.randn(r[i].shape[0], levels * f, generator=gen, device=device))
                  for r in rendered]
        for label, ss in (("training", c_sets), ("render", r_sets)):
            for p, _ in ss:
                k4, plain = enc.cell_lookup_fwd(cells, p, res, table, f), enc.cell_lookup_reference(
                    cells, p, res, table, f)
                same = torch.equal(k4, plain)
                print(f"hash_grid {name} {label} positions ({p.shape[0]} samples): K4 bit-identical "
                      f"to the plain version: {same} ({int((k4 != plain).sum())} features differ)")
                if not same:
                    failed.append(f"{name} {label}: K4 differs from the plain version's bits")
        # timed at the main path's shape, two input sets of positions and
        # g_out over the same cells, as consecutive steps would see them
        sets = [(pos, g_out)] + [(torch.rand(n, 3, generator=gen, device=device),
                                 torch.randn(n, levels * f, generator=gen, device=device))]
        fwd = k4_times(name, cells, sets, res, table, f, "uniform", other)
        fwd_training = k4_times(name, cells, c_sets, res, table, f, "training", other)
        fwd_render = k4_times(name, cells, r_sets, res, table, f, "render", other)
        bwd, c_bwd = (kernel_times(
            f"{name} K5", lambda p, g: enc.cell_lookup_bwd(cells, p, res, table, f, g, True),
            lambda p, g: enc.cell_lookup_vjp_reference(cells, p, res, table, f, g), ss,
            "cell_lookup_bwd_", K5_KERNELS) for ss in (sets, c_sets))
        yard, c_yard = k5_yardsticks(cells, sets, res, table, f), k5_yardsticks(cells, c_sets, res, table, f)
        unique = sum(int(torch.unique(row).numel()) for row in idx)
        c_unique = sum(int(torch.unique(row).numel()) for row in grid_lookups(c_sets[0][0], res, table))
        for tm, uniq, positions, y in ((bwd, unique, "uniform", yard), (c_bwd, c_unique, "clustered", c_yard)):
            bound, bound_by, nbytes, ops = grid_bound_ms(n, levels, f, uniq, True)
            every, _, every_bytes, _ = grid_bound_ms(n, levels, f, n * levels, True)
            tm.update(field=name, positions=positions, shape=[n, levels, f, 2**log2], bound_ms=bound,
                      bound_by=bound_by, bytes=nbytes, operations=ops, unique_cells=uniq,
                      every_lookup_bound_ms=every, library_ms=None, yardsticks=y)
            print(f"K5 {name} ({n} samples x {levels} levels, {positions} positions): kernel "
                  f"{tm['ms']:.4f} ms on the device ({tm['event_ms']:.4f} ms a call back to back), "
                  f"plain {tm['plain_ms']:.4f} ms ({tm['plain_event_ms']:.4f}), bound {bound:.4f} ms "
                  f"({bound_by}: {nbytes / 1e6:.1f} MB, {uniq} distinct cells of {n * levels} "
                  f"lookups; {every:.4f} ms, {every_bytes / 1e6:.1f} MB counting every lookup's cell)")
            print(f"  K5 {name} {positions}: {tm['kernel_launches']:.0f} kernels a call; " + ", ".join(
                f"{kernel_name(k)} {v:.4f} ms" for k, v in tm["parts"].items()))
            print(f"  K5 {name} {positions}: zero-fill of g_cells and the wrapper's other "
                  f"device work {sum(tm['others'].values()):.4f} ms a call (" + ", ".join(
                      f"{k[:60]} {v:.4f} ms" for k, v in tm["others"].items()) + ")")
            print(f"  K5 {name} {positions} yardsticks (partial, not called by the port): "
                  f"torch.sort(stable=True) of the keys {y['sort_ms']:.4f} ms, "
                  f"index_put_(accumulate=True) of the precomputed contributions "
                  f"{y['index_put_ms']:.4f} ms")
        per_launch.append(dict(fwd=fwd, fwd_training=fwd_training, fwd_render=fwd_render,
                               bwd=bwd, bwd_clustered=c_bwd))
    if failed:
        raise AssertionError("hash_grid " + "; ".join(failed))
    for key in ("fwd", "fwd_training", "fwd_render"):
        chunk = [p[key] for p in per_launch]
        turns = "".join(f", {v} {sum(min(c['turns_ms'][v]) for c in chunk):.4f}-"
                        f"{sum(max(c['turns_ms'][v]) for c in chunk):.4f} ms in turns"
                        for v in ("other", "this") if other is not None)
        print(f"a chunk's three K4 calls, {chunk[0]['positions']} positions: "
              f"{sum(c['ms'] for c in chunk):.4f} ms{turns}; bound {sum(c['bound_ms'] for c in chunk):.4f} ms")
    return dict(fwd_err=fwd_err, bwd_err=bwd_err, per_launch=per_launch)


# -- active-nerfacto at full width ---------------------------------------------


def build_nerfacto(device=None, num_cameras=4, size=256, **overrides):
    """Full-width active-nerfacto as the method ships it (camera optimizer
    on), random weights and training images drawn from a numpy seed, the
    weights through ``interop.params_from_jax``. ``overrides`` replace
    config fields (another method of the family)."""
    from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras
    from uncertainty_nerf_gs_torch.engine.trainer import NerfactoTrainer
    from uncertainty_nerf_gs_torch.interop import (
        draw_params,
        params_from_jax,
        params_to_jax,
    )
    from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig

    cams = hemisphere_cameras(num_cameras, size, size)
    cfg = NerfactoConfig(**{**dict(uncertainty_channels=1, num_images=num_cameras, background_color="white"),
                            **overrides})
    rng = np.random.default_rng(SEED)
    images = rng.uniform(size=(num_cameras, size, size, 3)).astype(np.float32)
    trainer = NerfactoTrainer(cfg, cams, images, seed=SEED, use_camera_optimizer=True,
                              device=device)
    tree = params_to_jax(trainer.model.state_dict())
    params = params_from_jax(draw_params(tree, rng))
    params["camera_opt"] = torch.zeros(num_cameras, 6)
    trainer.restore({"params": params})
    return trainer


def render_nerfacto(trainer, num_images: int = 2) -> dict:
    from uncertainty_nerf_gs_torch.ops import backend

    h, w = trainer.cameras.height, trainer.cameras.width
    chunk = trainer.config.eval_num_rays_per_chunk
    chunks = -(-h * w // chunk)
    backend.reset_launch_counts()
    times = []
    for idx in range(num_images):
        t0 = time.perf_counter()
        images = trainer.render_image(idx)  # ends in a copy to the host
        times.append(time.perf_counter() - t0)
        for k, v in images.items():
            want = (h, w, 3) if k == "rgb" else (h, w)
            if v.shape != want or not np.isfinite(v).all():
                raise AssertionError(f"image {idx}: {k} {v.shape} or not finite")
    launches = dict(backend.launch_counts)
    # per chunk: two resampler launches and one lookup per field
    want = dict(pdf_resample=2 * chunks * num_images, cell_lookup_fwd=3 * chunks * num_images)
    print(f"nerfacto launches {launches}, expected {want}")
    if any(launches[k] != v for k, v in want.items()) or launches["cell_lookup_bwd"]:
        raise AssertionError("the render did not go through its kernels")
    return dict(launches=launches, seconds=times, chunks=chunks, rays=h * w)


def bits_differ(a: dict, b: dict) -> dict[str, int]:
    """Per output of two forwards, the entries whose bits differ (a list of
    tensors counted over its items)."""
    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    out = {}
    for k, v in a.items():
        xs, ys = (v, b[k]) if isinstance(v, list) else ([v], [b[k]])
        out[k] = sum(int((bits(x) != bits(y)).sum()) for x, y in zip(xs, ys))
    return out


def check_nerfacto_plain_chunk(trainer) -> dict:
    """One chunk again on the plain path (``backend.plain_versions()``, no K1
    or K4 launch): every output bit for bit the kernel path's, since K1 and
    K4 equal their plain versions. Prints the rays that flipped a cell and,
    where outputs differ, the rays outside the CPU tests' tolerances."""
    from uncertainty_nerf_gs_torch.cameras.cameras import generate_rays, pixel_grid

    from uncertainty_nerf_gs_torch.ops import backend

    dev = trainer.device
    chunk = trainer.config.eval_num_rays_per_chunk
    px, py = pixel_grid(trainer.cameras.height, trainer.cameras.width, dev)
    idx = torch.zeros(chunk, dtype=torch.int64, device=dev)
    rb = generate_rays(trainer.cameras, idx, px[:chunk], py[:chunk])
    model = trainer.model
    kern = model(rb, return_intermediates=True)
    backend.reset_launch_counts()
    with backend.plain_versions():
        plain = model(rb, return_intermediates=True)
    if any(backend.launch_counts.values()):
        raise AssertionError(f"kernels launched inside plain_versions(): {backend.launch_counts}")
    # the first resampler call sees identical inputs on both paths
    edge_err = (kern["sdist_list"][1] - plain["sdist_list"][1]).abs().max().item()
    flipped = (
        model.lookup_cells(rb, kern["sdist_list"]) != model.lookup_cells(rb, plain["sdist_list"])
    ).any(dim=1)
    n_flip = int(flipped.sum())
    differ = bits_differ(kern, plain)
    inexact = sum(differ.values())
    print(f"nerfacto plain chunk: first-stage edges max_abs_err {edge_err:.3e}; "
          f"{n_flip} of {chunk} rays flipped a cell; {inexact} output entries not bit-identical")
    if inexact:
        bad = torch.zeros_like(flipped)
        for k, tol in OUTPUT_TOLS.items():
            bad |= (~torch.isclose(kern[k], plain[k], **tol)).reshape(chunk, -1).any(dim=1)
        print("  outputs that differ: " + ", ".join(f"{k} {v}" for k, v in differ.items() if v)
              + f"; {int((bad & ~flipped).sum())} rays that kept their cells outside OUTPUT_TOLS")
        raise AssertionError("the kernel path and the plain path disagree")
    return dict(edge_err=edge_err, flipped=n_flip, inexact=inexact)


def gather_bytes(trainer) -> int:
    """Bytes of hash-grid cells one image's lookups read: one (8, F) float32
    block per sample, level and field."""
    cfg, model = trainer.config, trainer.model
    samples = list(cfg.num_proposal_samples) + [cfg.num_nerf_samples]
    rays = trainer.cameras.height * trainer.cameras.width
    total = 0
    for field, n in zip(model._fields(), samples):
        enc = field.encoding
        total += rays * n * len(enc.resolutions) * 8 * enc.features_per_level * 4
    return total


NERF_SYMBOLS = {"pdf_resample": "pdf_resample_kernel", "cell_lookup_fwd": "cell_lookup_fwd_kernel",
                "cell_lookup_bwd": "cell_lookup_bwd_"}  # K5 is a pipeline of kernels


def profile_nerfacto(trainer, idx: int = 1) -> dict:
    """One image under the profiler: the top kernels, K1 and K4, the
    lookups' rate, any index_select gathers left, and the launches of every
    kernel and of the copy kernels."""
    kernels = profile_top(f"nerfacto image {idx}", lambda: trainer.render_image(idx), NERF_SYMBOLS)
    gb = gather_bytes(trainer)
    for name, (count, us) in kernels.items():
        if "cell_lookup_fwd_kernel" in name:
            print(f"  K4: {count} launches, {1e-3 * us:.3f} ms; the lookups read {gb / 1e6:.1f} MB "
                  f"of cells counting every lookup's cell, {gb / (us * 1e-6) / 1e12:.3f} TB/s")
        if "vectorized_gather" in name:  # index_select / gather; the cells no longer
            print(f"  {name[:40]}: {count} launches, {1e-3 * us:.3f} ms")
    # device copies between tensors (.contiguous() of a strided view); the
    # image's Memcpy to the host is not one
    copies = {k: v for k, v in kernels.items() if "copy" in k.lower() and "memcpy" not in k.lower()}
    counts = dict(
        launches=sum(c for c, _ in kernels.values()),
        copy_launches=sum(c for c, _ in copies.values()),
        copy_ms=1e-3 * sum(us for _, us in copies.values()),
    )
    print(f"  nerfacto image {idx}: {counts['launches']} device activities, of them "
          f"{counts['copy_launches']} copy kernels taking {counts['copy_ms']:.3f} ms")
    for name, (count, us) in sorted(copies.items(), key=lambda kv: -kv[1][0]):
        print(f"    x{count:<5d} {1e-3 * us:8.3f} ms {name[:110]}")
    return counts


NERF_STEPS, NERF_RAYS = 5, 4096


def train_nerfacto(trainer, name) -> dict:
    """Five training steps of 4,096 rays with the camera optimizer: every
    loss and weight finite, every group moved, and per step two K1, three
    K4 and three K5 launches."""
    from uncertainty_nerf_gs_torch.ops import backend

    start = {k: v.detach().clone() for k, v in trainer.params().items()}
    backend.reset_launch_counts()
    step_s, losses = [], []
    for _ in range(NERF_STEPS):
        t0 = time.perf_counter()
        losses.append(trainer.train_step(NERF_RAYS))  # ends in a copy of the losses to the host
        step_s.append(time.perf_counter() - t0)
    launches = dict(backend.launch_counts)
    want = dict(pdf_resample=2 * NERF_STEPS, cell_lookup_fwd=3 * NERF_STEPS,
                cell_lookup_bwd=3 * NERF_STEPS)
    print(f"nerfacto train launches {launches}, expected {want}")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError("the training step did not go through its kernels")
    for i, l in enumerate(losses):
        if not all(np.isfinite(v) for v in l.values()):
            raise AssertionError(f"nerfacto step {i}: loss not finite {l}")
    moved = {}
    for k, v in trainer.params().items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"{k} not finite after the steps")
        moved[k] = not torch.equal(v.detach(), start[k])
    if not all(moved.values()):
        raise AssertionError(f"not moved in {NERF_STEPS} steps: {[k for k, m in moved.items() if not m]}")
    for i, (s_, l) in enumerate(zip(step_s, losses)):
        print(f"nerfacto step {i}: {1e3 * s_:.1f} ms/step on {name}, " + ", ".join(
            f"{k} {v:.5f}" for k, v in l.items()))
    return dict(launches=launches, step_s=step_s, losses=losses)


def nerfacto_step(trainer, batch, draws, plain: bool) -> tuple[dict, dict, torch.Tensor, dict]:
    """One step's loss terms, gradients, per-ray cells and forward outputs at the trainer's
    state, without an update, as ``NerfactoTrainer._loss_fn`` computes
    them (the face-consistency loss on ``draws["face_vertices"]`` where the
    config has it). With ``plain`` the forward runs inside ``backend.plain_versions()``
    and autograd runs the backward after the block has closed: it follows
    the forward's path."""
    from uncertainty_nerf_gs_torch.cameras.cameras import generate_rays
    from uncertainty_nerf_gs_torch.engine.trainer import encoding_face_loss
    from uncertainty_nerf_gs_torch.models.nerfacto import nerfacto_loss, proposal_anneal_factor
    from uncertainty_nerf_gs_torch.ops import backend

    params = trainer.params()
    for p in params.values():
        p.grad = None
    with backend.plain_versions() if plain else contextlib.nullcontext():
        rb = generate_rays(trainer.cameras, batch["camera_indices"], batch["pixel_x"],
                           batch["pixel_y"], pose_adjustment=trainer.camera_opt)
        out = trainer.model(rb, train=True, draws=draws,
                            proposal_anneal=proposal_anneal_factor(trainer.step, trainer.config))
        total, losses = nerfacto_loss(out, batch, trainer.config)
        if trainer.config.face_consistency_mult > 0.0:
            fc = trainer.config.face_consistency_mult * encoding_face_loss(trainer.model, draws["face_vertices"])
            losses["face_consistency_loss"] = fc
            total = total + fc
    total.backward()
    grads = {k: p.grad.detach().clone() for k, p in params.items()}
    for p in params.values():
        p.grad = None
    losses["total_loss"] = total
    out = {k: [e.detach() for e in v] if isinstance(v, list) else v.detach() for k, v in out.items()}
    cells = trainer.model.lookup_cells(rb, out["sdist_list"])
    return {k: float(v.detach()) for k, v in losses.items()}, grads, cells, out


@contextlib.contextmanager
def record_resampler():
    """Records the (weights, s_edges, u) that ``sample_pdf`` hands the
    resampler in every call inside the block, as contiguous copies."""
    from uncertainty_nerf_gs_torch.ops import sampling

    calls = []
    inner = sampling.resample_edges

    def recording(weights, s_edges, u, *args):
        calls.append(tuple(t.detach().contiguous().clone() for t in (weights, s_edges, u)))
        return inner(weights, s_edges, u, *args)

    sampling.resample_edges = recording
    try:
        yield calls
    finally:
        sampling.resample_edges = inner


def field_widths(trainer) -> list[tuple[str, int]]:
    """(field, lookups a ray) in ``lookup_cells``' column order."""
    cfg = trainer.config
    samples = list(cfg.num_proposal_samples) + [cfg.num_nerf_samples]
    names = [f"proposal_{i}" for i in range(len(samples) - 1)] + ["field"]
    return [(name, n * len(f.encoding.resolutions))
            for name, n, f in zip(names, samples, trainer.model._fields())]


def diagnose_first_resampler(trainer, k_calls, p_calls, k_cells, p_cells) -> dict:
    """Where the training check's flips come from. K1 and the plain
    resampler on the exact inputs each path handed the first resampler
    (equal bits expected: both sum in K1's order); how far those inputs
    differ between the paths (the proposal density, K4 on one and the plain
    lookup on the other, upstream); and which field's lookups flipped."""
    from uncertainty_nerf_gs_torch.ops.pdf_resample import resample_edges, resample_edges_reference

    out = {}
    for label, calls in (("kernel path", k_calls), ("plain path", p_calls)):
        w, e, u = calls[0]
        got, want = resample_edges(w, e, u), resample_edges_reference(w, e, u)
        out[label] = dict(differ=int((got != want).sum()), max_abs_err=(got - want).abs().max().item())
        print(f"first resampler, {label}'s inputs {tuple(w.shape)} -> {tuple(u.shape)}: K1 and the "
              f"plain version differ in {out[label]['differ']} of {got.numel()} edges "
              f"(max_abs_err {out[label]['max_abs_err']:.3e})")
    (kw, ke, ku), (pw, pe, pu) = k_calls[0], p_calls[0]
    rel = ((kw - pw).abs() / pw.abs().clamp_min(1e-30))[pw > 0]
    out["inputs"] = dict(weights_max_abs=(kw - pw).abs().max().item(),
                         weights_max_rel=rel.max().item() if rel.numel() else 0.0,
                         weights_differ=int((kw != pw).sum()), edges_equal=torch.equal(ke, pe),
                         u_equal=torch.equal(ku, pu))
    print(f"first resampler inputs, kernel path against plain path: annealed weights differ in "
          f"{out['inputs']['weights_differ']} of {kw.numel()} (max_abs {out['inputs']['weights_max_abs']:.3e}, "
          f"max_rel {out['inputs']['weights_max_rel']:.3e}; proposal 0's density: K4 against the plain "
          f"lookup); edges equal {out['inputs']['edges_equal']}, u equal {out['inputs']['u_equal']}")
    col, per_field = 0, {}
    for name, width in field_widths(trainer):
        per_field[name] = int((k_cells[:, col:col + width] != p_cells[:, col:col + width]).any(1).sum())
        col += width
    out["flipped_by_field"] = per_field
    print("rays with a flipped lookup, by field: " + ", ".join(f"{k} {v}" for k, v in per_field.items()))
    return out


def check_nerfacto_train_plain(trainer) -> dict:
    """One step through the kernels against the same step on the plain
    versions, with the same batch and draws: the forward outputs, every
    ray's cells and the loss terms bit for bit (K1 and K4 equal their plain
    versions, so the forwards are the same), each gradient within
    TRAIN_GRAD_L2 in relative L2 norm (a cell table level by level: K5
    against autograd). Also replays the first resampler's inputs
    (``diagnose_first_resampler``)."""
    from uncertainty_nerf_gs_torch.ops import backend

    from uncertainty_nerf_gs_torch.ops.encodings import face_vertices

    gen = torch.Generator(device=trainer.device).manual_seed(SEED + 300)
    batch = trainer.sample_batch(NERF_RAYS)
    draws = trainer.model.draw(NERF_RAYS, gen)
    if trainer.config.face_consistency_mult > 0.0:
        enc = trainer.model.field.encoding
        draws["face_vertices"] = face_vertices([enc.resolutions[lvl] for lvl in enc.cell_levels()],
                                               trainer.config.face_consistency_samples, gen)
    backend.reset_launch_counts()
    with record_resampler() as k_calls:
        k_losses, k_grads, k_cells, k_out = nerfacto_step(trainer, batch, draws, plain=False)
    kernel_launches = dict(backend.launch_counts)
    backend.reset_launch_counts()
    with record_resampler() as p_calls:
        p_losses, p_grads, p_cells, p_out = nerfacto_step(trainer, batch, draws, plain=True)
    if any(backend.launch_counts.values()):
        raise AssertionError(f"kernels launched inside plain_versions(): {backend.launch_counts}")
    flipped = int((k_cells != p_cells).any(dim=1).sum())
    differ = bits_differ(k_out, p_out)
    print(f"nerfacto train plain path: {flipped} of {NERF_RAYS} rays flipped a cell; "
          f"{sum(differ.values())} forward output entries not bit-identical"
          + "".join(f", {k} {v}" for k, v in differ.items() if v)
          + f"; kernel-path launches {kernel_launches}")
    diagnosis = diagnose_first_resampler(trainer, k_calls, p_calls, k_cells, p_cells)
    if any(d["differ"] for k, d in diagnosis.items() if k.endswith("path")):
        raise AssertionError("K1 and the plain resampler differ on the same inputs")
    print("nerfacto train plain path: losses " + ", ".join(
        f"{k} {k_losses[k]!r} / {p_losses[k]!r}" for k in k_losses))
    failed = [k for k in k_losses if k_losses[k] != p_losses[k]]
    if flipped or any(differ.values()):
        failed.append("the forward")
    grad_err = {}
    for k, want in p_grads.items():
        got = k_grads[k]
        grad_err[k] = grad_l2_error(k, got, want)
        if grad_err[k] > TRAIN_GRAD_L2 or not torch.isfinite(got).all():
            failed.append(k)
    for k in sorted(grad_err, key=lambda k: -grad_err[k])[:8]:
        print(f"  gradient {k}: relative L2 error {grad_err[k]:.3e} (largest |g| "
              f"{p_grads[k].abs().max().item():.3e}, max_abs_err "
              f"{(k_grads[k] - p_grads[k]).abs().max().item():.3e}; bar {TRAIN_GRAD_L2})")
    if failed:
        raise AssertionError(f"nerfacto step: {failed} differ from the plain path")
    return dict(flipped=flipped, losses=k_losses, plain_losses=p_losses,
                max_grad_l2_err=max(grad_err.values()), diagnosis=diagnosis)


def trainer_snapshot(trainer) -> dict:
    """A copy of the trainer's whole state (parameters, Adam's moments and
    counts, step) and of its generator's, to restore twice."""
    sd = trainer.state_dict()
    clone = lambda d: {k: v.detach().clone() for k, v in d.items()}  # noqa: E731
    opt = sd["opt_state"]
    return dict(ckpt={"params": clone(sd["params"]), "step": sd["step"], "opt_state": {
        "groups": {k: dict(v) for k, v in opt["groups"].items()},
        "exp_avg": clone(opt["exp_avg"]), "exp_avg_sq": clone(opt["exp_avg_sq"])}},
        generator=trainer._generator.get_state())


def restore_snapshot(trainer, snap) -> None:
    trainer.restore(snap["ckpt"])
    trainer._generator.set_state(snap["generator"])


def check_nerfacto_repeatable(trainer) -> dict:
    """Two training steps from one restored state, with the same batch and
    draws (the trainer's generator restored too): the losses, every
    parameter, Adam's moments and counts and the step must be equal bit for
    bit. The trainer is left as the snapshot found it."""
    from uncertainty_nerf_gs_torch.ops import backend

    snap = trainer_snapshot(trainer)
    runs = []
    for _ in range(2):
        restore_snapshot(trainer, snap)
        backend.reset_launch_counts()
        losses = trainer.train_step(NERF_RAYS)
        runs.append((losses, trainer_snapshot(trainer)["ckpt"], dict(backend.launch_counts)))
    (l0, s0, n0), (l1, s1, n1) = runs
    differ = [k for k in l0 if l0[k] != l1[k]]
    for part in ("params", "exp_avg", "exp_avg_sq"):
        a = s0[part] if part == "params" else s0["opt_state"][part]
        b = s1[part] if part == "params" else s1["opt_state"][part]
        differ += [f"{part}:{k}" for k in a if not torch.equal(a[k], b[k])]
    if s0["opt_state"]["groups"] != s1["opt_state"]["groups"] or s0["step"] != s1["step"]:
        differ.append("counts")
    print(f"nerfacto repeatability: two steps from one state, launches {n0} and {n1}; "
          f"{len(differ)} of {len(l0) + 3 * len(s0['params']) + 1} items differ"
          + (f": {differ[:12]}" if differ else " (losses, every parameter, Adam's moments and counts "
             "bit-identical)"))
    restore_snapshot(trainer, snap)
    if differ:
        raise AssertionError(f"two training steps from one state differ: {differ[:12]}")
    return dict(items=len(l0) + 3 * len(s0["params"]) + 1, launches=n0)


def repeats(fn, like, grad, runs: int = 10) -> int:
    """How many of ``runs - 1`` backward passes of ``fn`` give another
    gradient than the first, on a fresh leaf cloned from ``like``."""
    grads = []
    for _ in range(runs):
        leaf = like.clone().requires_grad_(True)
        fn(leaf).backward(grad)
        grads.append(leaf.grad)
    return sum(not torch.equal(grads[0], g) for g in grads[1:])


def audit_determinism(trainer) -> dict:
    """What PyTorch itself flags: one training step under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, listing
    the warnings it raises (the mode is switched off again and the state
    restored; the port never sets it). An op with a deterministic variant
    switches to it silently under the mode, so the two ops this step used to
    take whose backwards add atomically are also run ten times each at the
    step's shapes, beside the formulations that replaced them: the
    interlevel loss's ``torch.gather`` (now ``raymarch.take_rows``) and the
    appearance embedding's ``nn.Embedding`` call (now an index into its
    weight)."""
    import warnings

    from uncertainty_nerf_gs_torch.ops.raymarch import take_rows

    snap = trainer_snapshot(trainer)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            trainer.train_step(NERF_RAYS)
        finally:
            torch.use_deterministic_algorithms(False)
    restore_snapshot(trainer, snap)
    messages = sorted({" ".join(str(w.message).split())[:200] for w in caught})
    flagged = [m for m in messages if "determinis" in m.lower()]
    print(f"determinism audit: one step under use_deterministic_algorithms(True, warn_only=True) "
          f"raised {len(caught)} warnings, {len(messages)} distinct, {len(flagged)} about determinism:")
    for m in messages:
        print(f"  {m}")
    gen = torch.Generator(device=trainer.device).manual_seed(SEED + 400)
    cfg, dev = trainer.config, trainer.device
    # the final edges crowd a few proposal bins, as where a step's weights peak
    t1 = torch.sort(torch.rand(NERF_RAYS, cfg.num_proposal_samples[0] + 1, generator=gen, device=dev),
                    dim=1).values
    t0 = torch.sort(0.4 + 0.02 * torch.rand(NERF_RAYS, cfg.num_nerf_samples + 1, generator=gen,
                                            device=dev), dim=1).values
    idx = torch.clamp(torch.searchsorted(t1, t0), 0, t1.shape[1] - 1)
    g = torch.randn(idx.shape, generator=gen, device=dev)
    table = trainer.model.field.appearance_embedding.weight.detach()
    cams = torch.randint(0, table.shape[0], (NERF_RAYS,), generator=gen, device=dev)
    g_embed = torch.randn(NERF_RAYS, table.shape[1], generator=gen, device=dev)
    counts = {
        "torch.gather": repeats(lambda v: torch.gather(v, -1, idx), t1, g),
        "take_rows": repeats(lambda v: take_rows(v, idx), t1, g),
        "nn.functional.embedding": repeats(lambda w: torch.nn.functional.embedding(cams, w), table, g_embed),
        "weight[index]": repeats(lambda w: w[cams], table, g_embed),
    }
    print(f"determinism audit: 10 backward passes each, how many differ from the first: "
          f"interlevel gather {tuple(idx.shape)} into {tuple(t1.shape)}: torch.gather "
          f"{counts['torch.gather']} of 9, take_rows {counts['take_rows']} of 9; appearance "
          f"embedding, {NERF_RAYS} rays into {tuple(table.shape)}: nn.functional.embedding "
          f"{counts['nn.functional.embedding']} of 9, weight[index] {counts['weight[index]']} of 9")
    if counts["take_rows"] or counts["weight[index]"]:
        raise AssertionError("a replacement's backward is not repeatable")
    return dict(warnings=messages, repeats=counts)


# -- nerfacto-mcdropout, nerfacto-laplace and the bf16 MLP at full width -------

# the JAX package's configs/methods.py:69-88 (the port has no configs/ yet)
MCDROPOUT = dict(uncertainty_channels=0, density_dropout_layers=(-1,), rgb_dropout_layers=(-1,),
                 dropout_rate=0.2)
MC_SAMPLES = 10  # nerfacto-mcdropout's mc_samples
LAPLACE = dict(uncertainty_channels=0, density_activation="softplus")
LAPLACE_ITERS, LAPLACE_RAYS, LAPLACE_SAMPLES = 300, 4096, 100  # eval_uncertainty.py:136's defaults
LAPLACE_PROFILED = 30  # fit batches under the profiler


def method_spec(mc_samples=0, laplace=False):
    """The JAX package's MethodSpec fields that the eval renderers read."""
    import types

    return types.SimpleNamespace(family="nerfacto", mc_samples=mc_samples, laplace=laplace)


def eval_chunk(trainer, idx: int = 0):
    from uncertainty_nerf_gs_torch.cameras.cameras import generate_rays, pixel_grid

    dev = trainer.device
    chunk = trainer.config.eval_num_rays_per_chunk
    px, py = pixel_grid(trainer.cameras.height, trainer.cameras.width, dev)
    return generate_rays(trainer.cameras, torch.full((chunk,), idx, dtype=torch.int64, device=dev),
                         px[:chunk], py[:chunk])


def image_launches(render, chunks: int, label: str, name: str) -> dict:
    """One image through ``render``: its launches (K1 2 and K4 3 a chunk,
    no K5), its host-clock time, and its device time and idle share under
    the profiler; every output finite."""
    from uncertainty_nerf_gs_torch.ops import backend

    backend.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = {k: v.cpu() for k, v in render(1).items()}  # ends in a copy to the host
    seconds = time.perf_counter() - t0
    launches = dict(backend.launch_counts)
    want = dict(pdf_resample=2 * chunks, cell_lookup_fwd=3 * chunks, cell_lookup_bwd=0)
    print(f"{label} image: launches {launches}, expected {want}; {1e3 * seconds:.1f} ms on {name}")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"the {label} image did not launch K1 2 and K4 3 a chunk")
    if not all(torch.isfinite(v).all() for v in out.values()):
        raise AssertionError(f"the {label} image is not finite")
    kernels, wall = device_kernels(lambda: render(1)["rgb"].cpu())
    busy = 1e-6 * sum(us for _, us in kernels.values())
    print(f"profile {label} image: wall {1e3 * wall:.1f} ms under the profiler, device busy {1e3 * busy:.1f} ms, "
          f"idle share {1 - busy / wall:.3f}")
    return dict(launches=launches, seconds=seconds, busy_ms=1e3 * busy, idle=1 - busy / wall, outputs=out)


def run_mcdropout(name) -> dict:
    """nerfacto-mcdropout at full width: five training steps of 4,096 rays
    (K1 2, K4 3, K5 3 a step; every group moves), two steps from one
    restored state bit-identical (the masks come from the trainer's
    generator, restored), one chunk's MC-dropout render at ``MC_SAMPLES``
    on the kernel path against the plain path with the same masks bit for
    bit, and one 256x256 image at ``MC_SAMPLES`` (K1 2 and K4 3 a chunk,
    whatever the sample count) beside a deterministic image of the same
    model, each timed and profiled."""
    from uncertainty_nerf_gs_torch.models.mcdropout import mc_dropout_render
    from uncertainty_nerf_gs_torch.ops import backend
    from uncertainty_nerf_gs_torch.ops.mlp import Dropout
    from uncertainty_nerf_gs_torch.scripts.eval_uncertainty import build_render_fn

    t0 = time.perf_counter()
    trainer = build_nerfacto(**MCDROPOUT)
    print(f"nerfacto-mcdropout: {sum(p.numel() for p in trainer.model.parameters())} parameters; set-up "
          f"{time.perf_counter() - t0:.1f} s")
    train = train_nerfacto(trainer, name)
    profile_top("nerfacto-mcdropout train step", lambda: trainer.train_step(NERF_RAYS), NERF_SYMBOLS, top=8)
    repeat = check_nerfacto_repeatable(trainer)
    if any(repeat["launches"][k] != v for k, v in dict(pdf_resample=2, cell_lookup_fwd=3, cell_lookup_bwd=3).items()):
        raise AssertionError(f"a repeated mcdropout step launched {repeat['launches']}")

    rb = eval_chunk(trainer)
    gen = torch.Generator(device=trainer.device).manual_seed(SEED + 21)
    dropouts = [Dropout(generator=gen) for _ in range(MC_SAMPLES)]
    trainer.model.forward_mc(rb, dropouts)  # draws each sample's masks once
    masks = [d.drawn for d in dropouts]
    backend.reset_launch_counts()
    kern = mc_dropout_render(trainer.model, rb, MC_SAMPLES, masks=masks)
    chunk_launches = dict(backend.launch_counts)
    backend.reset_launch_counts()
    with backend.plain_versions():
        plain = mc_dropout_render(trainer.model, rb, MC_SAMPLES, masks=masks)
    if any(backend.launch_counts.values()):
        raise AssertionError(f"kernels launched inside plain_versions(): {backend.launch_counts}")
    differ = bits_differ(kern, plain)
    print(f"nerfacto-mcdropout chunk at {MC_SAMPLES} samples: launches {chunk_launches}; against the plain "
          f"path with the same masks, {sum(differ.values())} output entries not bit-identical; rgb_std up to "
          f"{float(kern['rgb_std'].max()):.4f}")
    if sum(differ.values()) or (chunk_launches["pdf_resample"], chunk_launches["cell_lookup_fwd"]) != (2, 3):
        raise AssertionError("the MC-dropout chunk: another launch plan, or the kernel path differs from the plain path")

    cams = trainer.cameras
    chunks = -(-cams.height * cams.width // trainer.config.eval_num_rays_per_chunk)
    mc = image_launches(build_render_fn(trainer, method_spec(mc_samples=MC_SAMPLES), cams), chunks,
                        f"nerfacto-mcdropout ({MC_SAMPLES} samples)", name)
    single = image_launches(build_render_fn(trainer, method_spec(), cams), chunks, "nerfacto-mcdropout "
                            "deterministic", name)
    spread = {k: float(mc["outputs"][k].max()) for k in ("rgb_std", "depth_std", "expected_depth_std")}
    print(f"nerfacto-mcdropout image spread, largest: {spread}")
    if not spread["rgb_std"] > 0:
        raise AssertionError("the MC-dropout image has no spread")
    print(f"nerfacto-mcdropout: an image at {MC_SAMPLES} samples takes {mc['busy_ms'] / single['busy_ms']:.2f}x "
          f"the device time of a deterministic one ({mc['busy_ms']:.1f} / {single['busy_ms']:.1f} ms)")
    del trainer
    torch.cuda.empty_cache()
    return dict(train=train, chunk_launches=chunk_launches, mc={k: v for k, v in mc.items() if k != "outputs"},
                single={k: v for k, v in single.items() if k != "outputs"})


def run_laplace(name) -> dict:
    """nerfacto-laplace at full width (softplus density): ``fit_laplace``
    over ``LAPLACE_ITERS`` batches of 4,096 training rays (K1 2 and K4 3 a
    batch, no K5), timed and profiled; two batches' GGN on the kernel path
    against the plain path bit for bit; one chunk's ``laplace_render`` with
    given draws against the plain path bit for bit; one 256x256 image at
    ``LAPLACE_SAMPLES`` samples and as many density draws (K1 2 and K4 3 a
    chunk), timed and profiled."""
    from uncertainty_nerf_gs_torch.cameras.cameras import generate_rays
    from uncertainty_nerf_gs_torch.models import laplace as lp
    from uncertainty_nerf_gs_torch.ops import backend
    from uncertainty_nerf_gs_torch.scripts.eval_uncertainty import _nerfacto_full_image_renderer

    t0 = time.perf_counter()
    trainer = build_nerfacto(**LAPLACE)
    cfg, model, dev = trainer.config, trainer.model, trainer.device
    print(f"nerfacto-laplace: set-up {time.perf_counter() - t0:.1f} s")

    def batches(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)

        def batch_iter(step):
            b = trainer.sample_batch(LAPLACE_RAYS, generator=gen)
            return generate_rays(trainer.cameras, b["camera_indices"], b["pixel_x"], b["pixel_y"])

        return batch_iter

    backend.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    post = lp.fit_laplace(model, batches(SEED + 11), cfg, n_iters=LAPLACE_ITERS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = dict(backend.launch_counts)
    want = dict(pdf_resample=2 * LAPLACE_ITERS, cell_lookup_fwd=3 * LAPLACE_ITERS, cell_lookup_bwd=0)
    print(f"nerfacto-laplace fit, {LAPLACE_ITERS} batches of {LAPLACE_RAYS} rays: {fit_s:.2f} s on {name}; "
          f"launches {fit_launches}, expected {want}")
    if any(fit_launches[k] != v for k, v in want.items()):
        raise AssertionError("the Laplace fit did not launch K1 2 and K4 3 a batch")
    if not all(torch.isfinite(v).all() and v.max() > 0 for h in post for v in h.values()):
        raise AssertionError("the Laplace GGN is not finite and positive")
    # the profiler's summary of all 300 batches takes about a minute: a
    # tenth of them is profiled, and its device time scaled to the fit's
    kernels, wall = device_kernels(lambda: lp.fit_laplace(model, batches(SEED + 11), cfg,
                                                          n_iters=LAPLACE_PROFILED))
    fit_busy = 1e-3 * sum(us for _, us in kernels.values()) * LAPLACE_ITERS / LAPLACE_PROFILED
    print(f"profile nerfacto-laplace fit, its first {LAPLACE_PROFILED} batches: wall {wall:.3f} s under the "
          f"profiler, device busy {1e-3 * fit_busy * LAPLACE_PROFILED / LAPLACE_ITERS:.3f} s, idle share "
          f"{1 - 1e-3 * fit_busy * LAPLACE_PROFILED / LAPLACE_ITERS / wall:.3f}; scaled to {LAPLACE_ITERS} "
          f"batches {1e-3 * fit_busy:.2f} s of device time")

    k_post = lp.fit_laplace(model, batches(SEED + 12), cfg, n_iters=2)
    with backend.plain_versions():
        p_post = lp.fit_laplace(model, batches(SEED + 12), cfg, n_iters=2)
    ggn_differ = sum(int((a[k] != b[k]).sum()) for a, b in zip(k_post, p_post) for k in a)
    rb = eval_chunk(trainer)
    noise = lp.laplace_draws(tuple(rb.origins.shape[:1]) + (cfg.num_nerf_samples,), LAPLACE_SAMPLES,
                             LAPLACE_SAMPLES, torch.Generator(device=dev).manual_seed(SEED + 13))
    backend.reset_launch_counts()
    kern = lp.laplace_render(model, post, rb, cfg, noise=noise, n_samples=LAPLACE_SAMPLES)
    with backend.plain_versions():
        plain = lp.laplace_render(model, post, rb, cfg, noise=noise, n_samples=LAPLACE_SAMPLES)
    differ = bits_differ(kern, plain)
    print(f"nerfacto-laplace against the plain path: two batches' GGN {ggn_differ} entries not bit-identical; "
          f"a chunk's render with the same draws {sum(differ.values())} output entries not bit-identical; "
          f"rgb_std up to {float(kern['rgb_std'].max()):.4f}, depth_std up to {float(kern['depth_std'].max()):.4f}")
    if ggn_differ or sum(differ.values()):
        raise AssertionError("nerfacto-laplace: the kernel path differs from the plain path")

    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    render = _nerfacto_full_image_renderer(cfg, lambda rb_: lp.laplace_render(
        model, post, rb_, cfg, generator=gen, n_samples=LAPLACE_SAMPLES, num_density_draws=LAPLACE_SAMPLES),
        trainer.cameras, dev)
    cams = trainer.cameras
    chunks = -(-cams.height * cams.width // cfg.eval_num_rays_per_chunk)
    image = image_launches(render, chunks, f"nerfacto-laplace ({LAPLACE_SAMPLES} samples)", name)
    del trainer, model
    torch.cuda.empty_cache()
    return dict(fit_s=fit_s, fit_busy_s=1e-3 * fit_busy, fit_launches=fit_launches,
                image={k: v for k, v in image.items() if k != "outputs"})


def check_bf16(trainer, name) -> dict:
    """One full-width chunk of active-nerfacto rendered by the trainer's
    model (float32 MLPs), by the same weights with ``mixed_precision=True``
    (bf16 MLPs) and with bf16 in the main field only (the proposals'
    MLPs float32, so the samples stay where float32 puts them): the
    largest deviation of the rgb, depth and variance outputs from float32,
    and each chunk's time (CUDA events) and device time."""
    import dataclasses

    from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoModel

    bf16, main = (NerfactoModel(dataclasses.replace(trainer.config, mixed_precision=True), device=trainer.device)
                  for _ in range(2))
    for m in (bf16, main):
        m.load_state_dict(trainer.model.state_dict())
    for i in range(main.num_proposal_levels):
        getattr(main, f"proposal_{i}").mlp.compute_dtype = None
    rb = eval_chunk(trainer)
    f32_out, bf16_out, main_out = trainer.model(rb), bf16(rb), main(rb)
    keys = ("rgb", "depth", "expected_depth", "depth_var", "rgb_var", "accumulation")
    err = {k: float((f32_out[k] - bf16_out[k]).abs().max()) for k in keys}
    main_err = {k: float((f32_out[k] - main_out[k]).abs().max()) for k in keys}
    if not all(torch.isfinite(o[k]).all() for o in (bf16_out, main_out) for k in keys):
        raise AssertionError("a bf16 chunk is not finite")
    times = {label: dict(event_ms=time_ms(m, [(rb,)], reps=10), device_ms=device_ms(m, [(rb,)], ""))
             for label, m in (("f32", trainer.model), ("bf16", bf16))}
    print(f"bf16 MLPs (mixed_precision) against float32, one chunk of {rb.origins.shape[0]} rays: max_abs_err "
          + ", ".join(f"{k} {v:.3e}" for k, v in err.items()) + "; bf16 in the main field only: "
          + ", ".join(f"{k} {v:.3e}" for k, v in main_err.items()) + "; " + ", ".join(
              f"{k} {v['event_ms']:.2f} ms a chunk ({v['device_ms']:.2f} ms of device time)" for k, v in times.items())
          + f" on {name}")
    return dict(max_abs_err=err, main_field_only_max_abs_err=main_err, times=times)


# -- active-splatfacto at full width -------------------------------------------

SPLAT_IMAGES, SPLAT_STEPS = 2, 5


def build_splat(device=None, member: int | None = None, **overrides):
    """The repo's splat benchmark shape (bench.py:289-297): 65,536 slots with
    65,000 live Gaussians in a +-1.5 cube, capacity 384, SH degree 3,
    active-splatfacto, 640x480 with fx = fy = 500. ``sh_degree_interval=2``
    ramps the SH degree to 2 within the five steps, so every parameter group
    trains; images and a perturbation of the initial log-scales from a
    numpy seed. ``member`` m (the splat ensemble's) draws the perturbation
    from numpy seed m and drops a tenth of the live slots from its alive
    mask; ``overrides`` replace config fields (and ``use_camera_optimizer``
    the trainer's)."""
    from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras
    from uncertainty_nerf_gs_torch.engine.splat_trainer import SplatfactoTrainer
    from uncertainty_nerf_gs_torch.models.splatfacto import SplatfactoConfig

    camera_opt = overrides.pop("use_camera_optimizer", False)
    cfg = SplatfactoConfig(**{**dict(
        capacity=1 << 16, num_random=65_000, random_scale=1.5, rasterize_capacity=384,
        uncertainty_channels=1, background_color="white", sh_degree_interval=2,
    ), **overrides})
    cams = hemisphere_cameras(4, 480, 640, radius=4.0, focal_mult=0.78125)
    rng = np.random.default_rng(SEED)
    images = rng.uniform(size=(4, 480, 640, 3)).astype(np.float32)
    trainer = SplatfactoTrainer(cfg, cams, images, seed=SEED, use_camera_optimizer=camera_opt, device=device)
    # anisotropic scales: at init every Gaussian is isotropic, and the
    # gradient of its quaternion is float32 noise
    if member is not None:
        rng = np.random.default_rng(member)
    params = {k: v.detach().cpu().numpy() for k, v in trainer.params.items()}
    params["scales"] += rng.uniform(-0.5, 0.3, params["scales"].shape).astype(np.float32)
    alive = trainer.splat_state.alive.cpu().numpy()
    if member is not None:
        alive &= rng.uniform(size=alive.shape) >= 0.1
    trainer.restore({"params": params, "splat_alive": alive, "step": 0})
    return trainer


def run_splat(trainer, name) -> dict:
    """Two images through render_image, then five train steps; every output
    finite, every group moved, K2 launched 2 + 5 times and K3 5 times."""
    from uncertainty_nerf_gs_torch.ops import backend

    h, w = trainer.cameras.height, trainer.cameras.width
    start = {k: v.detach().clone() for k, v in trainer.params.items()}
    backend.reset_launch_counts()
    render_s, step_s, overflow, losses = [], [], [], []
    for idx in range(SPLAT_IMAGES):
        t0 = time.perf_counter()
        images = trainer.render_image(idx)  # ends in a copy to the host
        render_s.append(time.perf_counter() - t0)
        overflow.append(int(images["raster_overflow"]))
        for k, v in images.items():
            if not np.isfinite(v).all():
                raise AssertionError(f"splat image {idx}: {k} not finite")
        if images["rgb"].shape != (h, w, 3) or images["uncertainty"].shape != (h, w):
            raise AssertionError(f"splat image {idx}: shapes {images['rgb'].shape}")
    for _ in range(SPLAT_STEPS):
        t0 = time.perf_counter()
        losses.append(trainer.train_step())  # ends in a copy of the losses to the host
        step_s.append(time.perf_counter() - t0)
    launches = dict(backend.launch_counts)
    print(f"splat launches {launches}, expected composite_fwd {SPLAT_IMAGES + SPLAT_STEPS}, "
          f"composite_bwd {SPLAT_STEPS}, packed_rows_bwd {SPLAT_STEPS}")
    if (launches["composite_fwd"], launches["composite_bwd"], launches["packed_rows_bwd"]) != (
            SPLAT_IMAGES + SPLAT_STEPS, SPLAT_STEPS, SPLAT_STEPS):
        raise AssertionError("the splat path did not go through the compositing and gather kernels")
    for i, l in enumerate(losses):
        if not all(np.isfinite(v) for v in l.values()):
            raise AssertionError(f"step {i}: loss not finite {l}")
    for k, v in trainer.params.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"{k} not finite after the steps")
        if torch.equal(v.detach(), start[k]):
            raise AssertionError(f"{k} did not change in {SPLAT_STEPS} steps")
    print(f"splat raster_overflow per image (the worst tile's dropped hits): {overflow}")
    for i, s in enumerate(render_s):
        print(f"splat image {i}: {1e3 * s:.1f} ms/image on {name}")
    for i, (s, l) in enumerate(zip(step_s, losses)):
        print(f"splat step {i}: {1e3 * s:.1f} ms/step on {name}, total_loss {l['total_loss']:.4f}")
    return dict(launches=launches, render_s=render_s, step_s=step_s, overflow=overflow)


def splat_grads(trainer, cam_idx: int, plain: bool) -> tuple[dict, dict]:
    """One step's loss terms and gradients (parameters and the screen-space
    tap) at the trainer's state, without updating it. With ``plain`` the
    forward runs inside ``backend.plain_versions()`` and autograd runs the
    backward after the block has closed: it follows the forward's path."""
    from uncertainty_nerf_gs_torch.models import splatfacto as sf
    from uncertainty_nerf_gs_torch.ops import backend

    cfg = trainer.config
    params = {k: v.detach().clone().requires_grad_(True) for k, v in trainer.params.items()}
    tap = torch.zeros((cfg.capacity, 2), device=trainer.device, requires_grad=True)
    with backend.plain_versions() if plain else contextlib.nullcontext():
        out = sf.render_splat(
            params, trainer.splat_state.alive, *trainer.camera(cam_idx),
            trainer.cameras.width, trainer.cameras.height, cfg,
            sh_deg=sf.active_sh_degree(trainer.step, cfg),
            background=sf.fixed_background(cfg, trainer.device), means2d_tap=tap,
        )
        total, losses = sf.splatfacto_loss(out, trainer.images[cam_idx], params, cfg)
    total.backward()
    grads = {k: p.grad for k, p in params.items()}
    grads["means2d_tap"] = tap.grad
    return {k: float(v.detach()) for k, v in losses.items()}, grads


def check_splat_plain(trainer) -> dict:
    """One image and one step's gradients again on the compositor's plain
    path (``backend.plain_versions()``): outputs within the CPU tests'
    forward tolerances, gradients within SPLAT_GRAD_TOL relative to their
    largest entry; K2 and K3 launched on the kernel path only."""
    from uncertainty_nerf_gs_torch.ops import backend

    kern = trainer.render_image(1)
    backend.reset_launch_counts()
    with backend.plain_versions():
        plain = trainer.render_image(1)
    if any(backend.launch_counts.values()):
        raise AssertionError(f"kernels launched inside plain_versions(): {backend.launch_counts}")
    out_err = {}
    for k, v in kern.items():
        tol = SPLAT_OUTPUT_TOLS.get(k, SPLAT_FWD_TOL)
        out_err[k] = float(np.abs(v - plain[k]).max())
        if not np.allclose(v, plain[k], **tol):
            raise AssertionError(f"splat render: {k} differs from the plain path by {out_err[k]:.3e}")
    backend.reset_launch_counts()
    k_losses, k_grads = splat_grads(trainer, 2, plain=False)
    if backend.launch_counts["composite_bwd"] != 1 or backend.launch_counts["packed_rows_bwd"] != 1:
        raise AssertionError("the kernel-path gradients did not launch K3 and the gather's backward")
    backend.reset_launch_counts()
    p_losses, p_grads = splat_grads(trainer, 2, plain=True)
    if any(backend.launch_counts.values()):
        raise AssertionError(f"the plain-path gradients launched a kernel: {backend.launch_counts}")
    print("splat plain path: outputs max_abs_err " + ", ".join(f"{k} {v:.2e}" for k, v in out_err.items()))
    print("splat plain path: losses " + ", ".join(
        f"{k} {k_losses[k]:.6f} / {p_losses[k]:.6f}" for k in k_losses))
    grad_err, failed = {}, []
    for k, want in p_grads.items():
        mag = want.abs()
        nonzero = mag[mag > 0]
        top = mag.max().item()
        err = (k_grads[k] - want).abs().max().item()
        bad = int(grad_mismatch(k_grads[k], want).sum())
        elementwise = int((~torch.isclose(k_grads[k], want, **SPLAT_GRAD_TOL)).sum())
        grad_err[k] = dict(largest=top, max_abs_err=err)
        print(f"splat plain path: gradient {k}: largest |g| {top:.3e}, median nonzero "
              f"{nonzero.median().item() if nonzero.numel() else 0.0:.3e}, max_abs_err {err:.3e} "
              f"against a bar of {SPLAT_GRAD_TOL['atol'] * top:.3e} + rtol 1e-3; {bad} entries "
              f"outside, {elementwise} outside atol 1e-4 + rtol 1e-3")
        if bad or not top > 0:
            failed.append(k)
    if failed:
        raise AssertionError(f"splat gradients {failed} differ from the plain path or are zero")
    return dict(out_err=out_err, grad_err=grad_err)


def profile_splat(trainer) -> None:
    symbols = {"composite_fwd": "composite_fwd_kernel", "composite_bwd": "composite_bwd_kernel",
               "packed_rows_bwd": PACKED_ROWS_SYMBOL}
    profile_top("splat train step", trainer.train_step, symbols)
    profile_top("splat image 0", lambda: trainer.render_image(0), symbols, top=8)


# -- the splat gather's backward, and the splat step's repeatability ----------

PACKED_ROWS_SYMBOL = "packed_rows_"  # its count, scan, place and sum kernels


def capture_gather(trainer, cam_idx: int = 2) -> tuple:
    """The packed-row backward's inputs (g_packed, idx_all, counts, n) in one
    real step of ``trainer`` at its rasterize budgets (``splat_grads``,
    which leaves the trainer as it was), recorded at the wrapper."""
    from uncertainty_nerf_gs_torch.ops import rasterize

    seen = []
    real = rasterize.packed_rows_bwd

    def record(g, idx, counts, n):
        seen.append((g.clone(), idx.clone(), counts.clone(), n))
        return real(g, idx, counts, n)

    rasterize.packed_rows_bwd = record
    try:
        splat_grads(trainer, cam_idx, plain=False)
    finally:
        rasterize.packed_rows_bwd = real
    if len(seen) != 1:
        raise AssertionError(f"a splat step ran the packed-row backward {len(seen)} times, expected 1")
    return seen[0]


def packed_rows_bound_ms(g, counts, n) -> tuple[float, int, int]:
    """The byte bound: every live slot's row read once and every row of
    g_src (the pad row's too) written once, at the card's memory rate."""
    live, d = int(counts.sum()), g.shape[2]
    nbytes = 4 * d * (live + n + 1)
    return 1e3 * nbytes / HBM_BYTES_PER_S, nbytes, live


def check_packed_rows(label, captured, gen, second, other=None) -> dict:
    """The gather's backward (``csrc/packed_rows.cu``) on a real step's
    inputs: launched twice and required bit-identical, and required equal
    to ``packed_rows_vjp_reference`` bit for bit (both add each row's
    entries in ascending (tile, slot) order); F.embedding's backward with
    the pad row skipped (``embedding_dense_backward``, the library call for
    the same function, another order) and the float64 sum printed beside
    them. Then captured in a ``torch.cuda.CUDAGraph`` on ``captured`` (its
    index in select_and_pack's layout, rows K + 1 apart) and replayed, and
    replayed again after ``second`` (another step's inputs of the same
    shapes, with another number of live slots) was copied over the inputs
    in place: both replays must equal the plain version bit for bit, which
    shows that nothing is sized on the host. Then timed over input sets
    that pass MIN_SET_BYTES: the kernels' device time per call, a call back
    to back by CUDA events, the plain version's and the library call's,
    against the byte bound. ``other`` (``other_corner``): that checkout's
    backward held bit for bit and timed in turns with this one's at the
    same inputs (this, other, other, this). These launches are not the
    main path's: the counters are left as found."""
    from uncertainty_nerf_gs_torch.ops import backend, rasterize

    saved = dict(backend.launch_counts)
    g, idx, counts, n = captured
    t, k, d = g.shape

    def library(g_, idx_, counts_, n_):
        return torch.ops.aten.embedding_dense_backward(g_, idx_, n_ + 1, n_, False)

    a = rasterize.packed_rows_bwd(g, idx, counts, n)
    b = rasterize.packed_rows_bwd(g, idx, counts, n)
    plain = rasterize.packed_rows_vjp_reference(g, idx, counts, n)
    lib = library(g, idx, counts, n)
    live = torch.arange(k, device=g.device)[None, :] < counts[:, None]
    exact = torch.zeros((n + 1, d), dtype=torch.float64, device=g.device)
    exact.index_add_(0, idx[live], g[live].double())
    exact[n] = 0.0
    runs = torch.bincount(idx[live], minlength=n + 1)[:n]
    torch.cuda.synchronize()
    identical, equal = torch.equal(a, b), torch.equal(a, plain)
    err = float((a - plain).abs().max())
    lib_err = float((a - lib).abs().max())
    err64 = float((a.double() - exact).abs().max())
    lib64 = float((lib.double() - exact).abs().max())
    bound, nbytes, num_live = packed_rows_bound_ms(g, counts, n)
    print(f"packed-row backward {label}: g_packed {tuple(g.shape)}, {num_live} live slots of {t * k}, "
          f"{n} rows: two launches bit-identical {identical}; against the plain version max_abs_err "
          f"{err:.3e} (bit for bit: {equal}); against F.embedding's backward {lib_err:.3e}; against "
          f"float64 {err64:.3e} (F.embedding's {lib64:.3e}); runs: longest {int(runs.max())}, "
          f"{int((runs > 8).sum())} rows past 8 slots, {int((runs > 32).sum())} past 32")
    if not (identical and equal and torch.isfinite(a).all()):
        raise AssertionError(f"packed-row backward {label}: not bit-identical to itself or its plain version")

    # a CUDA graph: captured once, replayed on inputs overwritten in place
    g2, idx2, counts2, n2 = second
    if tuple(g2.shape) != (t, k, d) or n2 != n:
        raise AssertionError(f"packed-row backward {label}: the second set's shapes differ")
    if int(counts2.sum()) == num_live:  # another live count: drop one tile's last live slot
        counts2 = counts2.clone()
        counts2[int(torch.nonzero(counts2)[0])] -= 1
    gs, cs_ = g.clone(), counts.clone()
    ids = torch.full((t, k + 1), n, dtype=idx.dtype, device=idx.device)[:, :k]  # select_and_pack's layout
    ids.copy_(idx)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rasterize.packed_rows_bwd(gs, ids, cs_, n)
    graph.replay()
    torch.cuda.synchronize()
    replay_equal = torch.equal(out, plain)
    gs.copy_(g2)
    ids.copy_(idx2)
    cs_.copy_(counts2)
    graph.replay()
    plain2 = rasterize.packed_rows_vjp_reference(g2, idx2, counts2, n)
    torch.cuda.synchronize()
    replay2_equal = torch.equal(out, plain2)
    live2 = int(counts2.sum())
    del graph, out
    print(f"packed-row backward {label}: captured in a CUDA graph at {num_live} live slots and replayed: bit for "
          f"bit {replay_equal}; inputs overwritten in place with another step's ({live2} live slots) and "
          f"replayed: bit for bit against the plain version {replay2_equal}")
    if not (replay_equal and replay2_equal):
        raise AssertionError(f"packed-row backward {label}: a graph replay differs from the plain version")

    per_set = 4 * g.numel() + 8 * idx.numel()
    sets = [captured]
    for _ in range(-(-MIN_SET_BYTES // per_set) - 1):
        sets.append((g + 1e-3 * torch.randn(g.shape, generator=gen, device=g.device), idx.clone(),
                     counts.clone(), n))
    ms = device_ms(rasterize.packed_rows_bwd, sets, "")
    event_ms = time_ms(rasterize.packed_rows_bwd, sets)
    plain_ms = device_ms(rasterize.packed_rows_vjp_reference, sets, "")
    library_ms = device_ms(library, sets, "")
    traced, _ = device_kernels(lambda: rasterize.packed_rows_bwd(*captured))
    print(f"packed-row backward {label}: kernels {ms:.4f} ms of device time a call ({event_ms:.4f} ms a call "
          f"back to back), plain {plain_ms:.4f} ms, F.embedding's backward {library_ms:.4f} ms, bound "
          f"{bound:.4f} ms (bytes: {nbytes / 1e6:.2f} MB); device kernels of one call: " + ", ".join(
              f"{kernel_name(name)} x{c} {1e-3 * us:.4f} ms" for name, (c, us) in sorted(traced.items())))
    result = dict(ms=ms, event_ms=event_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                  bound_by="bytes", bytes=nbytes, shape=[t, k, d], live=num_live, rows=n, max_abs_err=err,
                  library_err=lib_err, bit_identical=identical, graph_replay_live=live2,
                  longest_run=int(runs.max()), device_kernels={kernel_name(name): [c, 1e-3 * us]
                                                                for name, (c, us) in traced.items()})
    if other is not None:
        theirs = other.packed_rows_bwd(g, idx, counts, n)
        torch.cuda.synchronize()
        other_equal = torch.equal(theirs, plain)
        turns = []
        for who in ("this", "other", "other", "this"):
            fn = rasterize.packed_rows_bwd if who == "this" else other.packed_rows_bwd
            turns.append((who, device_ms(fn, sets, ""), time_ms(fn, sets)))
        mine = [(d_, e_) for w, d_, e_ in turns if w == "this"]
        theirs_t = [(d_, e_) for w, d_, e_ in turns if w == "other"]
        print(f"packed-row backward {label}, in turns with {other.checkout} at the same inputs (this, other, other, "
              f"this): device ms a call this {mine[0][0]:.4f} / {mine[1][0]:.4f}, other {theirs_t[0][0]:.4f} / "
              f"{theirs_t[1][0]:.4f}; a call back to back this {mine[0][1]:.4f} / {mine[1][1]:.4f}, other "
              f"{theirs_t[0][1]:.4f} / {theirs_t[1][1]:.4f}; the other's bit for bit against the plain version "
              f"{other_equal}")
        result.update(turns=[dict(who=w, ms=d_, event_ms=e_) for w, d_, e_ in turns], other_equal=other_equal)
    backend.launch_counts.clear()
    backend.launch_counts.update(saved)
    return result


def _clone_tree(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, dict):
        return {k: _clone_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_clone_tree(v) for v in x]
    return x


def splat_snapshot(trainer) -> dict:
    """A copy of the splat trainer's whole state: its ``state_dict`` (the
    Gaussians, every group's Adam moments and counts, the camera tangents
    and their Adam, the alive mask, the step), the strategy statistics, the
    config (the tuned budgets), the torch generator and the camera order's
    numpy generator."""
    import copy

    return dict(ckpt=_clone_tree(trainer.state_dict()), stats=[x.clone() for x in trainer.splat_state],
                config=trainer.config, generator=trainer._generator.get_state(),
                cam_rng=copy.deepcopy(trainer._cam_rng.bit_generator.state))


def restore_splat(trainer, snap) -> None:
    import copy

    from uncertainty_nerf_gs_torch.models import splatfacto as sf

    trainer.restore(snap["ckpt"])
    trainer.splat_state = sf.SplatState(*(x.clone() for x in snap["stats"]))
    trainer.config = snap["config"]
    trainer._generator.set_state(snap["generator"])
    trainer._cam_rng.bit_generator.state = copy.deepcopy(snap["cam_rng"])


def _tree_differ(prefix, a, b, out) -> int:
    """Adds to ``out`` every leaf of two trees that differs in a bit, with
    its largest absolute difference; returns the number of leaves."""
    if isinstance(a, dict):
        return sum(_tree_differ(f"{prefix}{k}/", a[k], b[k], out) for k in a)
    if isinstance(a, torch.Tensor):
        if not torch.equal(a, b):
            out[prefix[:-1]] = float((a.double() - b.double()).abs().max()) if a.is_floating_point() \
                else int((a != b).sum())
        return 1
    if isinstance(a, np.ndarray):
        if not np.array_equal(a, b):
            out[prefix[:-1]] = int((a != b).sum())
        return 1
    if a != b:
        out[prefix[:-1]] = (a, b)
    return 1


def check_splat_repeatable(trainer, label: str, required: bool = True) -> dict:
    """Two training steps from one restored snapshot (``splat_snapshot``:
    the same camera, background and refine draws): the losses, every leaf
    of the Gaussians, every group's Adam moments and counts, the camera
    tangents with their Adam, the strategy statistics and the step must be
    equal bit for bit. Prints each differing leaf with its largest
    deviation. The trainer and the launch counters are left as found;
    ``required`` fails the run on a difference."""
    from uncertainty_nerf_gs_torch.ops import backend

    snap = splat_snapshot(trainer)
    saved = dict(backend.launch_counts)
    runs = []
    for _ in range(2):
        restore_splat(trainer, snap)
        backend.reset_launch_counts()
        losses = trainer.train_step()
        after = splat_snapshot(trainer)
        runs.append(({k: torch.tensor(v) for k, v in losses.items()}, after, dict(backend.launch_counts)))
    restore_splat(trainer, snap)
    backend.launch_counts.clear()
    backend.launch_counts.update(saved)
    (l0, s0, n0), (l1, s1, n1) = runs
    differ: dict = {}
    items = _tree_differ("loss:", l0, l1, differ)
    items += _tree_differ("", s0["ckpt"], s1["ckpt"], differ)
    items += _tree_differ("stats:", dict(enumerate(s0["stats"])), dict(enumerate(s1["stats"])), differ)
    cfg = trainer.config
    print(f"splat repeatability, {label} (capacity {cfg.rasterize_capacity}, step {snap['ckpt']['step']}, "
          f"{int(trainer.splat_state.alive.sum())} alive): two steps from one snapshot, launches "
          f"{ {k: v for k, v in n0.items() if v} } and { {k: v for k, v in n1.items() if v} }; {len(differ)} "
          f"of {items} items differ"
          + (": " + ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                              for k, v in sorted(differ.items(), key=lambda kv: str(kv[0])))
             if differ else " (losses, Gaussians, Adam moments and counts, camera tangents, statistics "
                            "bit-identical)"))
    if differ and required:
        raise AssertionError(f"two splat training steps from one snapshot differ ({label})")
    return dict(label=label, capacity=cfg.rasterize_capacity, step=snap["ckpt"]["step"], items=items,
                differ={k: v if isinstance(v, (int, float)) else str(v) for k, v in differ.items()},
                launches=n0)


def audit_splat_determinism(trainer, captured) -> dict:
    """What PyTorch flags in one splat training step under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` (switched
    off again, the state restored), and ten backward passes each of the
    packed-row gather as F.embedding (the formulation it replaced) and as
    ``PackedRowGather`` at a real step's shape: how many differ from the
    first."""
    import warnings

    from uncertainty_nerf_gs_torch.ops import backend
    from uncertainty_nerf_gs_torch.ops.rasterize import PackedRowGather

    snap = splat_snapshot(trainer)
    saved = dict(backend.launch_counts)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            trainer.train_step()
        finally:
            torch.use_deterministic_algorithms(False)
    restore_splat(trainer, snap)
    messages = sorted({" ".join(str(w.message).split())[:200] for w in caught})
    flagged = [m for m in messages if "determinis" in m.lower()]
    print(f"splat determinism audit: one step under use_deterministic_algorithms(True, warn_only=True) "
          f"raised {len(caught)} warnings, {len(messages)} distinct, {len(flagged)} about determinism:")
    for m in messages:
        print(f"  {m}")
    g, idx, counts, n = captured
    src = torch.randn((n + 1, g.shape[2]), device=g.device)
    counts_ = {
        "nn.functional.embedding(padding_idx=n)": repeats(
            lambda w: torch.nn.functional.embedding(idx, w, padding_idx=n), src, g),
        "PackedRowGather": repeats(lambda w: PackedRowGather.apply(w, idx, counts), src, g),
    }
    backend.launch_counts.clear()
    backend.launch_counts.update(saved)
    print(f"splat determinism audit: 10 backward passes each of the packed-row gather {tuple(g.shape)} from "
          f"{n + 1} rows, how many differ from the first: " + ", ".join(f"{k} {v} of 9" for k, v in counts_.items()))
    if counts_["PackedRowGather"]:
        raise AssertionError("the packed-row gather's backward is not repeatable")
    return dict(warnings=messages, repeats=counts_)


# -- active-splatfacto past warmup: refinement, the camera optimizer, the tuner

# a shortened schedule: refines at steps 20, 30, 60 and 70, opacity resets at
# 40 and 80, the scale and screen culls on at 60 and 70
REFINE_SCHEDULE = dict(warmup_length=10, refine_every=10, reset_alpha_every=4, stop_screen_size_at=50)
REFINE_STEPS, REFINES, RESETS = 80, (20, 30, 60, 70), (40, 80)


def build_splat_refine(device=None):
    """The splat benchmark's scene in a buffer of 131,072 slots, so that
    densification has room to grow, with the capacity tuner (at start and
    every 20 steps), the camera optimizer and REFINE_SCHEDULE; the SH degree
    ramps every 20 steps. The tuner runs again after the log-scales'
    perturbation, as a restore of other parameters would need."""
    trainer = build_splat(device, capacity=1 << 17, sh_degree_interval=20, rasterize_capacity_auto=True,
                          capacity_retune_every=20, use_camera_optimizer=True, **REFINE_SCHEDULE)
    trainer.retune_capacity()
    return trainer


def cpu_copy(params, state):
    from uncertainty_nerf_gs_torch.models import splatfacto as sf

    return ({k: v.detach().cpu().clone() for k, v in params.items()},
            sf.SplatState(*(x.detach().cpu().clone() for x in state)))


def run_splat_refine(trainer, name, other=None) -> dict:
    """REFINE_STEPS training steps through the refine schedule, then two
    images: K2 launched once a step and an image, K3 once a step; each
    refine's counts and time; the replaced slots' Adam moments zero right
    after each refine; the opacities' Adam count back at 0 after each reset
    (1 a step later, while the other groups count on); the camera tangents
    moved; every parameter and loss finite; the images overflow-free at the
    tuned capacity where it is below rasterize_capacity_max. The first
    refine is replayed on the CPU from the same state and split draws: its
    masks (the admitted splits and dups, the touched slots, the alive
    mask) and counts equal, its floats within TOL. K2 and K3 at the tuned
    capacity are held against their plain versions, then timed, and the
    packed-row backward is checked there (``check_packed_rows``, with
    ``other``'s in turns where given)."""
    from uncertainty_nerf_gs_torch.models import splatfacto as sf
    from uncertainty_nerf_gs_torch.ops import backend

    refines, replay = [], {}
    card_refine = trainer.refine

    def refine(eps=None):
        if not replay:  # the first refine: its inputs, for a replay on the CPU
            eps = torch.randn((trainer.config.n_split_samples, trainer.config.capacity, 3),
                              generator=trainer._generator, device=trainer.device)
            # the admitted splits and dups, as refine_gaussians takes them
            decisions = sf.refine_decisions(trainer.params, trainer.splat_state, trainer.config, trainer.step,
                                            trainer.scene_extent)
            replay.update(step=trainer.step, eps=eps.cpu(), config=trainer.config,
                          before=cpu_copy(trainer.params, trainer.splat_state),
                          decisions=[x.cpu() for x in decisions])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = card_refine(eps)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        touched = info["touched_slots"]
        for k, opt in trainer.optimizers.items():
            for st in opt.state.values():
                if st["exp_avg"][touched].any() or st["exp_avg_sq"][touched].any():
                    raise AssertionError(f"refine at step {trainer.step}: {k}'s moments not zeroed")
        if "after" not in replay:
            replay.update(after=cpu_copy(trainer.params, trainer.splat_state), info=info)
        counts = {k: int(v) for k, v in info.items() if k != "touched_slots"}
        refines.append(dict(step=trainer.step, seconds=seconds, touched=int(touched.sum()), **counts))
        return info

    trainer.refine = refine
    h, w = trainer.cameras.height, trainer.cameras.width
    start = {k: v.detach().clone() for k, v in trainer.params.items()}
    backend.reset_launch_counts()
    step_s, losses = [], []
    repeatable = []
    for _ in range(REFINE_STEPS):
        t0 = time.perf_counter()
        losses.append(trainer.train_step())  # ends in a copy of the losses to the host
        step_s.append(time.perf_counter() - t0)
        if trainer.step in (REFINES[0], REFINES[-1]):
            repeatable.append(check_splat_repeatable(trainer, f"after the refine at step {trainer.step}"))
        if trainer.step in RESETS or trainer.step - 1 in RESETS:
            groups = trainer.state_dict()["opt_state"]["groups"]
            want = int(trainer.step - 1 in RESETS)
            if (groups["opacities"]["adam_count"], groups["opacities"]["schedule_count"]) != (want, want) \
                    or groups["means"]["adam_count"] != trainer.step:
                raise AssertionError(f"step {trainer.step}: Adam counts {groups} after an opacity reset")
    overflow = []
    for idx in range(SPLAT_IMAGES):
        images = trainer.render_image(idx)
        overflow.append(int(images["raster_overflow"]))
        if not all(np.isfinite(v).all() for v in images.values()) or images["rgb"].shape != (h, w, 3):
            raise AssertionError(f"refined splat image {idx}: not finite, or shape {images['rgb'].shape}")
    launches = dict(backend.launch_counts)
    del trainer.refine
    want = dict(composite_fwd=REFINE_STEPS + SPLAT_IMAGES, composite_bwd=REFINE_STEPS, packed_rows_bwd=REFINE_STEPS)
    print(f"splat refine launches {launches}, expected {want}")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError("the refining splat path did not go through the compositing kernels")
    for r in refines:
        print(f"splat refine at step {r['step']}: num_split {r['num_split']}, num_dup {r['num_dup']}, "
              f"num_culled {r['num_culled']}, num_alive {r['num_alive']}, touched {r['touched']}, "
              f"budget capped {r['num_budget_capped']}, dropped {r['num_dropped_capacity']}, "
              f"non-finite {r['num_nonfinite']}; {1e3 * r['seconds']:.1f} ms on {name}")
    if [r["step"] for r in refines] != list(REFINES):
        raise AssertionError(f"refines at steps {[r['step'] for r in refines]}, expected {REFINES}")
    if not any(r["num_split"] and r["num_dup"] for r in refines):
        raise AssertionError("no refine both split and duplicated")
    for i, l in enumerate(losses):
        if not all(np.isfinite(v) for v in l.values()):
            raise AssertionError(f"refining step {i}: loss not finite {l}")
    for k, v in trainer.params.items():
        if not torch.isfinite(v).all() or torch.equal(v.detach(), start[k]):
            raise AssertionError(f"{k} not finite, or unchanged, after the refining steps")
    moved = float(trainer.camera_opt.detach().abs().max())
    if not moved > 0 or not torch.isfinite(trainer.camera_opt).all():
        raise AssertionError("the camera tangents did not move")
    cfg = trainer.config
    print(f"splat refine: tuned rasterize_capacity {cfg.rasterize_capacity}, row_capacity "
          f"{cfg.rasterize_row_capacity} (max {cfg.rasterize_capacity_max}); raster_overflow per image "
          f"{overflow}; camera tangents up to {moved:.3e}; {int(trainer.splat_state.alive.sum())} alive")
    if cfg.rasterize_capacity < cfg.rasterize_capacity_max and any(overflow):
        raise AssertionError("an image at a probed camera overflowed the tuned capacity")
    for i, (t, l) in enumerate(zip(step_s, losses)):
        if i < 3 or i + 1 in REFINES + RESETS or i + 2 in RESETS:
            print(f"splat refining step {i + 1}: {1e3 * t:.1f} ms/step on {name}, total_loss "
                  f"{l['total_loss']:.4f}")
    print(f"splat refining steps: median {1e3 * float(np.median(step_s)):.1f} ms/step, steps that "
          f"refine {', '.join(f'{1e3 * step_s[s - 1]:.1f}' for s in REFINES)} ms on {name}")

    # the first refine again on the CPU, from the same state and draws
    params, state = replay["before"]
    cpu_params, cpu_state, cpu_info = sf.refine_gaussians(
        params, state, replay["config"], replay["step"], scene_extent=trainer.scene_extent, eps=replay["eps"])
    card_params, card_state = replay["after"]
    card_info = {k: v.cpu() for k, v in replay["info"].items()}
    card_splits, card_dups, card_capped = replay["decisions"]
    cpu_splits, cpu_dups, cpu_capped = sf.refine_decisions(params, state, replay["config"], replay["step"],
                                                           trainer.scene_extent)
    masks = dict(touched_slots=(card_info["touched_slots"], cpu_info["touched_slots"]),
                 splits=(card_splits, cpu_splits), dups=(card_dups, cpu_dups),
                 alive=(card_state.alive, cpu_state.alive))
    differ = {k: int((a != b).sum()) for k, (a, b) in masks.items()}
    counts = {k: (int(card_info[k]), int(cpu_info[k])) for k in card_info if k != "touched_slots"}
    # the decisions taken before a refine are the ones it counted
    counts.update(splits_admitted=(int(card_splits.sum()), int(card_info["num_split"])),
                  dups_admitted=(int(card_dups.sum()), int(card_info["num_dup"])),
                  capped=(int(card_capped), int(cpu_capped)))
    err = {k: float((card_params[k] - cpu_params[k]).abs().max()) for k in cpu_params}
    print(f"splat refine at step {replay['step']} replayed on the CPU: masks differing {differ}; counts "
          f"(card, CPU) {counts}; max_abs_err " + ", ".join(f"{k} {v:.2e}" for k, v in err.items()))
    if any(differ.values()) or any(a != b for a, b in counts.values()):
        raise AssertionError("the CPU replay of a refine took other decisions than the card")
    if not all(torch.allclose(card_params[k], cpu_params[k], **TOL) for k in cpu_params):
        raise AssertionError("the CPU replay of a refine is not within TOL of the card's")

    # K2 and K3 at the tuned capacity, where the refining steps launched
    # them, against their plain versions, then timed
    gen = torch.Generator(device=trainer.device).manual_seed(SEED + 11)
    tiles = scene_tiles(trainer, gen)[:3]
    check = compare_composite("splat refine, tuned capacity", *tiles, gen, exact=False)
    if not check["ok"]:
        raise AssertionError("composite at the tuned capacity: a kernel disagrees with its plain version")
    tuned = composite_times("splat refine, tuned capacity", *tiles, gen)
    tuned.update(fwd_err=check["fwd_err"], bwd_err=check["bwd_err"])
    del check, tiles
    gather = check_packed_rows("at the tuned capacity", capture_gather(trainer), gen,
                               capture_gather(trainer, cam_idx=3), other)
    symbols = {"composite_fwd": "composite_fwd_kernel", "composite_bwd": "composite_bwd_kernel"}
    t0 = time.perf_counter()
    grew = trainer.retune_capacity()  # ends in the probes' copies to the host
    print(f"splat retune, {len(trainer.cameras)} probe cameras: {1e3 * (time.perf_counter() - t0):.1f} ms "
          f"on {name} (grew: {grew})")
    profile_top("splat retune", trainer.retune_capacity, symbols, top=8)
    profile_top("splat refining phase train step", trainer.train_step,
                dict(symbols, packed_rows_bwd=PACKED_ROWS_SYMBOL))
    profile_top("splat refine", lambda: sf.refine_gaussians(
        trainer.params, trainer.splat_state, cfg, REFINES[-1], scene_extent=trainer.scene_extent,
        generator=trainer._generator), symbols, top=10)
    return dict(launches=launches, refines=refines, step_s=step_s, replay_err=err, tuned=tuned,
                capacity=cfg.rasterize_capacity, row_capacity=cfg.rasterize_row_capacity, overflow=overflow,
                gather=gather, repeatable=repeatable)


# -- the splat deep ensemble ---------------------------------------------------

SPLAT_MEMBERS = 5


def run_splat_ensemble(device, name, other=None) -> dict:
    """Five members (the splat scene from numpy seeds 0-4, each with its own
    alive mask) at eval budgets probed on the cameras (``"auto"``), through
    ``build_ensemble_splat_render_cam``: K2 five times an image; one image
    against the plain path; five copies of member 0 against its single
    render (epistemic variance 0); ``get_average_uncertainty_metrics`` over
    two images (finite metrics, the JSON written); K2 and K3 against their
    plain versions on member 0's packed tiles at the eval capacity, and K2
    timed there; the packed-row backward checked there (``check_packed_rows``,
    with ``other``'s in turns where given); an image timed on the host clock
    and profiled."""
    import tempfile

    from uncertainty_nerf_gs_torch.eval.evaluator import (
        EvalOptions,
        get_average_uncertainty_metrics,
        write_benchmark_json,
    )
    from uncertainty_nerf_gs_torch.ops import backend
    from uncertainty_nerf_gs_torch.scripts.eval_uncertainty import (
        _apply_raster_capacity,
        build_ensemble_splat_render_cam,
        build_splat_render_fn,
    )

    t0 = time.perf_counter()
    trainers = [build_splat(device, member=m) for m in range(SPLAT_MEMBERS)]
    cams = trainers[0].cameras
    h, w = cams.height, cams.width
    _apply_raster_capacity(trainers, cams, "auto")
    render_cam = build_ensemble_splat_render_cam(trainers, w, h)

    def render(i):
        return render_cam(*trainers[0].camera(i))

    print(f"splat ensemble: {SPLAT_MEMBERS} members, live Gaussians "
          f"{[int(t.splat_state.alive.sum()) for t in trainers]}; set-up {time.perf_counter() - t0:.1f} s")
    backend.reset_launch_counts()
    kern = render(1)
    torch.cuda.synchronize()
    launches = dict(backend.launch_counts)
    backend.reset_launch_counts()
    with backend.plain_versions():
        plain = render(1)
    if any(backend.launch_counts.values()):
        raise AssertionError(f"kernels launched inside plain_versions(): {backend.launch_counts}")
    print(f"splat ensemble image launches {launches}, expected composite_fwd {SPLAT_MEMBERS}")
    if launches["composite_fwd"] != SPLAT_MEMBERS or launches["composite_bwd"]:
        raise AssertionError("the splat ensemble did not launch K2 once a member")
    out_err = {}
    for k, v in kern.items():
        out_err[k] = float((v - plain[k]).abs().max())
        if not torch.isfinite(v).all() or not torch.allclose(v, plain[k], **SPLAT_OUTPUT_TOLS.get(k, SPLAT_FWD_TOL)):
            raise AssertionError(f"splat ensemble: {k} differs from the plain path by {out_err[k]:.3e}")
    print("splat ensemble plain path: max_abs_err " + ", ".join(f"{k} {v:.2e}" for k, v in out_err.items()))

    same = build_ensemble_splat_render_cam([trainers[0]] * SPLAT_MEMBERS, w, h)(*trainers[0].camera(1))
    single = build_splat_render_fn(trainers[0], cams)(1)
    compared = ("rgb", "depth", "accumulation", "rgb_std")
    same_err = {k: float((same[k] - single[k]).abs().max()) for k in compared}
    epi = {k: float(same[k].abs().max()) for k in ("rgb_var_epi", "depth_var_epi")}
    print(f"splat ensemble of identical members against the single model: max_abs_err {same_err}, "
          f"epistemic variance up to {epi}")
    # the members' mean rounds once: within an ulp or two of the single render
    if not all(torch.allclose(same[k], single[k], rtol=1e-6, atol=1e-6) for k in compared) \
            or max(epi.values()) > 1e-10:
        raise AssertionError("identical splat members differ from the single model")

    rng = np.random.default_rng(SEED + 9)
    gts = [np.clip(render(1 - i)["rgb"].cpu().numpy() + rng.normal(0, 0.05, (h, w, 3)), 0, 1).astype(np.float32)
           for i in range(2)]
    keys = ("psnr", "ssim", "lpips_rand", "nll_rgb", "rgb_ause_mae", "rgb_ause_mse", "rgb_ause_rmse",
            "rgb_auce_abs", "rgb_auce_length", "rgb_auce_neg", "num_rays_per_sec")
    opts = EvalOptions(experiment_name="chip_smoke", method_name="active-splatfacto-ensemble")
    backend.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        res = get_average_uncertainty_metrics(render, gts, opts)["results"]
        write_benchmark_json(Path(tmp) / "splat.json", res, opts)
        if json.loads((Path(tmp) / "splat.json").read_text())["results"].keys() != res.keys():
            raise AssertionError("the benchmark JSON lost results")
    eval_launches = dict(backend.launch_counts)
    print(f"splat ensemble evaluation launches {eval_launches}, expected composite_fwd {3 * SPLAT_MEMBERS}")
    print(f"splat ensemble metrics on {name}: " + ", ".join(f"{k} {res[k]:.6g}" for k in keys))
    if eval_launches["composite_fwd"] != 3 * SPLAT_MEMBERS:
        raise AssertionError("the splat ensemble evaluation did not go through K2")
    if not all(np.isfinite(res[k]) for k in keys):
        raise AssertionError("the splat ensemble evaluation gave a metric that is not finite")

    # K2 (and K3) at the eval capacity on member 0's packed tiles against
    # their plain versions; K2 timed there
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    tiles = scene_tiles(trainers[0], gen)[:3]
    check = compare_composite("splat ensemble member 0, eval capacity", *tiles, gen, exact=False)
    if not check["ok"]:
        raise AssertionError("composite at the eval capacity: a kernel disagrees with its plain version")
    k2 = composite_times("splat ensemble member 0, eval capacity", *tiles, gen, backward=False)["fwd"]
    k2.update(fwd_err=check["fwd_err"], bwd_err=check["bwd_err"])
    del check, tiles
    # the gather's backward at the eval capacity, on a step of member 0
    gather = check_packed_rows("at the eval capacity", capture_gather(trainers[0]), gen,
                               capture_gather(trainers[0], cam_idx=3), other)

    seconds = []
    for _ in range(5):
        t0 = time.perf_counter()
        render(1)["rgb"].cpu()
        seconds.append(time.perf_counter() - t0)
    print(f"splat ensemble image 1: " + ", ".join(f"{1e3 * s:.1f}" for s in seconds)
          + f" ms/image, median {1e3 * float(np.median(seconds)):.1f} ms on {name}")
    profile_top("splat ensemble image 1", lambda: render(1)["rgb"].cpu(),
                {"composite_fwd": "composite_fwd_kernel"}, top=10)
    return dict(launches=launches, eval_launches=eval_launches, out_err=out_err, results=res, seconds=seconds,
                capacity=trainers[0].config.rasterize_capacity, k2=k2, gather=gather)


# -- the deep ensemble at full width: K6 ---------------------------------------

NUM_MEMBERS = 5
MAIN_STRIDE_SCALE = 8.0  # the JAX package's experiments' choice (experiments/jobs/205_stage_ablation_int8.py:60)
# per (sample, level): locating the cell and its weights, then 8 corners x F
# features x M members, a product and an add each
K6_OPS = lambda f, m: 25 + 16 * f * m  # noqa: E731
# per (sample, strided level): the lerp weight (two subtractions, a max, a
# division, a clamp), then two products and an add per member and feature
K6_LERP_OPS = lambda f, m: 6 + 3 * f * m  # noqa: E731
K6_SYMBOL = "packed_lookup_fwd_kernel"
K6S_SYMBOL = "packed_lookup_strided_kernel"
ENSEMBLE_SYMBOLS = {"pdf_resample": "pdf_resample_kernel", "cell_lookup_fwd": "cell_lookup_fwd_kernel",
                    "packed_cell_lookup_fwd": K6_SYMBOL, "packed_cell_lookup_strided": K6S_SYMBOL}
# a fused chunk's launches: the two proposals' strided lookups and the field's
FUSED_PLAN = dict(pdf_resample=2, packed_cell_lookup_fwd=1, packed_cell_lookup_strided=2, cell_lookup_fwd=0)
PER_MEMBER_PLAN = dict(pdf_resample=2 * NUM_MEMBERS, cell_lookup_fwd=3 * NUM_MEMBERS, packed_cell_lookup_fwd=0,
                       packed_cell_lookup_strided=0)


def build_ensemble(device, size=256):
    """bench.py::bench_ensemble_render's model (bench.py:166-187) at full
    width: nerfacto defaults with the aleatoric head, 8 images, near 0.5, far
    6, white background, no appearance embedding; hash proposals, 16 levels
    x 2^19 cells, 256 -> 96 -> 48 samples; float32 MLPs (the bf16 path is not
    ported). Five members drawn by ``interop.draw_params`` with numpy seeds
    0-4, stacked on the card (``interop.stack_params``' layout), and two
    cameras from ``hemisphere_cameras``. Models, not trainers: no Adam
    state."""
    from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras
    from uncertainty_nerf_gs_torch.interop import draw_params, params_from_jax, params_to_jax
    from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig, NerfactoModel

    cfg = NerfactoConfig(num_images=8, uncertainty_channels=1, near_plane=0.5, far_plane=6.0,
                         background_color="white", use_appearance_embedding=False)
    model = NerfactoModel(cfg, device=device)
    like = params_to_jax(model.state_dict())
    stacked: dict[str, torch.Tensor] = {}
    for j in range(NUM_MEMBERS):
        for k, v in params_from_jax(draw_params(like, np.random.default_rng(j))).items():
            if k not in stacked:
                stacked[k] = torch.empty((NUM_MEMBERS,) + v.shape, dtype=v.dtype, device=device)
            stacked[k][j].copy_(v)
    return model, stacked, hemisphere_cameras(2, size, size)


def ensemble_fields(cfg) -> list[tuple]:
    """(name, resolutions, table size, F, samples per ray) of the three
    packed tables, as ``pack_ensemble_tables`` builds them."""
    from uncertainty_nerf_gs_torch.ops.encodings import hash_grid_resolutions
    from uncertainty_nerf_gs_torch.parallel.ensemble_fused import _PROP_FEATS, _prop_grid_spec

    out = []
    for i in range(len(cfg.proposal_net_args)):
        res, table = _prop_grid_spec(cfg, i)
        out.append((f"proposal_{i}", tuple(int(r) for r in res), table, _PROP_FEATS,
                    cfg.num_proposal_samples[i]))
    res = hash_grid_resolutions(cfg.num_levels, cfg.base_res, cfg.max_res)
    out.append(("field", tuple(int(r) for r in res), 2**cfg.log2_hashmap_size, cfg.features_per_level,
                cfg.num_nerf_samples))
    return out


def k6_plan(cfg) -> dict[str, list[int]]:
    """Per proposal, the anchor stride of each level at its sample count: the
    fused render's K6 launches a chunk are one strided call a proposal and
    one dense call for the field."""
    from uncertainty_nerf_gs_torch.ops.encodings import anchor_stride

    return {name: [anchor_stride(spr, r) for r in res]
            for name, res, _, _, spr in ensemble_fields(cfg)[:-1]}


@contextlib.contextmanager
def record_k6():
    """Every K6 launch inside the block, in launch order: dicts with the
    entry (``kind`` "dense" or "strided") and its inputs (the positions and
    t_mid copied)."""
    from uncertainty_nerf_gs_torch.ops import encodings as enc

    calls, dense, strided = [], enc.packed_cell_lookup_fwd, enc.packed_cell_lookup_strided_fwd

    def record_dense(packed, positions, resolutions, table_size, scales=None):
        calls.append(dict(kind="dense", packed=packed, pos=positions.clone(), res=tuple(resolutions),
                          table=table_size, scales=scales))
        return dense(packed, positions, resolutions, table_size, scales)

    def record_strided(packed, positions, t_mid, resolutions, table_size, strides, scales=None):
        calls.append(dict(kind="strided", packed=packed, pos=positions.clone(), t=t_mid.clone(),
                          res=tuple(resolutions), table=table_size, strides=tuple(strides), scales=scales))
        return strided(packed, positions, t_mid, resolutions, table_size, strides, scales)

    enc.packed_cell_lookup_fwd, enc.packed_cell_lookup_strided_fwd = record_dense, record_strided
    try:
        yield calls
    finally:
        enc.packed_cell_lookup_fwd, enc.packed_cell_lookup_strided_fwd = dense, strided


def k6_call(c, other=None):
    """K6 on a recorded call: this checkout's entry, or ``other``'s (``other_k4``)."""
    from uncertainty_nerf_gs_torch.ops import encodings as enc

    if other is not None:
        if c["kind"] == "dense":
            return other.k6(c["packed"], c["pos"], c["res"], c["table"])
        return other.k6_strided(c["packed"], c["pos"], c["t"], c["res"], c["table"], c["strides"])
    if c["kind"] == "dense":
        return enc.packed_cell_lookup_fwd(c["packed"], c["pos"], c["res"], c["table"], c.get("scales"))
    return enc.packed_cell_lookup_strided_fwd(c["packed"], c["pos"], c["t"], c["res"], c["table"], c["strides"],
                                              c.get("scales"))


def k6_plain(c):
    """The plain version of a recorded K6 call."""
    from uncertainty_nerf_gs_torch.ops import encodings as enc

    if c["kind"] == "dense":
        return enc.packed_cell_lookup_reference(c["packed"], c["pos"], c["res"], c["table"], c.get("scales"))
    return enc.packed_cell_lookup_strided_reference(c["packed"], c["pos"], c["t"], c["res"], c["table"],
                                                    c["strides"], c.get("scales"))


def k6_levels(c) -> tuple[list, list[int]]:
    """(per-level packed tables, per-level cell counts) of a recorded K6
    call: a stacked tensor and one size, or per-level lists (hybrid)."""
    from uncertainty_nerf_gs_torch.ops.encodings import _per_level_tables

    return _per_level_tables(c["packed"], c["table"], len(c["res"]))


def k6_lookups(c) -> list[torch.Tensor]:
    """Per level, the cells of the lookups the call's function needs: every
    sample's at a dense level, the anchors' at a strided one (K > 1)."""
    from uncertainty_nerf_gs_torch.ops.encodings import cell_indices

    out = []
    _, sizes = k6_levels(c)
    for lvl, r in enumerate(c["res"]):
        k = c["strides"][lvl] if c["kind"] == "strided" else 1
        pos = c["pos"].reshape(-1, 3)
        if k > 1:
            s = c["pos"].shape[1]
            na = (s - 1) // k + 2
            idx = torch.clamp(torch.arange(na, device=pos.device) * k, max=s - 1)
            pos = c["pos"][:, idx].reshape(-1, 3)
        out.append(cell_indices(pos, r, sizes[lvl])[0])
    return out


@contextlib.contextmanager
def record_edges():
    """The spacing edges of every ``sample_uniform``/``sample_pdf`` call of
    the fused render inside the block: its shared chain's sdist list."""
    from uncertainty_nerf_gs_torch.parallel import ensemble_fused as ef

    edges, saved = [], (ef.sample_uniform, ef.sample_pdf)

    def record(fn):
        def call(*args, **kwargs):
            rs = fn(*args, **kwargs)
            edges.append(rs.spacing_edges)
            return rs
        return call

    ef.sample_uniform, ef.sample_pdf = record(saved[0]), record(saved[1])
    try:
        yield edges
    finally:
        ef.sample_uniform, ef.sample_pdf = saved


def chunk_rays(cams, cam_idx, chunk_idx, chunk, device):
    """The rays of one eval chunk of camera ``cam_idx`` (the render's own
    chunking)."""
    from uncertainty_nerf_gs_torch.cameras.cameras import generate_rays, pixel_grid

    px, py = pixel_grid(cams.height, cams.width, device)
    sl = slice(chunk_idx * chunk, (chunk_idx + 1) * chunk)
    idx = torch.full((px[sl].shape[0],), cam_idx, dtype=torch.int64, device=device)
    return generate_rays(cams.to(device), idx, px[sl], py[sl])


def k6_bound_ms(c, lookups) -> tuple[float, str, int, int]:
    """Least time of one K6 call on its inputs: positions (and t_mid) read
    once, each distinct packed row that its lookups need once (8 M F
    elements of the rows' type: 4, 2 or 1 bytes), the whole (M, n, L F)
    float32 output written once; or its float operations, the lerp's at the
    strided levels included. Returns (ms, bound_by, bytes, operations)."""
    tables, _ = k6_levels(c)
    levels, (_, _, m, f) = len(tables), tables[0].shape
    n = c["pos"].numel() // 3
    strided = c["kind"] == "strided"
    unique = sum(int(torch.unique(ix).numel()) for ix in lookups)
    nbytes = (12 + 4 * strided) * n + unique * 8 * m * f * tables[0].element_size() + 4 * m * n * levels * f
    ops = sum(ix.numel() for ix in lookups) * K6_OPS(f, m)
    if strided:
        ops += n * sum(k > 1 for k in c["strides"]) * K6_LERP_OPS(f, m)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations"), nbytes, ops


def k6_times(label, calls, other=None) -> dict:
    """K6 and its plain version per call over ``calls`` (recorded calls of
    one entry with the same shapes), beside the bound of the first call's
    lookups and ``index_select`` of the same packed rows (the yardstick; the
    port never calls it). With ``other`` (``other_k4``), that checkout's K6
    (where it has no strided entry, its K6 a level and the lerp as PyTorch
    ops) is held equal to the plain version and timed in turns with this
    one, every device kernel of a call counted: other, this, this, other."""
    c0 = calls[0]
    packed, sizes = k6_levels(c0)
    levels, (_, _, m, f) = len(packed), packed[0].shape
    n = c0["pos"].numel() // 3
    sets = [(c,) for c in calls]
    symbol = K6_SYMBOL if c0["kind"] == "dense" else K6S_SYMBOL
    tm = kernel_times(f"K6 {label}", k6_call, k6_plain, sets, symbol)
    lookups = [k6_lookups(c) for c in calls]
    library_ms = time_ms(lambda ix: [packed[l].index_select(0, ix[l]) for l in range(levels)],
                         [[ix] for ix in lookups])
    bound, bound_by, nbytes, ops = k6_bound_ms(c0, lookups[0])
    n_lookups = sum(ix.numel() for ix in lookups[0])
    dtype = str(packed[0].dtype).replace("torch.", "")
    tm.update(label=label, kind=c0["kind"], dtype=dtype,
              shape=[n, levels, m, f, c0["table"] if isinstance(c0["table"], int) else list(sizes)],
              bound_ms=bound, bound_by=bound_by, bytes=nbytes, operations=ops, lookups=n_lookups,
              library_ms=library_ms, strides=list(c0.get("strides", [1] * levels)))
    print(f"K6 {label} ({c0['kind']}, {dtype}, {n} samples x {levels} levels x {m} members, F={f}, strides "
          f"{'/'.join(map(str, tm['strides']))}): kernel {tm['ms']:.4f} ms on the device ({tm['event_ms']:.4f} "
          f"ms a call back to back), plain {tm['plain_ms']:.4f} ms, bound {bound:.4f} ms ({bound_by}: "
          f"{nbytes / 1e6:.1f} MB, {n_lookups} lookups); index_select of the same rows, {levels} calls, "
          f"{library_ms:.4f} ms")
    if other is not None:
        for c in calls:
            if not torch.equal(k6_call(c, other), k6_plain(c)):
                raise AssertionError(f"K6 {label}: the other K6 differs from the plain version")
        runs = dict(other=lambda c: k6_call(c, other), this=k6_call)
        tm["turns_ms"] = turns = dict(other=[], this=[])
        for version in ("other", "this", "this", "other"):
            turns[version].append(device_ms(runs[version], sets, ""))
        print(f"K6 {label} in turns (every device kernel of a call): " + ", ".join(
            f"{v} {' / '.join(f'{t:.4f}' for t in ts)} ms" for v, ts in turns.items()))
    return tm


def ray_inputs(rays, samples, gen, device):
    """(rays, samples, 3) positions along rays through the unit cube at
    sorted t_mid (rays, samples), as a render chunk's proposal samples lie,
    with the first ray's first two samples at one t."""
    t = torch.sort(torch.rand(rays, samples, generator=gen, device=device), dim=1).values
    t[0, 1] = t[0, 0]
    origins = torch.rand(rays, 1, 3, generator=gen, device=device) * 0.4 + 0.3
    dirs = torch.nn.functional.normalize(torch.randn(rays, 1, 3, generator=gen, device=device), dim=-1)
    return (origins + 0.3 * dirs * t[..., None]).clamp(0, 1).contiguous(), t


def check_k6(model, stacked, packed, device, other=None) -> dict:
    """K6 against its plain version, bit for bit, at M = 5 and the three
    fields' full-width shapes (4,096 rays x 256 / 96 / 48 samples, 5 / 5 /
    16 levels), a ragged count, M = 1 and M = 3, F = 1 and F = 4; K6's
    member m against K4 on member m's own table, bit for bit, at the three
    shapes; the strided entry at the proposals' full-width shapes with their
    strides and at the field's with MAIN_STRIDE_SCALE. Times at the three
    shapes at uniform positions (with ``other``, that K6 in turns)."""
    from uncertainty_nerf_gs_torch.ops import encodings as enc

    cfg = model.config
    rays = cfg.eval_num_rays_per_chunk
    failed, err, times = [], 0.0, {}

    def hold(label, c, cells=None):
        nonlocal err
        got, want = k6_call(c), k6_plain(c)
        differ = int((got != want).sum())
        err = max(err, (got - want).abs().max().item())
        pk = c["packed"]
        line = f"K6 {label} ({c['kind']}) n={c['pos'].numel() // 3} L={len(c['res'])} M={pk.shape[3]} " \
               f"F={pk.shape[4]}: {differ} of {got.numel()} features differ from the plain version's bits"
        if differ or not torch.isfinite(got).all():
            failed.append(f"{label}: K6 differs from its plain version")
        if cells is not None:
            f = pk.shape[4]
            k4 = sum(int((enc.cell_lookup_fwd(cells[j], c["pos"], c["res"], c["table"], f) != got[j]).sum())
                     for j in range(pk.shape[3]))
            line += f"; {k4} differ from {pk.shape[3]} K4 launches on the members' own tables"
            if k4:
                failed.append(f"{label}: K6 differs from K4 on the members' tables")
        print(line)

    def dense(pk, pos, res, table):
        return dict(kind="dense", packed=pk, pos=pos, res=tuple(res), table=table)

    plan = k6_plan(cfg)
    for i, (name, res, table, f, spr) in enumerate(ensemble_fields(cfg)):
        gen = torch.Generator(device=device).manual_seed(SEED + 300 + i)
        pos = lookup_positions(res, rays * spr, gen, device)
        cells = stacked[f"{name}.encoding.cells"]
        hold(name, dense(packed[name], pos, res, table), cells)
        sets = [dense(packed[name], pos, res, table),
                dense(packed[name], torch.rand(rays * spr, 3, generator=gen, device=device), res, table)]
        times[name] = k6_times(f"{name} uniform", sets, other)
        if name == "field":
            hold("ragged", dense(packed[name], lookup_positions(res, 1001, gen, device), res, table), cells)
        if name == "proposal_0":
            for m in (1, 3):
                sub = enc.pack_member_cell_tables(cells[:m], table, f)
                hold(f"{name} M={m}", dense(sub, pos, res, table), cells)
                del sub
        # the strided entry at the full-width shape: the proposals' strides,
        # the field's at MAIN_STRIDE_SCALE
        strides = plan.get(name) or [enc.anchor_stride(spr, r, MAIN_STRIDE_SCALE) for r in res]
        pos3, t = ray_inputs(rays, spr, gen, device)
        hold(f"{name} strided {'/'.join(map(str, strides))}",
             dict(kind="strided", packed=packed[name], pos=pos3, t=t, res=tuple(res), table=table,
                  strides=tuple(strides)))
    for f in (1, 4):
        gen = torch.Generator(device=device).manual_seed(SEED + 310 + f)
        res = tuple(int(r) for r in enc.hash_grid_resolutions(4, 16, 512))
        cells = torch.rand(NUM_MEMBERS, 4, 2**12 * 8 * f // 128, 128, generator=gen, device=device) * 4 - 2
        pk = enc.pack_member_cell_tables(cells, 2**12, f)
        hold(f"f{f}", dense(pk, lookup_positions(res, 777, gen, device), res, 2**12), cells)
        pos3, t = ray_inputs(33, 65, gen, device)
        hold(f"f{f} strided", dict(kind="strided", packed=pk, pos=pos3, t=t, res=res, table=2**12,
                                   strides=tuple(enc.anchor_stride(65, r, 4.0) for r in res)))
    if failed:
        raise AssertionError("K6 " + "; ".join(failed))
    return dict(err=err, times=times)


def check_k6_render_chunk(render, stacked, packed, rb) -> list[dict]:
    """K6 bit for bit against its plain version at every launch of a real
    fused render chunk (the proposals' strided calls and the field's).
    Returns the recorded calls."""
    with record_k6() as calls:
        render(stacked, packed, rb)
    differ = sum(int((k6_call(c) != k6_plain(c)).sum()) for c in calls)
    kinds = "/".join(c["kind"] for c in calls)
    print(f"K6 at a fused render chunk's {len(calls)} launches ({kinds}): {differ} features differ from "
          f"the plain version's bits")
    if differ:
        raise AssertionError("K6 differs from its plain version at a render chunk's positions")
    return calls


def ensemble_chunk_checks(model, stacked, packed, cams, device) -> dict:
    """One chunk of camera 1: the launch plan per chunk of the fused and the
    per-member render; each on the kernel path against the plain path
    (``plain_versions()``), every output bit for bit; five identical members
    (exact proposal lookups) against the single model within OUTPUT_TOLS
    on the rays that kept their cells; distinct members' epistemic variance
    above 0. The fused chunk also with the field strided
    (MAIN_STRIDE_SCALE): its plan and its plain path. Returns the captured
    K6 calls of two render chunks and of the field-strided chunk, each held
    bit for bit against its plain version."""
    from uncertainty_nerf_gs_torch.models import ensemble as ens
    from uncertainty_nerf_gs_torch.ops import backend
    from uncertainty_nerf_gs_torch.parallel.ensemble_fused import (
        build_fused_ensemble_render,
        pack_ensemble_tables,
    )

    cfg = model.config
    chunk = cfg.eval_num_rays_per_chunk
    middle = cams.height * cams.width // chunk // 2
    rb = chunk_rays(cams, 1, middle, chunk, device)
    fused = build_fused_ensemble_render(model)
    plan = k6_plan(cfg)
    print("fused render: anchor strides a proposal level " + ", ".join(
        f"{k} {'/'.join(map(str, v))}" for k, v in plan.items()))
    # the field strided too (main_stride_scale > 0): three strided K6 calls
    fused_main = build_fused_ensemble_render(model, main_stride_scale=MAIN_STRIDE_SCALE)
    want = {
        "fused": dict(FUSED_PLAN, cell_lookup_bwd=0),
        "per_member": dict(PER_MEMBER_PLAN, cell_lookup_bwd=0),
        "fused_main_stride": dict(FUSED_PLAN, packed_cell_lookup_fwd=0, packed_cell_lookup_strided=3,
                                  cell_lookup_bwd=0),
    }
    renders = {"fused": lambda: fused(stacked, packed, rb),
               "per_member": lambda: ens.ensemble_render(model, stacked, rb),
               "fused_main_stride": lambda: fused_main(stacked, packed, rb)}
    out = {}
    for mode, run in renders.items():
        backend.reset_launch_counts()
        kern = run()
        launches = {k: backend.launch_counts[k] for k in want[mode]}
        print(f"ensemble {mode} chunk launches {launches}, expected {want[mode]}")
        if launches != want[mode]:
            raise AssertionError(f"the {mode} ensemble chunk did not launch its plan")
        backend.reset_launch_counts()
        with backend.plain_versions():
            plain = run()
        if any(backend.launch_counts.values()):
            raise AssertionError(f"kernels launched inside plain_versions(): {backend.launch_counts}")
        differ = bits_differ(kern, plain)
        print(f"ensemble {mode} chunk, kernel path against plain path: {sum(differ.values())} output "
              "entries not bit-identical" + "".join(f", {k} {v}" for k, v in differ.items() if v))
        if sum(differ.values()):
            raise AssertionError(f"the {mode} ensemble's kernel and plain paths disagree")
        out[mode] = kern
    epi = out["fused"]["rgb_var_epi"]
    print(f"distinct members: fused rgb_var_epi mean {epi.mean().item():.3e}, max {epi.max().item():.3e}; "
          f"per-member {out['per_member']['rgb_var_epi'].mean().item():.3e}")
    if not (epi.mean() > 0 and out["per_member"]["rgb_var_epi"].mean() > 0):
        raise AssertionError("distinct members gave no epistemic variance")
    diff = (out["fused"]["rgb"] - out["per_member"]["rgb"]).abs()
    print(f"fused against per-member rgb: mean abs {diff.mean().item():.3e}, max {diff.max().item():.3e}")

    # five identical members with exact proposal lookups (the anchor stride
    # lerps the coarse levels, which the single model does not): the shared
    # chain is each member's own, and the fused render the single model's
    same = {k: v[:1].expand((NUM_MEMBERS,) + v.shape[1:]) for k, v in stacked.items()}
    packed_same = pack_ensemble_tables(model, same)
    with record_edges() as edges:
        fused_same = build_fused_ensemble_render(model, proposal_anchor_stride=False)(same, packed_same, rb)
    del packed_same
    single = ens.member_apply(model, ens.member_params(stacked, 0),
                              lambda mdl, r: mdl(r, use_average_appearance=True, return_intermediates=True), rb)
    flipped = (model.lookup_cells(rb, edges) != model.lookup_cells(rb, single["sdist_list"])).any(dim=1)
    bad = torch.zeros_like(flipped)
    for k, tol in OUTPUT_TOLS.items():
        bad |= (~torch.isclose(fused_same[k], single[k], **tol)).reshape(chunk, -1).any(dim=1)
    epi_same = fused_same["rgb_var_epi"].max().item()
    print(f"five identical members against the single model: {int(flipped.sum())} of {chunk} rays flipped "
          f"a cell, {int((bad & ~flipped).sum())} others outside OUTPUT_TOLS; rgb_var_epi max {epi_same:.3e}")
    if (bad & ~flipped).any() or flipped.float().mean() > MAX_FLIPPED_RAY_SHARE:
        raise AssertionError("five identical members do not give the single model's render")

    calls = [check_k6_render_chunk(fused, stacked, packed, chunk_rays(cams, 1, c, chunk, device))
             for c in (middle, middle + 1)]
    main_calls = check_k6_render_chunk(fused_main, stacked, packed, rb)
    return dict(render_calls=calls, main_stride_calls=main_calls, plan=plan)


def ensemble_images(model, stacked, cams, device, name) -> dict:
    """The eval path as a user drives it: ``build_ensemble_chunk_fn`` (fused
    and per member) through ``_nerfacto_full_image_renderer`` into
    ``get_average_uncertainty_metrics`` over two images, then
    ``write_benchmark_json`` into a temporary directory; launches counted
    over each evaluation and held to the plan; the metrics finite. The GT of
    image i is the per-member render of the other camera plus numpy-seeded
    noise. Then each mode's image under the profiler and its host-clock
    time."""
    import tempfile

    from uncertainty_nerf_gs_torch.eval.evaluator import (
        EvalOptions,
        get_average_uncertainty_metrics,
        write_benchmark_json,
    )
    from uncertainty_nerf_gs_torch.ops import backend
    from uncertainty_nerf_gs_torch.scripts.eval_uncertainty import (
        _nerfacto_full_image_renderer,
        build_ensemble_chunk_fn,
    )

    cfg = model.config
    renders = {mode: _nerfacto_full_image_renderer(
        cfg, build_ensemble_chunk_fn(model, stacked, table_dtype="f32", ensemble_mode=mode), cams, device)
        for mode in ("fused", "per_member")}
    rng = np.random.default_rng(SEED + 8)
    gts = [np.clip(renders["per_member"](1 - i)["rgb"].cpu().numpy()
                   + rng.normal(0, 0.05, (cams.height, cams.width, 3)), 0, 1).astype(np.float32)
           for i in range(2)]
    chunks = -(-cams.height * cams.width // cfg.eval_num_rays_per_chunk)
    per_chunk = {"fused": FUSED_PLAN, "per_member": PER_MEMBER_PLAN}
    keys = ("psnr", "ssim", "lpips_rand", "nll_rgb", "rgb_ause_mae", "rgb_ause_mse", "rgb_ause_rmse",
            "rgb_auce_abs", "rgb_auce_length", "rgb_auce_neg", "num_rays_per_sec")
    out = {"launches": {}, "results": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for mode, render in renders.items():
            opts = EvalOptions(experiment_name="chip_smoke", method_name=f"active-nerfacto-ensemble-{mode}",
                               approximations={"table_dtype": "f32", "ensemble_mode": mode,
                                               "proposal_anchor_stride": mode == "fused"})
            backend.reset_launch_counts()
            res = get_average_uncertainty_metrics(render, gts, opts)["results"]
            launches = dict(backend.launch_counts)
            renders_run = 3 * chunks  # a warm-up render, then the two images
            want = {k: v * renders_run for k, v in per_chunk[mode].items()}
            print(f"ensemble {mode} evaluation launches {launches}, expected {want} "
                  f"({renders_run} chunks)")
            if any(launches[k] != v for k, v in want.items()) or launches["cell_lookup_bwd"]:
                raise AssertionError(f"the {mode} evaluation did not go through its kernels")
            print(f"ensemble {mode} metrics on {name}: " + ", ".join(f"{k} {res[k]:.6g}" for k in keys))
            if not all(np.isfinite(res[k]) for k in keys):
                raise AssertionError(f"the {mode} evaluation gave a metric that is not finite")
            write_benchmark_json(Path(tmp) / f"{mode}.json", res, opts)
            written = json.loads((Path(tmp) / f"{mode}.json").read_text())
            if written["results"].keys() != res.keys():
                raise AssertionError("the benchmark JSON lost results")
            out["launches"][mode], out["results"][mode] = launches, res
    # image 1 of each mode on the host clock, in turns: fused, per member,
    # per member, fused, three times
    times = {mode: [] for mode in renders}
    for _ in range(3):
        for mode in ("fused", "per_member", "per_member", "fused"):
            t0 = time.perf_counter()
            renders[mode](1)["rgb"].cpu()
            times[mode].append(time.perf_counter() - t0)
    for mode, render in renders.items():
        seconds = times[mode]
        print(f"ensemble {mode} image 1 in turns: " + ", ".join(f"{1e3 * s:.1f}" for s in seconds)
              + f" ms/image; median {1e3 * float(np.median(seconds)):.1f} ms, "
              f"{cams.height * cams.width / float(np.median(seconds)):.0f} rays/s on {name}")
        backend.reset_launch_counts()
        traced = profile_top(f"ensemble {mode} image 1", lambda: render(1)["rgb"].cpu(), ENSEMBLE_SYMBOLS)
        seen = {k: sum(c for name_, (c, _) in traced.items() if sym in name_)
                for k, sym in ENSEMBLE_SYMBOLS.items()}
        print(f"  the profile traced {seen} of the port's launches {dict((k, backend.launch_counts[k]) for k in seen)}")
    out["seconds"] = times
    return out


def run_ensemble(device, name, other=None) -> dict:
    from uncertainty_nerf_gs_torch.parallel.ensemble_fused import pack_ensemble_tables

    t0 = time.perf_counter()
    model, stacked, cams = build_ensemble(device)
    packed = pack_ensemble_tables(model, stacked)
    gb = lambda ts: sum(t.numel() * t.element_size() for t in ts) / 1e9  # noqa: E731
    print(f"ensemble: {NUM_MEMBERS} members, {gb(stacked.values()):.2f} GB of member parameters, "
          f"{gb(packed.values()):.2f} GB of packed tables ({gb([packed['field']]):.2f} GB the field's); "
          f"set-up {time.perf_counter() - t0:.1f} s")
    k6 = check_k6(model, stacked, packed, device, other)
    chunk = ensemble_chunk_checks(model, stacked, packed, cams, device)
    # a fused chunk's launches at a render chunk's positions, each over the
    # two chunks' inputs; then the field strided
    k6["render"] = [k6_times(f"render chunk launch {i}", [c[i] for c in chunk["render_calls"]], other)
                    for i in range(len(chunk["render_calls"][0]))]
    k6["main_stride"] = k6_times("field strided at a render chunk's positions", chunk["main_stride_calls"][-1:])
    per = k6["render"]
    turns = "".join(f", {v} {sum(min(t['turns_ms'][v]) for t in per):.4f}-"
                    f"{sum(max(t['turns_ms'][v]) for t in per):.4f} ms in turns (every device kernel)"
                    for v in ("other", "this") if other is not None)
    print(f"a fused chunk's {len(per)} K6 launches at a render chunk's positions: "
          f"{sum(t['ms'] for t in per):.4f} ms{turns}, plain {sum(t['plain_ms'] for t in per):.4f} ms, bound "
          f"{sum(t['bound_ms'] for t in per):.4f} ms, index_select {sum(t['library_ms'] for t in per):.4f} ms")
    del packed
    images = ensemble_images(model, stacked, cams, device, name)
    return dict(k6=k6, plan=chunk["plan"], **images)


# -- the joint ensemble step, its per-member render and the mesh forms -------

ENS_TRAIN_K = 50  # steps a launch, the CLI's default
ENS_EAGER_STEPS = 2
# a joint step's launches: per member one training step's
ENS_STEP_PLAN = dict(pdf_resample=2 * NUM_MEMBERS, cell_lookup_fwd=3 * NUM_MEMBERS,
                     cell_lookup_bwd=3 * NUM_MEMBERS)
ENS_TRAIN_SYMBOLS = {k: NERF_SYMBOLS[k] for k in ("pdf_resample", "cell_lookup_fwd", "cell_lookup_bwd")}
# a parameter's bytes beside a member: the weight, its gradient, Adam's two moments
ENS_MEMBER_BYTES_PER_PARAM = 16


def build_ensemble_train(device):
    """Five active-nerfacto members at the method's width (``configs/
    methods.py:62-68``: 16 x 2^19 main grid, two 5-level proposals, 256 ->
    96 -> 48 samples), as ``init_ensemble_params`` draws them (seeds 0-4),
    without the camera optimizer (the joint step has none), on 4 cameras of
    256x256 with numpy-seeded images."""
    from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras
    from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig, NerfactoModel
    from uncertainty_nerf_gs_torch.parallel.ensemble_parallel import init_ensemble_params

    cfg = NerfactoConfig(uncertainty_channels=1, num_images=4, background_color="white")
    cams = hemisphere_cameras(4, 256, 256)
    images = np.random.default_rng(SEED).uniform(size=(4, 256, 256, 3)).astype(np.float32)
    return cfg, NerfactoModel(cfg, device=device), cams, images, init_ensemble_params(cfg, NUM_MEMBERS, SEED, device)


def ensemble_batches(images, k, gen) -> dict[str, torch.Tensor]:
    """``k`` batches of NERF_RAYS pixels drawn uniformly, stacked on a
    leading axis, on the card."""
    n, h, w = images.shape[:3]
    cam, py, px = (torch.randint(0, hi, (k, NERF_RAYS), generator=gen, device=gen.device) for hi in (n, h, w))
    return {"camera_indices": cam, "pixel_x": px.to(torch.float32), "pixel_y": py.to(torch.float32),
            "image": images[cam, py, px]}


def row(batches, i) -> dict[str, torch.Tensor]:
    return {k: v[i] for k, v in batches.items()}


def ensemble_state_differ(a: dict, b: dict) -> list[str]:
    """The items of two ``EnsembleTrainState.state_dict()`` copies whose bits
    differ."""
    differ = [f"params:{k}" for k in a["params"] if not torch.equal(a["params"][k], b["params"][k])]
    for key in ("exp_avg", "exp_avg_sq"):
        differ += [f"{key}:{k}" for k in a["opt_state"][key]
                   if not torch.equal(a["opt_state"][key][k], b["opt_state"][key][k])]
    if a["opt_state"]["groups"] != b["opt_state"]["groups"] or a["step"] != b["step"]:
        differ.append("counts")
    differ += [f"generator {m}" for m, (x, y) in enumerate(zip(a["generators"], b["generators"]))
               if not torch.equal(x, y)]
    return differ


def lone_trainer(cfg, cams, images, device):
    from uncertainty_nerf_gs_torch.engine.trainer import NerfactoTrainer

    return NerfactoTrainer(cfg, cams, images, seed=SEED, device=device)


def lone_step(cfg, cams, images, device, snap, m, batch) -> tuple[torch.Tensor, dict]:
    """Member m of a snapshot of the ensemble's state trained alone: a
    single-member trainer restored to the member's weights, Adam state and
    step, one step on ``batch`` with draws from a generator in the member's
    state (``NerfactoTrainer._device_step``'s path with the batch given).
    Returns its total loss and its state."""
    from uncertainty_nerf_gs_torch.engine.optimizers import apply_updates

    trainer = lone_trainer(cfg, cams, images, device)
    opt = snap["opt_state"]
    trainer.restore({
        "params": {k: v[m] for k, v in snap["params"].items()}, "step": snap["step"],
        "opt_state": {"groups": {g: {n: c[m] for n, c in v.items()} for g, v in opt["groups"].items()},
                      "exp_avg": {k: v[m] for k, v in opt["exp_avg"].items()},
                      "exp_avg_sq": {k: v[m] for k, v in opt["exp_avg_sq"].items()}}})
    gen = torch.Generator(device=device)
    gen.set_state(snap["generators"][m])
    trainer.optimizer.zero_grad(set_to_none=True)
    total, _ = trainer._loss_fn(batch, trainer._step_t, draws=trainer.model.draw(NERF_RAYS, gen))
    total.backward()
    apply_updates(trainer.optimizer)
    sd = trainer.state_dict()
    return total.detach(), sd


def run_ensemble_train(device, name) -> dict:
    """The joint ensemble step at full width (``build_ensemble_train_step``):
    a lone trainer first (its footprint at a step's peak, its captured
    step's pool, its 50-step launch's ms and busy time, for the
    comparison); then 2 eager steps and a 50-step launch (the member steps
    captured as one CUDA graph and replayed), with K1 10, K4 15 and K5 15
    launches a step, the footprint of an eager step and of the launch with
    the capture against the lone trainer's plus the other members' weights,
    gradients and moments (16 B a parameter);
    members 0 and 4 of a step against lone single-member steps bit for bit;
    two steps from one restored state bit for bit; 5 steps as one launch
    against 5 eager steps bit for bit; the step profiled one at a time and
    at 50 a launch."""
    from uncertainty_nerf_gs_torch.ops import backend
    from uncertainty_nerf_gs_torch.parallel.ensemble_parallel import build_ensemble_train_step

    t0 = time.perf_counter()
    cfg, model, cams, images, stacked = build_ensemble_train(device)
    images = torch.as_tensor(images, device=device)
    n_params = sum(v[0].numel() for v in stacked.values())
    print(f"ensemble training: {NUM_MEMBERS} members of {n_params} parameters; set-up {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    out: dict = {}

    # the lone trainer: its footprint at a step's peak, its graph's pool, its
    # 50-step launch
    before = torch.cuda.memory_allocated()
    stacked_bytes = sum(v.numel() * v.element_size() for v in stacked.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lone = lone_trainer(cfg, cams, images.cpu().numpy(), device)
    lone.restore({"params": {k: v[0] for k, v in stacked.items()}})
    lone.train_step(NERF_RAYS)
    lone_footprint = torch.cuda.max_memory_allocated() - before
    reserved = torch.cuda.memory_reserved()
    lone.train(ENS_TRAIN_K, NERF_RAYS, steps_per_launch=ENS_TRAIN_K)  # eager warm-up, capture, replays
    lone_pool = torch.cuda.memory_reserved() - reserved
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lone.train(ENS_TRAIN_K, NERF_RAYS, steps_per_launch=ENS_TRAIN_K)
    lone_ms = 1e3 * (time.perf_counter() - t0) / ENS_TRAIN_K
    kernels = profile_top(f"lone trainer, {ENS_TRAIN_K} steps a launch",
                          lambda: lone.train(ENS_TRAIN_K, NERF_RAYS, steps_per_launch=ENS_TRAIN_K),
                          ENS_TRAIN_SYMBOLS, top=3)
    lone_busy = 1e-3 * sum(us for _, us in kernels.values()) / ENS_TRAIN_K if kernels else None
    del lone, kernels
    torch.cuda.empty_cache()

    step = build_ensemble_train_step(model, cfg, cams)
    state = step.init(stacked, seed=SEED + 1)
    del stacked
    torch.cuda.empty_cache()
    batches = ensemble_batches(images, ENS_TRAIN_K, gen)
    backend.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager_ms, losses = [], []
    for i in range(ENS_EAGER_STEPS):
        t0 = time.perf_counter()
        losses.append(step(state, row(batches, i)).cpu())
        eager_ms.append(1e3 * (time.perf_counter() - t0))
    # the ensemble's state, gradients and a step's activations, on the lone
    # trainer's baseline
    footprint = torch.cuda.max_memory_allocated() - (before - stacked_bytes)
    launches = dict(backend.launch_counts)
    want = {k: ENS_EAGER_STEPS * v for k, v in ENS_STEP_PLAN.items()}
    print(f"ensemble training: {ENS_EAGER_STEPS} eager steps, launches {launches}, expected {want}; "
          f"ms a step {', '.join(f'{v:.1f}' for v in eager_ms)} on {name}; losses {[l.tolist() for l in losses]}")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError("the joint ensemble step did not go through its kernels")
    backend.reset_launch_counts()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows = step.launch(state, batches)  # warm-up, capture, replays
    first_launch_s = time.perf_counter() - t0
    capture_footprint = torch.cuda.max_memory_allocated() - (before - stacked_bytes)
    pool = torch.cuda.memory_reserved() - reserved
    launches_k = dict(backend.launch_counts)
    want = {k: ENS_TRAIN_K * v for k, v in ENS_STEP_PLAN.items()}
    print(f"ensemble training: {ENS_TRAIN_K} steps as one launch (capture included, {first_launch_s:.2f} s), "
          f"launches {launches_k}, expected {want}")
    if any(launches_k[k] != v for k, v in want.items()):
        raise AssertionError("the joint ensemble step's K-step launch did not go through its kernels")
    if not np.isfinite(rows).all() or rows.shape != (ENS_TRAIN_K, NUM_MEMBERS):
        raise AssertionError(f"ensemble losses {rows.shape} not finite")
    batches = ensemble_batches(images, ENS_TRAIN_K, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = step.launch(state, batches)  # all replays
    k_ms = 1e3 * (time.perf_counter() - t0) / ENS_TRAIN_K
    extra = (NUM_MEMBERS - 1) * n_params * ENS_MEMBER_BYTES_PER_PARAM
    print(f"ensemble training memory on {name} (max_memory_allocated above the baseline without the ensemble): "
          f"an eager step's peak {footprint / 1e9:.2f} GB, the launch with the capture's "
          f"{capture_footprint / 1e9:.2f} GB, against a lone trainer's {lone_footprint / 1e9:.2f} GB + "
          f"{NUM_MEMBERS - 1} x {n_params} x {ENS_MEMBER_BYTES_PER_PARAM} B = {extra / 1e9:.2f} GB of the other "
          f"members' weights, gradients and moments = {(lone_footprint + extra) / 1e9:.2f} GB; the memory the "
          f"capture reserved {pool / 1e9:.2f} GB (the lone trainer's {lone_pool / 1e9:.2f} GB)")
    # five members' activations at once would add four of the lone trainer's
    if max(footprint, capture_footprint) > 2 * lone_footprint + extra:
        raise AssertionError("the ensemble step holds more than one member's activations at once")
    out.update(eager_ms=eager_ms, k_ms=k_ms, lone_k_ms=lone_ms, lone_busy_ms=lone_busy,
               footprint_gb=footprint / 1e9, capture_footprint_gb=capture_footprint / 1e9,
               lone_footprint_gb=lone_footprint / 1e9, extra_members_gb=extra / 1e9,
               reserved_by_capture_gb=pool / 1e9, lone_reserved_by_capture_gb=lone_pool / 1e9,
               first_launch_s=first_launch_s)

    # members 0 and 4 against lone single-member steps, bit for bit
    snap = _clone_tree(state.state_dict())
    batch = row(batches, 0)
    losses = step(state, batch)
    after = state.state_dict()
    for m in (0, NUM_MEMBERS - 1):
        total, sd = lone_step(cfg, cams, images.cpu().numpy(), device, snap, m, batch)
        differ = [] if torch.equal(total, losses[m]) else ["loss"]
        differ += [f"params:{k}" for k, v in sd["params"].items() if not torch.equal(v, after["params"][k][m])]
        for key in ("exp_avg", "exp_avg_sq"):
            differ += [f"{key}:{k}" for k, v in sd["opt_state"][key].items()
                       if not torch.equal(v, after["opt_state"][key][k][m])]
        print(f"ensemble member {m} against a lone single-member step: {len(differ)} of "
              f"{1 + 3 * len(sd['params'])} items differ" + (f": {differ[:8]}" if differ else " (bit-identical)"))
        if differ:
            raise AssertionError(f"member {m} differs from its lone step: {differ[:8]}")
        del sd
        torch.cuda.empty_cache()

    # two steps from one restored state
    runs = []
    for _ in range(2):
        state.load_state_dict(_clone_tree(snap))
        backend.reset_launch_counts()
        step(state, batch)
        runs.append((_clone_tree(state.state_dict()), dict(backend.launch_counts)))
    differ = ensemble_state_differ(runs[0][0], runs[1][0])
    items = 3 * len(snap["params"]) + 2 + NUM_MEMBERS
    print(f"ensemble repeatability: two steps from one state, launches {runs[0][1]} and {runs[1][1]}; "
          f"{len(differ)} of {items} items differ" + (f": {differ[:8]}" if differ else " (bit-identical)"))
    if differ or runs[0][1] != runs[1][1]:
        raise AssertionError(f"two ensemble steps from one state differ: {differ[:8]}")
    del runs

    # 5 steps as one launch (a new capture) against 5 eager steps
    five = {k: v[:5] for k, v in batches.items()}
    results = []
    for mode in ("eager", "launch"):
        state.load_state_dict(_clone_tree(snap))
        if mode == "eager":
            got = np.stack([step(state, row(five, i)).cpu().numpy() for i in range(5)])
        else:
            got = step.launch(state, five)
        results.append((got, _clone_tree(state.state_dict())))
    differ = ensemble_state_differ(results[0][1], results[1][1])
    if not np.array_equal(results[0][0], results[1][0]):
        differ.append("losses")
    print(f"ensemble graph check: 5 steps as one launch against 5 eager steps from one state: {len(differ)} "
          f"items differ" + (f": {differ[:8]}" if differ else " (losses and state bit-identical)"))
    if differ:
        raise AssertionError(f"the ensemble's K-step launch differs from eager steps: {differ[:8]}")
    del results, snap
    torch.cuda.empty_cache()

    # profiles: one step at a time, and a 50-step launch
    kernels = profile_top("ensemble training, one step", lambda: step(state, row(batches, 1)).cpu(),
                          ENS_TRAIN_SYMBOLS, top=5)
    eager_busy = 1e-3 * sum(us for _, us in kernels.values()) if kernels else None
    eager_wall = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, row(batches, 2 + i)).cpu()
        eager_wall.append(1e3 * (time.perf_counter() - t0))
    kernels = profile_top(f"ensemble training, {ENS_TRAIN_K} steps a launch", lambda: step.launch(state, batches),
                          ENS_TRAIN_SYMBOLS, top=8)
    k_busy = 1e-3 * sum(us for _, us in kernels.values()) / ENS_TRAIN_K if kernels else None
    out.update(eager_busy_ms=eager_busy, eager_wall_ms=eager_wall, k_busy_ms=k_busy, launches=launches_k,
               step_launches={k: v // ENS_TRAIN_K for k, v in launches_k.items()})
    print(f"ensemble training on {name}: one step at a time {', '.join(f'{v:.2f}' for v in eager_wall)} ms "
          f"(busy " + (f"{eager_busy:.2f}" if eager_busy else "not measured") + f" ms); {ENS_TRAIN_K} a launch "
          f"{k_ms:.2f} ms a step (busy " + (f"{k_busy:.2f}" if k_busy else "not measured") + " ms); the lone "
          f"trainer's {ENS_TRAIN_K} a launch {lone_ms:.2f} ms a step (busy "
          + (f"{lone_busy:.2f}" if lone_busy else "not measured") + " ms)")
    render = run_ensemble_member_render(model, state.params, cams, device, name)
    mesh = run_mesh(model, cfg, cams, state, batches, device, name)
    out.update(render=render, mesh=mesh)
    return out


def run_ensemble_member_render(model, stacked, cams, device, name) -> dict:
    """One 256x256 image through ``build_ensemble_render``, chunk by chunk,
    each chunk bit for bit equal to ``models/ensemble.py::ensemble_render``'s;
    K1 10 and K4 15 a chunk."""
    from uncertainty_nerf_gs_torch.models.ensemble import ensemble_render
    from uncertainty_nerf_gs_torch.ops import backend
    from uncertainty_nerf_gs_torch.parallel.ensemble_parallel import build_ensemble_render

    render = build_ensemble_render(model)
    chunk = model.config.eval_num_rays_per_chunk
    chunks = -(-cams.height * cams.width // chunk)
    rays = [chunk_rays(cams, 0, i, chunk, device) for i in range(chunks)]
    backend.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [render(stacked, rb) for rb in rays]
    rgb = torch.cat([o["rgb"] for o in outs]).cpu()
    seconds = time.perf_counter() - t0
    launches = dict(backend.launch_counts)
    want = {k: chunks * v for k, v in PER_MEMBER_PLAN.items()}
    print(f"ensemble render (build_ensemble_render), a 256x256 image: {1e3 * seconds:.1f} ms on {name}; launches "
          f"{launches}, expected {want}")
    if any(launches[k] != v for k, v in want.items()) or not torch.isfinite(rgb).all():
        raise AssertionError("the per-member ensemble render did not go through its kernels")
    differ = 0
    for rb, o in zip(rays, outs):
        ref = ensemble_render(model, stacked, rb)
        differ += sum(int((ref[k] != o[k]).sum()) for k in ref) + len(set(ref) ^ set(o))
    print(f"  against ensemble_render chunk by chunk: {differ} entries differ")
    if differ:
        raise AssertionError("build_ensemble_render differs from ensemble_render")
    return dict(launches=launches, ms=1e3 * seconds)


def run_mesh(model, cfg, cams, state, batches, device, name) -> dict:
    """The mesh forms on a one-rank ("data" 1 x "member" 1) mesh through
    NCCL (a file rendezvous in a temporary directory): the train step, the
    per-member render, the fused render and the splat bands, each bit for
    bit equal to its unsharded form, and each one's launches. A multi-card
    check needs a machine with several cards."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from uncertainty_nerf_gs_torch.models import splatfacto as sf
    from uncertainty_nerf_gs_torch.ops import backend
    from uncertainty_nerf_gs_torch.ops.rasterize import rasterize_gaussians
    from uncertainty_nerf_gs_torch.parallel import mesh as tmesh
    from uncertainty_nerf_gs_torch.parallel.ensemble_fused import build_fused_ensemble_render, pack_ensemble_tables
    from uncertainty_nerf_gs_torch.parallel.ensemble_parallel import build_ensemble_render, build_ensemble_train_step
    from uncertainty_nerf_gs_torch.parallel.splat_parallel import rasterize_gaussians_sharded

    tmp = tempfile.mkdtemp()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0)
    out = {"launches": {}}
    try:
        mesh = tmesh.make_mesh(1, 1)
        print(f"mesh: {mesh} through {dist.get_backend()}")

        def counted(label, fn):
            backend.reset_launch_counts()
            result = fn()
            torch.cuda.synchronize()
            out["launches"][label] = dict(backend.launch_counts)
            return result

        def check(label, a, b):
            differ = [k for k in a if not torch.equal(a[k], b[k])] + sorted(set(a) ^ set(b))
            print(f"mesh {label}: launches {out['launches'].get(label)}; {len(differ)} of {len(a)} outputs differ "
                  f"from the unsharded form" + (f": {differ[:8]}" if differ else " (bit-identical)"))
            if differ:
                raise AssertionError(f"the mesh {label} differs from its unsharded form: {differ[:8]}")

        # the train step, from one state each way
        snap = _clone_tree(state.state_dict())
        batch = row(batches, 3)
        plain_step = build_ensemble_train_step(model, cfg, cams)
        mesh_step = build_ensemble_train_step(model, cfg, cams, mesh=mesh)
        want_losses = plain_step(state, batch)
        want = _clone_tree(state.state_dict())
        state.load_state_dict(_clone_tree(snap))
        losses = counted("train", lambda: mesh_step(state, tmesh.shard_batch(batch, mesh)))
        got = state.state_dict()
        differ = ensemble_state_differ(want, got) + ([] if torch.equal(losses, want_losses) else ["losses"])
        print(f"mesh train step: launches {out['launches']['train']}; {len(differ)} items differ from the unsharded "
              f"step" + (f": {differ[:8]}" if differ else " (losses and state bit-identical)"))
        if differ or any(out["launches"]["train"][k] != v for k, v in ENS_STEP_PLAN.items()):
            raise AssertionError(f"the mesh train step differs from the unsharded step: {differ[:8]}")
        del snap, want, got
        stacked = state.params

        # the per-member render and the fused render of one chunk
        rb = chunk_rays(cams, 1, 3, model.config.eval_num_rays_per_chunk, device)
        check("render", counted("render", lambda: build_ensemble_render(model, mesh=mesh)(
            tmesh.shard_members(stacked, mesh), tmesh.shard_batch(rb, mesh))), build_ensemble_render(model)(stacked, rb))
        packed = pack_ensemble_tables(model, stacked)
        fused = counted("fused", lambda: build_fused_ensemble_render(model, mesh=mesh)(
            tmesh.replicate(stacked, mesh), tmesh.replicate(packed, mesh), tmesh.shard_batch(rb, mesh, tmesh.MESH_DIMS)))
        check("fused", fused, build_fused_ensemble_render(model)(stacked, packed, rb))
        del packed, fused
        torch.cuda.empty_cache()

        # the splat bands on the splat benchmark's scene
        splat = build_splat(device)
        cfg_s = splat.config
        params = {k: v.detach() for k, v in splat.params.items()}
        w, h = splat.cameras.width, splat.cameras.height
        with torch.no_grad():
            proj = sf._project(params, splat.splat_state.alive, *splat.camera(0), w, h, cfg_s)
            opac = torch.sigmoid(params["opacities"]) * proj.compensation
            g = torch.Generator(device=device).manual_seed(SEED + 23)
            payload = torch.cat([torch.rand(opac.shape[0], 3, generator=g, device=device), proj.depths[:, None],
                                 proj.depths[:, None] ** 2, torch.rand(opac.shape[0], 1, generator=g, device=device)], 1)
            img, alpha, overflow = counted("splat", lambda: rasterize_gaussians_sharded(
                proj, opac, payload, w, h, mesh, capacity=cfg_s.rasterize_capacity))
            ref = rasterize_gaussians(proj, opac, payload, w, h, capacity=cfg_s.rasterize_capacity)
        check("splat", {"image": img, "alpha": alpha, "max_overflow": overflow},
              {"image": ref.image, "alpha": ref.alpha, "max_overflow": ref.max_overflow})
        want_plans = {"render": PER_MEMBER_PLAN, "fused": FUSED_PLAN, "splat": dict(composite_fwd=1)}
        for label, plan in want_plans.items():
            if any(out["launches"][label][k] != v for k, v in plan.items()):
                raise AssertionError(f"the mesh {label} launched {out['launches'][label]}, expected {plan}")
        del splat
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"mesh forms done on {name}: one rank through NCCL; a multi-card check needs a machine with several cards")
    return out


def ensemble_train_summary(ens_train) -> dict:
    """The joint-ensemble phases' numbers for the output's JSON line."""
    keep = {k: v for k, v in ens_train.items() if k not in ("render", "mesh", "launches")}
    return dict(keep, render_ms=ens_train["render"]["ms"])


def ensemble_train_paths(ens_train) -> dict[str, dict[str, int]]:
    """The joint-ensemble phases' launches, a path each, for the kernels
    line."""
    paths = {"ensemble_train": ens_train["launches"], "ensemble_train_render": ens_train["render"]["launches"]}
    paths.update({f"mesh_{k}": v for k, v in ens_train["mesh"]["launches"].items()})
    return paths


# -- the CLI phase: a run from the command line, resume, the K-step graph ------

CLI_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
CLI_SIZE, CLI_TRAIN_VIEWS, CLI_TEST_VIEWS = 256, 8, 4
CLI_STEPS, CLI_SAVE, CLI_STOP, CLI_SHORT = 300, 100, 200, 100
CLI_K = 50  # steps a launch, the CLI's default
# single steps the graph check profiles: the profiler's own reading of a
# traced run grows with its events, 50 eager steps took it 40-90 s
GRAPH_PROFILED_STEPS = 5
CLI_MC_SAMPLES, CLI_LAPLACE_ITERS = 10, 50
# per-step launches of a nerfacto-family training step
NERF_STEP_LAUNCHES = dict(pdf_resample=2, cell_lookup_fwd=3, cell_lookup_bwd=3)
TIMING_KEYS = ("num_rays_per_sec", "fps", "compile_and_first_render_sec")


def cli_train(label, argv, runs) -> Path:
    """``scripts.train.main(argv)`` with the launch counters set to 0 just
    before and read just after; its wall time and rate printed."""
    import gc

    from uncertainty_nerf_gs_torch.ops import backend
    from uncertainty_nerf_gs_torch.scripts import train

    steps = int(argv[argv.index("--max-num-iterations") + 1])
    start = 0
    if "--load-dir" in argv:
        from uncertainty_nerf_gs_torch.engine.checkpointing import latest_checkpoint

        start = int(latest_checkpoint(Path(argv[argv.index("--load-dir") + 1])).name[5:14])
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    out = train.main([str(a) for a in argv])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(backend.launch_counts)
    gc.collect()
    torch.cuda.empty_cache()
    runs[label] = dict(kind="train", wall_s=wall, steps=steps - start, steps_per_s=(steps - start) / wall,
                       launches=launches)
    print(f"cli {label}: {steps - start} steps in {wall:.1f} s, {(steps - start) / wall:.1f} steps/s (set-up, "
          f"checkpoints and the graph's capture included); launches {launches}")
    return out


def cli_eval(label, argv, runs) -> dict:
    """``scripts.eval_uncertainty.main(argv)`` likewise; every metric it
    wrote must be finite."""
    import gc

    from uncertainty_nerf_gs_torch.ops import backend
    from uncertainty_nerf_gs_torch.scripts import eval_uncertainty

    backend.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(None):
        out = eval_uncertainty.main([str(a) for a in argv])
    wall = time.perf_counter() - t0
    launches = dict(backend.launch_counts)
    gc.collect()
    torch.cuda.empty_cache()
    results = out["results"]
    payload = json.loads(Path(argv[argv.index("--output-path") + 1]).read_text())
    bad = [k for k, v in results.items() if not np.isfinite(v)]
    if bad or payload["results"] != results:
        raise AssertionError(f"cli {label}: metrics not finite {bad}, or the JSON differs from the results")
    runs[label] = dict(kind="eval", wall_s=wall, launches=launches, method=payload["method_name"],
                       approximations=payload["approximations"], metrics=results)
    print(f"cli {label}: {wall:.1f} s, {payload['method_name']}, launches {launches}; metrics " + ", ".join(
        f"{k} {v:.6g}" for k, v in sorted(results.items())))
    return results


def check_launched(label, runs, names) -> None:
    got = runs[label]["launches"]
    missing = [n for n in names if not got[n]]
    if missing:
        raise AssertionError(f"cli {label}: {missing} never launched ({got})")


def check_cli_graph(trainer, name, step_launches=NERF_STEP_LAUNCHES) -> dict:
    """From one restored snapshot of the CLI run, ``train(CLI_K,
    steps_per_launch=CLI_K)`` (WARMUP_STEPS eager steps, the capture, the
    replays) against ``train(CLI_K, steps_per_launch=1)``: the losses and
    the whole state bit for bit, the same K1/K4/K5 launches. Then each way
    again from there (the K-step launch all replays), timed on the host
    clock; then profiled (GRAPH_PROFILED_STEPS single steps, one K-step
    launch): ms a step, device busy time and idle share."""
    from uncertainty_nerf_gs_torch.ops import backend

    snap = _clone_tree(trainer.state_dict())
    want = {n: CLI_K * v for n, v in step_launches.items()}
    out = {}

    def timed(k):
        losses = []
        backend.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(CLI_K, NERF_RAYS, steps_per_launch=k, callback=lambda i, l: losses.append(l))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / CLI_K
        got = {n: backend.launch_counts[n] for n in want}
        if got != want:
            raise AssertionError(f"steps_per_launch {k}: launches {got} for {CLI_K} steps, expected {want}")
        return ms, losses

    for k in (1, CLI_K):
        trainer.restore(_clone_tree(snap))
        first_ms, losses = timed(k)
        out[k] = dict(first_ms=first_ms, losses=losses, state=_clone_tree(trainer.state_dict()))
        out[k]["ms"], _ = timed(k)
        steps = GRAPH_PROFILED_STEPS if k == 1 else CLI_K  # a K-step launch is profiled whole
        kernels = profile_top(f"cli train {steps} steps, steps_per_launch {k}",
                              lambda: trainer.train(steps, NERF_RAYS, steps_per_launch=k), NERF_SYMBOLS, top=3)
        out[k]["busy_ms"] = 1e-3 * sum(us for _, us in kernels.values()) / steps if kernels else None
    differ: dict = {}
    items = _tree_differ("", out[1]["state"], out[CLI_K]["state"], differ) + 1
    if out[1]["losses"] != out[CLI_K]["losses"]:
        differ["losses"] = True
    print(f"cli graph check: {CLI_K} steps as one launch (a captured step replayed) against {CLI_K} single "
          f"steps from one snapshot: launches {want} each way; {len(differ)} of {items} items differ" + (
              f": {list(differ)[:8]}" if differ else " (losses, parameters, Adam's moments and counts, step, "
              "generator bit-identical)"))
    for k in (1, CLI_K):
        busy = out[k]["busy_ms"]
        print(f"cli steps_per_launch {k}: {out[k]['ms']:.2f} ms a step on the host clock ({out[k]['first_ms']:.2f} "
              f"in the first launch from the snapshot), device busy "
              + (f"{busy:.2f} ms a step" if busy else "not measured") + f" on {name}")
    trainer.restore(snap)
    if differ:
        raise AssertionError(f"the K-step launch differs from single steps: {list(differ)[:8]}")
    return {k: dict(ms=v["ms"], first_ms=v["first_ms"], busy_ms=v["busy_ms"]) for k, v in out.items()}


def check_cli_grad_checkpoint(trainer) -> dict:
    """One step's gradients with the forward recomputed in the backward and
    without, from one snapshot: bit for bit; the peak memory a step adds
    over what it starts with, at 4,096 and 16,384 rays, each way; and three
    checkpointed steps as one captured launch against three plain single
    steps, bit for bit."""
    import gc

    snap = _clone_tree(trainer.state_dict())
    peaks = {}
    for rays in (NERF_RAYS, 4 * NERF_RAYS):
        grads = {}
        for ckpt in (False, True):
            trainer.restore(_clone_tree(snap))
            trainer.gradient_checkpointing = ckpt
            trainer.optimizer.zero_grad(set_to_none=True)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            batch = trainer.sample_batch(rays)
            total, losses = trainer._loss_fn(batch, trainer._step_t)
            total.backward()
            torch.cuda.synchronize()
            peaks[(rays, ckpt)] = (torch.cuda.max_memory_allocated() - base) / 1e9
            grads[ckpt] = {k: p.grad.detach().clone() for k, p in trainer.params().items()}
            # a loss kept alive keeps its autograd graph, and with it the
            # parameters' gradient accumulators on this (the default)
            # stream, which a later capture on its own stream cannot join
            del total, losses
            print(f"cli grad checkpoint {ckpt}, {rays} rays: a step's peak memory over its start "
                  f"{peaks[(rays, ckpt)]:.3f} GB ({base / 1e9:.2f} GB held before it)")
        differ = [k for k in grads[False] if not torch.equal(grads[False][k], grads[True][k])]
        print(f"cli grad checkpoint, {rays} rays: {len(differ)} of {len(grads[False])} gradients differ")
        if differ:
            raise AssertionError(f"gradient checkpointing changed the gradients: {differ[:8]}")
    # the checkpointed step captured and replayed, against plain single steps
    states = []
    for ckpt, k in ((False, 1), (True, 3)):
        trainer.restore(_clone_tree(snap))
        trainer.gradient_checkpointing = ckpt
        trainer.train(3, NERF_RAYS, steps_per_launch=k)
        states.append(_clone_tree(trainer.state_dict()))
    differ: dict = {}
    items = _tree_differ("", states[0], states[1], differ)
    print(f"cli grad checkpoint, 3 steps at 3 a launch against 3 plain single steps: {len(differ)} of {items} "
          "state items differ")
    if differ:
        raise AssertionError(f"the checkpointed K-step launch differs: {list(differ)[:8]}")
    trainer.gradient_checkpointing = False
    trainer.restore(snap)
    return {f"{rays}_{'checkpointed' if c else 'plain'}": v for (rays, c), v in peaks.items()}


def run_cli(name) -> dict:
    """The CLI phase: a Blender tree written by the port (CLI_TRAIN_VIEWS
    and CLI_TEST_VIEWS views at CLI_SIZE), full-width active-nerfacto
    trained through ``scripts.train.main`` (CLI_STEPS steps, a checkpoint
    every CLI_SAVE, CLI_K steps a launch), a run stopped at CLI_STOP and
    resumed with ``--load-dir`` whose last checkpoint must equal the
    straight run's bit for bit, the K-step graph check and the gradient
    checkpointing check from the trained state, then
    ``scripts.eval_uncertainty.main`` on the run, on a fused two-member
    ensemble with a seed-1 run (K6), on nerfacto-mcdropout, on
    nerfacto-laplace twice (the second reads the GGN cache: the same
    metrics) and on active-splatfacto (K2/K3 and the packed-row backward in
    its training). The tree stays for the corner and tools phases."""
    import shutil

    from uncertainty_nerf_gs_torch.data.synthetic import write_blender_dataset
    from uncertainty_nerf_gs_torch.engine import checkpointing as ck
    from uncertainty_nerf_gs_torch.scripts.train import build_trainer

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    scene = write_blender_dataset(CLI_DIR / "scene", CLI_TRAIN_VIEWS, CLI_TEST_VIEWS, CLI_SIZE, CLI_SIZE)
    print(f"cli: wrote a Blender tree of {CLI_TRAIN_VIEWS} + {CLI_TEST_VIEWS} views at {CLI_SIZE}x{CLI_SIZE} in "
          f"{time.perf_counter() - t0:.1f} s")
    runs: dict[str, dict] = {}

    def train_args(method, out, steps, *extra):
        return [method, "--data", scene, "--dataparser", "blender-data", "--output-dir", CLI_DIR / out,
                "--max-num-iterations", steps, "--steps-per-save", CLI_SAVE, "--steps-per-launch", CLI_K,
                "--log-every", CLI_SAVE, *extra]

    straight = cli_train("active_nerfacto", train_args("active-nerfacto", "straight", CLI_STEPS), runs)
    want = {n: CLI_STEPS * v for n, v in NERF_STEP_LAUNCHES.items()}
    if {n: runs["active_nerfacto"]["launches"][n] for n in want} != want:
        raise AssertionError(f"the CLI run's launches {runs['active_nerfacto']['launches']}, expected {want}")
    cli_train("active_nerfacto_to_stop", train_args("active-nerfacto", "resumed", CLI_STOP), runs)
    resumed = cli_train("active_nerfacto_resumed",
                        train_args("active-nerfacto", "resumed", CLI_STEPS, "--load-dir", CLI_DIR / "resumed"), runs)
    a, b = ck.load_checkpoint(ck.checkpoint_path(straight, CLI_STEPS)), ck.load_checkpoint(
        ck.checkpoint_path(resumed, CLI_STEPS))
    differ: dict = {}
    items = _tree_differ("", a, b, differ)
    print(f"cli resume: step-{CLI_STEPS:09d}.ckpt of the run resumed at {CLI_STOP} against the straight run's: "
          f"{len(differ)} of {items} items differ" + (
              f": {differ}" if differ else " (parameters, Adam's moments and counts, generator, step)"))
    if differ or a["step"] != CLI_STEPS:
        raise AssertionError(f"the resumed run differs from the straight run: {list(differ)[:8]}")
    del a, b
    for d in (straight, resumed):  # the disk holds the last checkpoint of each run
        for p in d.glob("step-*.ckpt"):
            if p != ck.latest_checkpoint(d):
                p.unlink()

    trainer, _, _ = build_trainer("active-nerfacto", scene, "blender-data")
    trainer.restore(ck.load_latest(straight)[0])
    graph = check_cli_graph(trainer, name)
    memory = check_cli_grad_checkpoint(trainer)
    del trainer
    torch.cuda.empty_cache()

    cli_eval("eval_active_nerfacto", ["--load-config", straight, "--output-path", CLI_DIR / "an.json"], runs)
    seed1 = cli_train("active_nerfacto_seed1", train_args("active-nerfacto", "seed1", CLI_SHORT, "--seed", 1), runs)
    cli_eval("eval_ensemble_fused", ["--load-config", straight, "--load-config", seed1,
                                     "--output-path", CLI_DIR / "ens.json"], runs)
    check_launched("eval_ensemble_fused", runs, ["packed_cell_lookup_fwd", "packed_cell_lookup_strided",
                                                 "pdf_resample"])
    mcd = cli_train("nerfacto_mcdropout", train_args("nerfacto-mcdropout", "mcd", CLI_SHORT), runs)
    cli_eval("eval_nerfacto_mcdropout", ["--load-config", mcd, "--output-path", CLI_DIR / "mcd.json",
                                         "--mc-samples", CLI_MC_SAMPLES], runs)
    lap = cli_train("nerfacto_laplace", train_args("nerfacto-laplace", "lap", CLI_SHORT), runs)
    metrics = []
    for i in range(2):
        cache = ck.ggn_cache_path(lap, CLI_LAPLACE_ITERS)
        print(f"cli laplace eval {i}: the GGN cache {'exists' if cache.exists() else 'does not exist yet'}")
        metrics.append(cli_eval(f"eval_nerfacto_laplace_{i}", ["--load-config", lap, "--output-path",
                                                               CLI_DIR / f"lap{i}.json", "--laplace-iters",
                                                               CLI_LAPLACE_ITERS], runs))
    same = {k: metrics[0][k] == metrics[1][k] for k in metrics[0] if k not in TIMING_KEYS}
    print(f"cli laplace: fit and eval {runs['eval_nerfacto_laplace_0']['wall_s']:.1f} s, from the cache "
          f"{runs['eval_nerfacto_laplace_1']['wall_s']:.1f} s; metrics bit-identical: {all(same.values())}")
    if not all(same.values()):
        raise AssertionError(f"the eval from the GGN cache differs: {[k for k, v in same.items() if not v]}")
    splat = cli_train("active_splatfacto", train_args("active-splatfacto", "splat", CLI_SHORT), runs)
    check_launched("active_splatfacto", runs, ["composite_fwd", "composite_bwd", "packed_rows_bwd"])
    cli_eval("eval_active_splatfacto", ["--load-config", splat, "--output-path", CLI_DIR / "splat.json",
                                        "--raster-capacity", "auto"], runs)
    check_launched("eval_active_splatfacto", runs, ["composite_fwd"])
    for label in ("eval_active_nerfacto", "nerfacto_mcdropout", "eval_nerfacto_mcdropout", "nerfacto_laplace"):
        check_launched(label, runs, ["pdf_resample", "cell_lookup_fwd"])
    # the tree stays for the corner and tools phases, which remove it
    return dict(runs=runs, graph=graph, memory=memory,
                dirs=dict(scene=scene, straight=straight, seed1=seed1, splat=splat))


# -- the sparse phase: the sparse-view study, the hybrid layout and the face loss -

SPARSE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_sparse"
SPARSE_SIZE, SPARSE_FRAMES, SPARSE_TEST_VIEWS = 256, 100, 4  # sparse-blender's permutations index 100 frames
SPARSE_VIEWS = 12  # the training views: the first 12 of the seed-1 permutation
SPARSE_STEPS, SPARSE_SHORT = 300, 100
SPARSE_DTYPES = ("bf16", "f32", "int8")  # bf16 first: the eval CLI's default
# a fused chunk's launches: K1 twice, K6 strided once a proposal, K6 once for the field
SPARSE_FUSED_PLAN = dict(pdf_resample=2, packed_cell_lookup_strided=2, packed_cell_lookup_fwd=1, cell_lookup_fwd=0)


def hybrid_tables(enc) -> tuple[list, list[int], tuple, int]:
    """(per-level tables as a ``HybridHashEncoding``'s forward builds them,
    the dense levels expanded and the hashed ones in place; their sizes;
    the resolutions; F), detached."""
    from uncertainty_nerf_gs_torch.ops.encodings import dense_corner_to_cell_rows

    tables, hi = [], 0
    with torch.no_grad():
        for lvl, (res, dense) in enumerate(zip(enc.resolutions, enc.is_dense)):
            if dense:
                tables.append(dense_corner_to_cell_rows(getattr(enc, f"corners_{lvl}"), int(res),
                                                        enc.features_per_level))
            else:
                tables.append(enc.cells[hi].detach())
                hi += 1
    return tables, enc.level_sizes, tuple(int(r) for r in enc.resolutions), enc.features_per_level


def encoded_tables(sizes, features, device) -> list[torch.Tensor]:
    """Per-level tables whose cells hold their own index k in every corner,
    as (k % 1024, k // 1024, 0, ...): a lookup's features round to its cell
    (``decoded_cells``)."""
    out = []
    for size in sizes:
        cpr = 128 // (8 * features)
        n_rows = -(-size // cpr)
        k = torch.arange(n_rows * cpr, device=device, dtype=torch.float32)
        code = torch.zeros(k.shape[0], 8, features, device=device)
        code[..., 0] = (k % 1024)[:, None]
        code[..., 1] = torch.div(k, 1024, rounding_mode="floor")[:, None]
        out.append(code.reshape(n_rows, 128))
    return out


def check_hybrid_grid(trainer, device, clustered) -> dict:
    """K4 and K5 at the hybrid layout's full-width shapes: each field's
    per-level tables as its forward builds them (the main field's 8 dense
    levels of up to 153^3 = 3,581,577 cells beside 8 hashed of 2^19, the
    proposals' 4 + 1 and 3 + 2), at uniform positions and at a sparse
    training step's (forward hooks): K4 bit for bit against its plain
    version, its cell read back from cells that store their own index; K5
    launched twice a case and required bit for bit, within GRID_GRAD_TOL of
    the plain backward level by level, its keys and sort equal to the
    reference's; each timed beside its bound."""
    from uncertainty_nerf_gs_torch.ops import encodings as enc

    failed, per_launch, fwd_err, bwd_err = [], [], 0.0, 0.0
    cfg = trainer.config
    fields = trainer.model._fields()
    names = [f"proposal_{i}" for i in range(len(fields) - 1)] + ["field"]
    samples = list(cfg.num_proposal_samples) + [cfg.num_nerf_samples]
    for i, (name, field) in enumerate(zip(names, fields)):
        tables, sizes, res, f = hybrid_tables(field.encoding)
        levels, n = len(res), NERF_RAYS * samples[i]
        gen = torch.Generator(device=device).manual_seed(SEED + 500 + i)
        pos = lookup_positions(res, n, gen, device)
        sets = [(pos, torch.randn(n, levels * f, generator=gen, device=device)),
                (torch.rand(n, 3, generator=gen, device=device),
                 torch.randn(n, levels * f, generator=gen, device=device))]
        c_sets = [(c[i], torch.randn(c[i].shape[0], levels * f, generator=gen, device=device)) for c in clustered]
        dense = sum(field.encoding.is_dense)
        print(f"hybrid {name}: {dense} dense levels (res {list(res[:dense])}) + {levels - dense} hashed, "
              f"sizes {sizes}, keys of {enc.key_bits(levels, sizes)[1]} bits")
        code_tables = encoded_tables(sizes, f, device)
        for label, ss in (("uniform", sets[:1]), ("training", c_sets)):
            for p, g in ss:
                k4, plain = enc.cell_lookup_fwd(tables, p, res, sizes, f), enc.cell_lookup_reference(
                    tables, p, res, sizes, f)
                fwd_err = max(fwd_err, (k4 - plain).abs().max().item())
                chosen = decoded_cells(enc.cell_lookup_fwd(code_tables, p, res, sizes, f).reshape(-1, levels, f))
                wrong = int((chosen != grid_lookups(p, res, sizes)).sum())
                k5 = k5_against_plain(tables, p, res, sizes, f, g)
                sort = check_sort(p, res, sizes)
                bwd_err = max(bwd_err, k5["e_c"], k5["e_p"])
                print(f"hybrid {name} {label} ({p.shape[0]} samples): K4 {int((k4 != plain).sum())} features "
                      f"differ from the plain version's bits, {wrong} lookups read another cell; K5 max err "
                      f"cells {k5['e_c']:.3e} of {k5['top_c']:.3e}, positions {k5['e_p']:.3e}, "
                      f"{k5['bad_c']} + {k5['bad_p']} entries outside GRID_GRAD_TOL, two launches "
                      f"bit-identical {k5['same']} (and without the position gradient {k5['same_without_pos']}); "
                      f"keys/sort equal {sort['keys_equal'] and sort['sorted_equal'] and sort['perm_equal']}, "
                      f"{sort['distinct']} distinct cells, longest run {sort['longest_run']}")
                if not torch.equal(k4, plain) or wrong:
                    failed.append(f"{name} {label}: K4 differs from its plain version")
                if k5["bad_c"] or k5["bad_p"] or not (k5["same"] and k5["same_without_pos"] and k5["finite"]):
                    failed.append(f"{name} {label}: K5 off its plain version or not repeatable")
                if not (sort["keys_equal"] and sort["sorted_equal"] and sort["perm_equal"]):
                    failed.append(f"{name} {label}: K5's keys or sort differ")
        del code_tables
        fwd = k4_times(f"hybrid {name}", tables, sets, res, sizes, f, "uniform")
        fwd_training = k4_times(f"hybrid {name}", tables, c_sets, res, sizes, f, "training")
        bwd = {}
        for label, ss in (("uniform", sets), ("training", c_sets)):
            tm = kernel_times(f"hybrid {name} K5 {label}",
                              lambda p, g: enc.cell_lookup_bwd(tables, p, res, sizes, f, g, True),
                              lambda p, g: enc.cell_lookup_vjp_reference(tables, p, res, sizes, f, g), ss,
                              "cell_lookup_bwd_", K5_KERNELS)
            nn_ = ss[0][0].shape[0]
            uniq = sum(int(torch.unique(row).numel()) for row in grid_lookups(ss[0][0], res, sizes))
            bound, bound_by, nbytes, ops = grid_bound_ms(nn_, levels, f, uniq, True)
            tm.update(field=name, positions=label, shape=[nn_, levels, f, list(sizes)], bound_ms=bound,
                      bound_by=bound_by, bytes=nbytes, operations=ops, unique_cells=uniq, library_ms=None)
            print(f"K5 hybrid {name} ({nn_} samples x {levels} levels, {label} positions): kernel "
                  f"{tm['ms']:.4f} ms on the device ({tm['event_ms']:.4f} ms a call back to back), plain "
                  f"{tm['plain_ms']:.4f} ms, bound {bound:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, {uniq} "
                  f"distinct cells); {tm['kernel_launches']:.0f} kernels a call")
            bwd[label] = tm
        per_launch.append(dict(fwd=fwd, fwd_training=fwd_training, bwd=bwd["uniform"], bwd_training=bwd["training"]))
        del tables
    if failed:
        raise AssertionError("hybrid hash grid: " + "; ".join(failed))
    for key in ("fwd", "fwd_training", "bwd", "bwd_training"):
        chunk = [p[key] for p in per_launch]
        print(f"a sparse step's three {'K4' if key.startswith('fwd') else 'K5'} calls, {chunk[0]['positions']} "
              f"positions: {sum(c['ms'] for c in chunk):.4f} ms, bound {sum(c['bound_ms'] for c in chunk):.4f} ms")
    return dict(fwd_err=fwd_err, bwd_err=bwd_err, per_launch=per_launch)


def expansion_times(trainer, step_busy_ms) -> dict:
    """``dense_corner_to_cell_rows`` alone, as a sparse step runs it: every
    dense level of the three fields expanded (forward), and with the slice
    transpose of its backward (autograd's, from gradients made once), on
    leaves detached from the trainer's: device time from the profiler (every
    kernel the calls ran), else CUDA events; the bytes its forward writes,
    and its share of the step's device time."""
    from uncertainty_nerf_gs_torch.ops.encodings import dense_corner_to_cell_rows

    grids = [(getattr(fd.encoding, f"corners_{lvl}").detach().clone().requires_grad_(True), int(r),
              fd.encoding.features_per_level)
             for fd in trainer.model._fields() for lvl, (r, d) in enumerate(zip(fd.encoding.resolutions,
                                                                                fd.encoding.is_dense)) if d]
    written = sum(4 * r**3 * 8 * f for _, r, f in grids)

    def forward():
        return [dense_corner_to_cell_rows(g, r, f) for g, r, f in grids]

    grads = [torch.ones_like(o) for o in forward()]

    def both():
        torch.autograd.backward(forward(), grads)
        for g, _, _ in grids:
            g.grad = None

    fwd_ms, both_ms = device_ms(forward, [()], ""), device_ms(both, [()], "")
    share = both_ms / step_busy_ms if step_busy_ms else None
    print(f"dense_corner_to_cell_rows: {len(grids)} dense levels of the three fields, forward {fwd_ms:.3f} ms "
          f"of device time ({written / 1e6:.1f} MB of float32 cell rows written), forward and backward "
          f"{both_ms:.3f} ms" + (f", {share:.1%} of a sparse step's {step_busy_ms:.2f} ms of device time"
                                 if share else ""))
    return dict(levels=len(grids), fwd_ms=fwd_ms, fwd_bwd_ms=both_ms, bytes_written=written, share=share)


def sparse_k6(run_dirs, device, name) -> dict:
    """K6 on the sparse ensemble's tables at each dtype: two runs loaded as
    ``eval_uncertainty`` loads them, packed per dtype (per-level lists: the
    hybrid layout), one fused chunk of test rays recorded; each of its three
    K6 launches held bit for bit against its plain version, the chunk's
    kernel path against its plain path bit for bit, and each launch timed
    beside its bound (the rows' bytes at the dtype) and ``index_select`` of
    the same rows; then a test image through the eval's renderer,
    profiled."""
    from uncertainty_nerf_gs_torch.interop import stack_params
    from uncertainty_nerf_gs_torch.ops import backend
    from uncertainty_nerf_gs_torch.parallel.ensemble_fused import (
        build_fused_ensemble_render,
        pack_ensemble_tables,
    )
    from uncertainty_nerf_gs_torch.scripts.eval_uncertainty import (
        _eval_cameras_and_images,
        _load_run,
        _nerfacto_full_image_renderer,
        build_ensemble_chunk_fn,
    )

    trainers = [_load_run(d, device)[0] for d in run_dirs]
    model = trainers[0].model
    stacked = stack_params([{k: v.detach() for k, v in t.params().items() if k != "camera_opt"}
                            for t in trainers])
    del trainers
    cams = _eval_cameras_and_images(json.loads((Path(run_dirs[0]) / "config.json").read_text()))[0].cameras
    chunk = model.config.eval_num_rays_per_chunk
    rb = chunk_rays(cams, 0, cams.height * cams.width // chunk // 2, chunk, device)
    render = build_fused_ensemble_render(model)
    out, err = {}, 0.0
    for dtype in SPARSE_DTYPES:
        packed = pack_ensemble_tables(model, stacked, table_dtype=dtype)
        nbytes = sum(t.numel() * t.element_size() for v in packed.values()
                     for t in (v["tables"] if isinstance(v, dict) else v))
        backend.reset_launch_counts()
        with record_k6() as calls:
            kern = render(stacked, packed, rb)
        launches = {k: backend.launch_counts[k] for k in SPARSE_FUSED_PLAN}
        with backend.plain_versions():
            plain = render(stacked, packed, rb)
        differ_out = sum(bits_differ(kern, plain).values())
        differ = [int((k6_call(c) != k6_plain(c)).sum()) for c in calls]
        err = max(err, max((k6_call(c) - k6_plain(c)).abs().max().item() for c in calls))
        field = packed["field"]["tables"] if isinstance(packed["field"], dict) else packed["field"]
        print(f"sparse K6 {dtype}: packed tables {nbytes / 1e9:.3f} GB ({len(field)} per-level field tables); "
              f"a chunk's launches {launches}, expected {SPARSE_FUSED_PLAN}; its "
              f"{len(calls)} K6 launches differ from their plain versions in {differ} features; the chunk's "
              f"kernel path against its plain path: {differ_out} output entries not bit-identical")
        if launches != SPARSE_FUSED_PLAN or any(differ) or differ_out:
            raise AssertionError(f"sparse K6 {dtype}: off its plan or its plain version")
        out[dtype] = [k6_times(f"sparse {dtype} launch {j}", [c]) for j, c in enumerate(calls)]
        per = out[dtype]
        image = _nerfacto_full_image_renderer(model.config, build_ensemble_chunk_fn(model, stacked, table_dtype=dtype),
                                              cams, device)
        image(0)["rgb"].cpu()  # warm-up: the pack and the first chunk
        profile_top(f"sparse fused {dtype} image ({cams.height}x{cams.width})", lambda: image(0)["rgb"].cpu(),
                    ENSEMBLE_SYMBOLS, top=8)
        print(f"sparse K6 {dtype}: a chunk's {len(per)} launches {sum(t['ms'] for t in per):.4f} ms, bound "
              f"{sum(t['bound_ms'] for t in per):.4f} ms, plain {sum(t['plain_ms'] for t in per):.4f} ms, "
              f"index_select {sum(t['library_ms'] for t in per):.4f} ms on {name}")
        del packed, calls
        torch.cuda.empty_cache()
    return dict(times=out, err=err)


def run_sparse(name) -> dict:
    """The sparse phase, through the entry points a user calls: a Blender
    tree of SPARSE_FRAMES + SPARSE_TEST_VIEWS views written by the port,
    full-width active-nerfacto trained by ``scripts.train.main`` with
    ``--dataparser sparse-blender`` (seed1, 12 views: the hybrid layout and
    the face-consistency loss, as the JAX package switches them), 300 steps
    at 50 a launch, and a seed-1 run of 100; K4/K5 at the hybrid shapes
    (``check_hybrid_grid``); a sparse step against its plain path, two
    steps from one state, 50 steps as one graph launch against 50 single
    steps, the step's times and ``dense_corner_to_cell_rows``' share; then
    ``scripts.eval_uncertainty.main`` on the run and on the fused two-member
    ensemble at bf16 (the default), f32 and int8, with ``--table-fold 2``
    and ``--table-split`` (bf16) equal to the unfolded run bit for bit; K6
    on each dtype (``sparse_k6``); last, for the record, the 12-view PSNR
    beside a run of the cell layout with the same steps."""
    import shutil

    from uncertainty_nerf_gs_torch.data.synthetic import write_blender_dataset
    from uncertainty_nerf_gs_torch.engine import checkpointing as ck
    from uncertainty_nerf_gs_torch.ops import backend
    from uncertainty_nerf_gs_torch.scripts.eval_uncertainty import _load_run

    shutil.rmtree(SPARSE_DIR, ignore_errors=True)
    device = torch.device("cuda")
    t0 = time.perf_counter()
    scene = write_blender_dataset(SPARSE_DIR / "scene", SPARSE_FRAMES, SPARSE_TEST_VIEWS, SPARSE_SIZE, SPARSE_SIZE)
    print(f"sparse: wrote a Blender tree of {SPARSE_FRAMES} + {SPARSE_TEST_VIEWS} views at "
          f"{SPARSE_SIZE}x{SPARSE_SIZE} in {time.perf_counter() - t0:.1f} s")
    runs: dict[str, dict] = {}
    parser = json.dumps({"seed_name": "seed1", "num_images": SPARSE_VIEWS})

    def train_args(out, steps, *extra):
        return ["active-nerfacto", "--data", scene, "--dataparser", "sparse-blender", "--parser-kwargs", parser,
                "--output-dir", SPARSE_DIR / out, "--max-num-iterations", steps, "--steps-per-save", steps,
                "--steps-per-launch", CLI_K, "--log-every", steps, *extra]

    hybrid = cli_train("sparse_hybrid", train_args("hybrid", SPARSE_STEPS), runs)
    want = {n: SPARSE_STEPS * v for n, v in NERF_STEP_LAUNCHES.items()}
    if {n: runs["sparse_hybrid"]["launches"][n] for n in want} != want:
        raise AssertionError(f"the sparse run's launches {runs['sparse_hybrid']['launches']}, expected {want}")
    trainer, spec, run_cfg, step = _load_run(hybrid, device)
    events = [json.loads(line) for line in (hybrid / "events.jsonl").read_text().splitlines()]
    face = [e["value"] for e in events if e.get("name") == "face_consistency_loss"]
    print(f"sparse run: config.json {run_cfg['dataparser']} {run_cfg['parser_kwargs']}; the rebuilt trainer's "
          f"grid_layout {trainer.config.grid_layout!r}, face_consistency_mult {trainer.config.face_consistency_mult}, "
          f"{len(trainer.cameras)} training views, step {step}; face_consistency_loss in events.jsonl "
          f"{len(face)} times, last {face[-1] if face else None}")
    if (trainer.config.grid_layout != "hybrid" or trainer.config.face_consistency_mult != 1.0 or not face
            or len(trainer.cameras) != SPARSE_VIEWS):
        raise AssertionError("the sparse run did not train the hybrid layout with the face-consistency loss")
    del trainer
    seed1 = cli_train("sparse_hybrid_seed1", train_args("seed1", SPARSE_SHORT, "--seed", 1), runs)

    # the kernels at the hybrid shapes, and the step, from the trained state
    from uncertainty_nerf_gs_torch.scripts.train import build_trainer

    trainer, _, _ = build_trainer("active-nerfacto", scene, "sparse-blender",
                                  parser_kwargs={"seed_name": "seed1", "num_images": SPARSE_VIEWS})
    trainer.restore(ck.load_latest(hybrid)[0])
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"sparse trainer: {n_params} parameters (hybrid layout)")
    grid = check_hybrid_grid(trainer, device, capture_lookup_positions(trainer))
    step_plain = check_nerfacto_train_plain(trainer)
    if "face_consistency_loss" not in step_plain["losses"]:
        raise AssertionError("the sparse step's losses lack the face-consistency loss")
    repeat = check_nerfacto_repeatable(trainer)
    graph = check_cli_graph(trainer, name)
    backend.reset_launch_counts()
    traced = profile_top("sparse train step", lambda: trainer.train_step(NERF_RAYS), NERF_SYMBOLS)
    busy_ms = 1e-3 * sum(us for _, us in traced.values()) if traced else None
    expansion = expansion_times(trainer, busy_ms)
    del trainer
    torch.cuda.empty_cache()

    # the evaluations, through the CLI
    single = cli_eval("sparse_eval_hybrid", ["--load-config", hybrid, "--output-path", SPARSE_DIR / "one.json"], runs)
    check_launched("sparse_eval_hybrid", runs, ["pdf_resample", "cell_lookup_fwd"])
    metrics = {}
    for dtype in SPARSE_DTYPES:
        flags = [] if dtype == "bf16" else ["--table-dtype", dtype]
        label = f"sparse_eval_ensemble_{dtype}"
        metrics[dtype] = cli_eval(label, ["--load-config", hybrid, "--load-config", seed1, "--output-path",
                                          SPARSE_DIR / f"ens_{dtype}.json", *flags], runs)
        got = runs[label]
        lc = got["launches"]
        if (got["approximations"]["table_dtype"] != dtype or lc["cell_lookup_fwd"]
                or 2 * lc["packed_cell_lookup_fwd"] != lc["pdf_resample"]
                or lc["packed_cell_lookup_strided"] != lc["pdf_resample"] or not lc["pdf_resample"]):
            raise AssertionError(f"{label}: launches {lc} off the fused plan K1 2, K6 3 a chunk")
    for flags, label in ((["--table-fold", "2"], "fold2"), (["--table-split"], "split")):
        m = cli_eval(f"sparse_eval_ensemble_bf16_{label}", ["--load-config", hybrid, "--load-config", seed1,
                                                            "--output-path", SPARSE_DIR / f"ens_{label}.json",
                                                            *flags], runs)
        differ = [k for k in m if k not in TIMING_KEYS and m[k] != metrics["bf16"][k]]
        print(f"sparse eval bf16 {label}: {len(differ)} metrics differ from the unfolded run's bits")
        if differ:
            raise AssertionError(f"sparse eval {label} differs from the unfolded tables: {differ}")
    print("sparse ensemble metrics by table dtype: " + "; ".join(
        f"{dt} psnr {m['psnr']:.6g} nll {m['nll_rgb']:.6g} ause_mse {m['rgb_ause_mse']:.6g}"
        for dt, m in metrics.items()))
    k6 = sparse_k6([hybrid, seed1], device, name)

    # for the record: the cell layout at the same views and steps
    cli_train("sparse_cell", train_args("cell", SPARSE_STEPS, "--overrides", json.dumps({"grid_layout": "cell"})),
              runs)
    cell = cli_eval("sparse_eval_cell", ["--load-config", SPARSE_DIR / "cell", "--output-path",
                                         SPARSE_DIR / "cell.json"], runs)
    print(f"sparse {SPARSE_VIEWS}-view PSNR after {SPARSE_STEPS} steps (no bar): hybrid + face-consistency "
          f"{single['psnr']:.4f} dB, cell layout {cell['psnr']:.4f} dB on {name}")
    shutil.rmtree(SPARSE_DIR, ignore_errors=True)
    return dict(runs=runs, grid=grid, step_plain=step_plain, repeat=repeat, graph=graph, expansion=expansion,
                busy_ms=busy_ms, k6=k6, psnr=dict(hybrid=single["psnr"], cell=cell["psnr"]),
                metrics={dt: {k: m[k] for k in ("psnr", "nll_rgb", "rgb_ause_mse")} for dt, m in metrics.items()})


def sparse_kernel_entries(sparse) -> list[dict]:
    """The sparse phase's shapes and table dtypes, entries of their own
    under K4, K5 and K6: K4 and K5 on per-level tables (launches: the
    hybrid runs' training and single-run eval; times: a sparse step's three
    calls at its positions), K6 per dtype on per-level tables (launches:
    that dtype's fused evals; times: a fused chunk's launches)."""
    runs, grid = sparse["runs"], sparse["grid"]
    hybrid = {k: v for k, v in runs.items() if k not in ("sparse_cell", "sparse_eval_cell")}
    src = "uncertainty_nerf_gs_torch/csrc/hash_grid.cu"
    replaces = "experiments/jobs/403_pallas_gather_probe.py:96"
    out = []
    for name, key, err in (("cell_lookup_fwd", "fwd_training", grid["fwd_err"]),
                           ("cell_lookup_bwd", "bwd_training", grid["bwd_err"])):
        per = [p[key] for p in grid["per_launch"]]
        uniform = [p["fwd" if name == "cell_lookup_fwd" else "bwd"] for p in grid["per_launch"]]
        by_path = {f"cli_{k}": v["launches"][name] for k, v in hybrid.items() if v["launches"].get(name)}
        entry = dict(name=f"{name}:hybrid", route="cuda", source=src, replaces=replaces,
                     launches=sum(by_path.values()), launches_by_path=by_path, max_abs_err=err,
                     ms=sum(p["ms"] for p in per), plain_ms=sum(p["plain_ms"] for p in per),
                     bound_ms=sum(p["bound_ms"] for p in per), bound_by=per[-1]["bound_by"],
                     library_ms=None, per_launch=per,
                     uniform=dict(ms=sum(p["ms"] for p in uniform), bound_ms=sum(p["bound_ms"] for p in uniform)))
        if name == "cell_lookup_fwd":
            entry.update(index_select_ms=sum(p["library_ms"] for p in per))
        else:
            entry.update(deterministic=True)
        out.append(entry)
    for dtype, per_launch in sparse["k6"]["times"].items():
        labels = [k for k in hybrid if k.startswith(f"sparse_eval_ensemble_{dtype}")]
        for name, kind, symbol in (("packed_cell_lookup_fwd", "dense", K6_SYMBOL),
                                   ("packed_cell_lookup_strided", "strided", K6S_SYMBOL)):
            per = [t for t in per_launch if t["kind"] == kind]
            by_path = {f"cli_{k}": hybrid[k]["launches"][name] for k in labels}
            out.append(dict(name=f"{name}:hybrid_{dtype}", route="cuda", source=src, replaces=replaces,
                            symbol=symbol, dtype=dtype, launches=sum(by_path.values()), launches_by_path=by_path,
                            max_abs_err=sparse["k6"]["err"], ms=sum(p["ms"] for p in per),
                            plain_ms=sum(p["plain_ms"] for p in per), bound_ms=sum(p["bound_ms"] for p in per),
                            bound_by=per[-1]["bound_by"], library_ms=None,
                            index_select_ms=sum(p["library_ms"] for p in per), per_launch=per))
    return out


# -- the corner phase: the corner (tcnn) layout through K7 and K8 ---------------

CORNER_STEPS, CORNER_SHORT = 300, 100  # the cell-layout CLI runs' steps, for the PSNR beside them
K7_OPS = lambda f: 12 + 8 * (10 + 2 * f)  # noqa: E731  (locate; a corner's slot, weight, product and sum)
# device kernels a K8 call at 17-24 key bits: the tile stage, the sort's first pass (scan, scatter) and two
# more (histogram, scan, scatter each), the segmented sum and its fixup; and a memset of the sort's totals
K8_KERNELS = 11
K8_OPS = lambda f: 12 + 8 * (10 + 2 * f) + 8 * (4 * f + 10)  # noqa: E731  (and the position gradient)
K8_POS_OPS = lambda f: K8_OPS(f) - 8 * 2 * f  # noqa: E731  (no table gradient's products and sums)
CORNER_FIELDS = ("proposal_0", "proposal_1", "field")
# a corner step's and a corner chunk's launches
CORNER_STEP_LAUNCHES = dict(pdf_resample=2, hash_lookup_fwd=3, hash_lookup_bwd=3)
# K8's kernels: its own (hash_lookup_bwd_*) and K5's sort kernels (cell_lookup_bwd_*), which a corner step
# runs for K8 alone
CORNER_SYMBOLS = {"pdf_resample": "pdf_resample_kernel", "hash_lookup_fwd": "hash_lookup_fwd_",
                  "hash_lookup_bwd": "lookup_bwd_"}
K8_TILE = 256  # samples a tile of K8's tile stage (csrc/hash_grid.cu kK8Lookups)


def other_corner(checkout):
    """``corner_library`` of another checkout's ``hash_grid.cu`` (the parent
    commit unpacked with ``git archive``), built beside that checkout's
    ``packed_rows.cu``: the returned function waits for both and adds
    ``.packed_rows_bwd(g_packed, idx_all, counts, n)``, that checkout's
    splat gather backward (``other_packed_rows``), and ``.checkout``."""
    import hashlib

    from uncertainty_nerf_gs_torch.ops import backend

    root = Path(checkout).resolve()
    grid = corner_library(root / "uncertainty_nerf_gs_torch" / "csrc" / "hash_grid.cu")
    src = root / "uncertainty_nerf_gs_torch" / "csrc" / "packed_rows.cu"
    out = backend.BUILD_DIR / f"other_rows-{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so"
    proc = subprocess.Popen([backend._nvcc(), *backend.NVCC_FLAGS, "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish():
        ns = grid()
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        ns.packed_rows_bwd = other_packed_rows(ctypes.CDLL(str(out)), ns.lib)
        ns.checkout = str(checkout)
        return ns

    return finish


def other_packed_rows(rows, grid):
    """Another checkout's splat gather backward through its C entry points
    (``rows``: its packed_rows library, ``grid``: its hash_grid library), as
    its wrapper calls them; no launch counted. A source with
    ``packed_rows_bwd_f32`` takes this checkout's arguments; an older one
    is its keys kernel, its hash_grid's ``radix_sort_u32`` and its sum
    kernel, sized by the live count read back to the host."""
    from uncertainty_nerf_gs_torch.ops import backend

    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    def entry(lib, name, argtypes, restype=I):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
        return fn

    def check(name, err):
        if err != 0:
            raise RuntimeError(f"the other {name} failed: CUDA error {err}")

    if hasattr(rows, "packed_rows_bwd_f32"):
        scratch_bytes = entry(rows, "packed_rows_scratch_bytes", [I, I, I], L)
        run = entry(rows, "packed_rows_bwd_f32", [P, P, P, P, P, L, I, I, L, I, I, P])

        def bwd(g, idx, counts, n):
            t, k, d = g.shape
            nbytes = scratch_bytes(t, k, n)
            scratch = torch.empty(nbytes, dtype=torch.uint8, device=g.device)
            g_src = torch.empty((n + 1, d), dtype=torch.float32, device=g.device)
            check("packed_rows_bwd_f32", run(idx.data_ptr(), counts.data_ptr(), g.data_ptr(), g_src.data_ptr(),
                                             scratch.data_ptr(), nbytes, t, k, idx.stride(0), d, n,
                                             backend.current_stream_handle(g.device)))
            return g_src

        return bwd
    keys = entry(rows, "packed_rows_keys", [P, P, P, P, P, I, I, L, P])
    sort_bytes = entry(grid, "radix_sort_u32_scratch_bytes", [I], L)
    sort = entry(grid, "radix_sort_u32", [P, I, I, P, P, P, L, P])
    total = entry(rows, "packed_rows_sum", [P, P, P, P, P, I, I, I, P])

    def bwd(g, idx, counts, n):
        t, k, d = g.shape
        offsets = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts
        num_live = int(counts.sum())
        key, slot, skey, perm = (torch.empty(num_live, dtype=torch.int32, device=g.device) for _ in range(4))
        g_src = torch.empty((n + 1, d), dtype=torch.float32, device=g.device)
        nbytes = sort_bytes(num_live)
        scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=g.device)
        stream = backend.current_stream_handle(g.device)
        check("packed_rows_keys", keys(idx.data_ptr(), counts.data_ptr(), offsets.data_ptr(), key.data_ptr(),
                                       slot.data_ptr(), t, k, idx.stride(0), stream))
        check("radix_sort_u32", sort(key.data_ptr(), num_live, max(1, (n - 1).bit_length()), skey.data_ptr(),
                                     perm.data_ptr(), scratch.data_ptr(), scratch.numel(), stream))
        check("packed_rows_sum", total(skey.data_ptr(), perm.data_ptr(), slot.data_ptr(), g.data_ptr(),
                                       g_src.data_ptr(), num_live, n, d, stream))
        return g_src

    return bwd


def corner_library(src, tag="other_corner"):
    """Starts ``nvcc`` on a ``hash_grid.cu`` (another checkout's, or a
    variant of this one's) with the port's flags, into
    ``build/torch_kernels/``. Returns a function that waits for it and
    returns that library's K7 and K8 through their C entry points, which
    keep their arguments: ``.k7(table, positions, res, f)`` and ``.k8(table,
    positions, res, f, g_out, need_table=True)``, and K5's positions-only
    mode, ``.k5_positions(cells, positions, res, table_size, f, g_out)`` on
    stacked cells (no launch counted), and ``.report``, ``ptxas -v``'s
    output."""
    import hashlib
    from types import SimpleNamespace

    from uncertainty_nerf_gs_torch.ops import backend
    from uncertainty_nerf_gs_torch.ops import encodings as enc

    src = Path(src)
    backend.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = backend.BUILD_DIR / f"{tag}-{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so"
    proc = subprocess.Popen([backend._nvcc(), *backend.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        lib = ctypes.CDLL(str(out))
        for name in ("hash_lookup_fwd_f32", "hash_lookup_bwd_f32", "hash_lookup_bwd_scratch_bytes",
                     "cell_lookup_bwd_f32"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = enc._ARGTYPES[name], (ctypes.c_longlong if "scratch" in name else ctypes.c_int)

        def k7(table, pos, res, f):
            levels, size, _ = table.shape
            got = torch.empty((pos.shape[0], levels * f), dtype=torch.float32, device=pos.device)
            err = lib.hash_lookup_fwd_f32(pos.data_ptr(), table.data_ptr(), got.data_ptr(), pos.shape[0], levels,
                                          size, f, (ctypes.c_int * levels)(*res), enc.corner_dense_mask(res, size),
                                          backend.current_stream_handle(pos.device))
            if err != 0:
                raise RuntimeError(f"the other K7's launch failed: CUDA error {err}")
            return got

        def k8(table, pos, res, f, g_out, need_table=True):
            levels, size, _ = table.shape
            n = pos.shape[0]
            g_table = torch.zeros_like(table) if need_table else None
            g_pos = torch.empty_like(pos)
            scratch = None
            if need_table:
                scratch = torch.empty(lib.hash_lookup_bwd_scratch_bytes(n, levels, f), dtype=torch.uint8,
                                      device=pos.device)
            err = lib.hash_lookup_bwd_f32(
                pos.data_ptr(), table.data_ptr(), g_out.data_ptr(), None if g_table is None else g_table.data_ptr(),
                g_pos.data_ptr(), n, levels, size, f, (ctypes.c_int * levels)(*res), enc.corner_dense_mask(res, size),
                None if scratch is None else scratch.data_ptr(), 0 if scratch is None else scratch.numel(),
                backend.current_stream_handle(pos.device))
            if err != 0:
                raise RuntimeError(f"the other K8's launch failed: CUDA error {err}")
            return g_table, g_pos

        def k5_positions(cells, pos, res, table, f, g_out):
            levels = cells.shape[0]
            g_pos = torch.empty_like(pos)
            err = lib.cell_lookup_bwd_f32(
                pos.data_ptr(), enc._pointers([cells[lvl] for lvl in range(levels)]), g_out.data_ptr(), None,
                g_pos.data_ptr(), pos.shape[0], levels, enc._ints([table] * levels), f, enc._ints(res), None, 0,
                backend.current_stream_handle(pos.device))
            if err != 0:
                raise RuntimeError(f"the other K5 (positions only) launch failed: CUDA error {err}")
            return g_pos

        return SimpleNamespace(k7=k7, k8=k8, k5_positions=k5_positions, report=log, lib=lib)

    return finish


def corner_table(levels, log2, features, gen, device) -> torch.Tensor:
    """An (L, T, F) corner table uniform in +-2 (interop.draw_params' scale)."""
    return torch.rand(levels, 2**log2, features, generator=gen, device=device) * 4.0 - 2.0


def encoded_table(table) -> torch.Tensor:
    """The table with every entry holding its own slot s, as (s % 1024, s //
    1024, 0, ...), or s at F = 1: a lookup's features are then the weighted
    slots of its 8 corners, which differ from corner to corner, so that any
    other slot shows in the features' bits."""
    levels, size, f = table.shape
    s = torch.arange(size, device=table.device, dtype=torch.float32)
    code = torch.zeros_like(table)
    if f == 1:
        code[..., 0] = s
    else:
        code[..., 0] = s % 1024
        code[..., 1] = torch.div(s, 1024, rounding_mode="floor")
    return code


def corner_entries(pos, res, size) -> tuple[torch.Tensor, torch.Tensor, int]:
    """(slots (n L, 8) into the levels stacked (level l's from l T), weights
    (n L, 8), distinct entries) of every lookup, by the plain
    ``hash_corner_slots``: ``F.embedding_bag``'s indices and weights."""
    from uncertainty_nerf_gs_torch.ops.encodings import hash_corner_slots

    slots, weights = [], []
    for lvl, r in enumerate(res):
        s, w = hash_corner_slots(pos, int(r), size)
        slots.append(s + lvl * size)
        weights.append(w)
    slots = torch.stack(slots, 1).reshape(-1, 8)
    return slots, torch.stack(weights, 1).reshape(-1, 8), int(torch.unique(slots).numel())


def corner_bound_ms(n, levels, features, entries, mode) -> tuple[float, str, int, int]:
    """Least time of one call on these inputs. ``mode`` "fwd" (K7):
    positions read once, each 8-byte (F = 2) entry that a lookup reads
    moved once (``entries`` distinct; pass every corner read, 8 n L, for the
    bound that counts them all), the features written once. "bwd" (K8):
    positions, g_out and the touched entries read, each touched entry's
    gradient and the positions' gradient written. "positions" (K8's
    positions-only mode): the same reads, and only the positions' gradient
    written. Returns (ms, bound_by, bytes, operations)."""
    lookups = n * levels
    entry_bytes = entries * 4 * features
    nbytes = 12 * n + entry_bytes + 4 * features * lookups
    ops = lookups * K7_OPS(features)
    if mode == "bwd":
        nbytes += entry_bytes + 12 * n
        ops = lookups * K8_OPS(features)
    elif mode == "positions":
        nbytes += 12 * n
        ops = lookups * K8_POS_OPS(features)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations"), nbytes, ops


def k8_against_plain(table, pos, res, f, g_out) -> dict:
    """K8 twice, and its positions-only mode, against autograd through the
    plain lookup: the errors, the entries outside GRID_GRAD_TOL (the table
    level by level), and whether the launches gave the same bits."""
    from uncertainty_nerf_gs_torch.ops import encodings as enc

    g_t, g_p = enc.hash_lookup_bwd(table, pos, res, f, g_out)
    again_t, again_p = enc.hash_lookup_bwd(table, pos, res, f, g_out)
    none, only_p = enc.hash_lookup_bwd(table, pos, res, f, g_out, need_table=False)
    ref_t, ref_p = enc.hash_encoding_vjp_reference(table, pos, res, f, g_out)
    torch.cuda.synchronize()
    return dict(
        e_t=(g_t - ref_t).abs().max().item(), e_p=(g_p - ref_p).abs().max().item(),
        top_t=ref_t.abs().max().item(), top_p=ref_p.abs().max().item(),
        bad_t=level_mismatch(g_t, ref_t), bad_p=int(grad_mismatch(g_p, ref_p, GRID_GRAD_TOL).sum()),
        finite=bool(torch.isfinite(g_t).all() and torch.isfinite(g_p).all()),
        same=torch.equal(g_t, again_t) and torch.equal(g_p, again_p),
        positions_only_same=none is None and torch.equal(only_p, g_p),
    )


def corner_partials(pos, res, size) -> tuple[int, int]:
    """(pairs, partials): K8's (lookup, corner) pairs at these positions and
    the partials its tile stage leaves, one for each distinct slot of a level
    among K8_TILE consecutive samples, counted with the plain
    ``hash_corner_slots``."""
    from uncertainty_nerf_gs_torch.ops.encodings import hash_corner_slots

    tile = torch.arange(pos.shape[0], device=pos.device) // K8_TILE
    parts = 0
    for r in res:
        slots, _ = hash_corner_slots(pos, int(r), size)
        parts += int(torch.unique(tile[:, None] * size + slots).numel())
    return 8 * pos.shape[0] * len(res), parts


def corner_times(name, table, res, f, sets, label, other=None) -> dict:
    """K7 and K8 per call over ``sets`` of (positions, g_out), each beside
    its plain version, its bounds (each distinct entry once; every corner
    read) and, for K7, ``F.embedding_bag(mode="sum", per_sample_weights=)``
    over the same 8 slots and weights a lookup (the yardstick: one PyTorch
    call that computes the same sum; the port never calls it); K8's
    positions-only mode beside K8. K8's times (and its plain version's) are
    CUDA events back to back: the profiler has traced only part of its
    pipeline's kernels. Beside K8, ``index_put_(accumulate=True)`` of the
    same 8 n L (slot, w_k g) pairs into the table, a partial yardstick (it
    is handed the products; the port never calls it), and the partials its
    tile stage leaves. With ``other`` (``other_corner``), that checkout's K7
    (bit for bit against the plain version) and K8 (within GRID_GRAD_TOL)
    are timed in turns with this one's, other, this, this, other
    (``turns_ms``)."""
    import torch.nn.functional as F

    from uncertainty_nerf_gs_torch.ops import encodings as enc

    n, levels = sets[0][0].shape[0], len(res)
    size = table.shape[1]
    fwd = kernel_times(f"{name} K7 {label}", lambda p, g: enc.hash_lookup_fwd(table, p, res, f),
                       lambda p, g: enc.hash_encoding_lookup_reference(table, p, res, f), sets,
                       "hash_lookup_fwd_")
    bwd = kernel_times(f"{name} K8 {label}", lambda p, g: enc.hash_lookup_bwd(table, p, res, f, g),
                       lambda p, g: enc.hash_encoding_vjp_reference(table, p, res, f, g), sets, "lookup_bwd_",
                       K8_KERNELS)
    bwd.update(ms=bwd["event_ms"], plain_ms=bwd["plain_event_ms"], ms_from="events")
    pos_only = kernel_times(f"{name} K8 positions only {label}",
                            lambda p, g: enc.hash_lookup_bwd(table, p, res, f, g, need_table=False),
                            lambda p, g: enc.hash_encoding_vjp_reference(table, p, res, f, g, need_table=False), sets,
                            "hash_lookup_bwd_tile")
    flat = table.reshape(-1, f)
    bags, puts = [], []
    for p, g in sets:
        slots, weights, _ = corner_entries(p, res, size)
        bags.append((slots, weights))
        puts.append((slots.reshape(-1), (weights[:, :, None] * g.reshape(-1, 1, f)).reshape(-1, f)))
    library_ms = time_ms(lambda s, w: F.embedding_bag(s, flat, mode="sum", per_sample_weights=w), bags)
    target = torch.zeros_like(flat)
    index_put_ms = time_ms(lambda i, c: target.index_put_((i,), c, accumulate=True), puts)
    del bags, puts, target
    uniq = corner_entries(sets[0][0], res, size)[2]
    pairs, parts = corner_partials(sets[0][0], res, size)
    for tm, mode in ((fwd, "fwd"), (bwd, "bwd"), (pos_only, "positions")):
        bound, by, nbytes, ops = corner_bound_ms(n, levels, f, uniq, mode)
        every, _, every_bytes, _ = corner_bound_ms(n, levels, f, 8 * n * levels, mode)
        tm.update(field=name, positions=label, shape=[n, levels, f, size], bound_ms=bound, bound_by=by,
                  bytes=nbytes, operations=ops, unique_entries=uniq, every_read_bound_ms=every,
                  every_read_bytes=every_bytes, library_ms=library_ms if tm is fwd else None)
    bwd.update(index_put_ms=index_put_ms, pairs=pairs, partials=parts)
    for kname, tm in (("K7", fwd), ("K8", bwd), ("K8 positions only", pos_only)):
        print(f"{kname} {name} ({n} samples x {levels} levels, {label} positions): kernel {tm['ms']:.4f} ms "
              f"({tm['ms_from']}; {tm['event_ms']:.4f} ms a call back to back), plain {tm['plain_ms']:.4f} ms, bound "
              f"{tm['bound_ms']:.4f} ms ({tm['bound_by']}: {tm['bytes'] / 1e6:.1f} MB, {uniq} distinct entries of "
              f"{8 * n * levels} corner reads; {tm['every_read_bound_ms']:.4f} ms, "
              f"{tm['every_read_bytes'] / 1e6:.1f} MB counting every corner read)"
              + (f"; F.embedding_bag of the same slots and weights {library_ms:.4f} ms" if tm is fwd else "")
              + (f"; index_put_(accumulate=True) of the {pairs} (slot, w_k g) pairs {index_put_ms:.4f} ms (a "
                 f"partial yardstick); the tile stage leaves {parts} partials of {pairs} pairs "
                 f"({parts / pairs:.3f})" if tm is bwd else ""))
    print(f"  K8 {name} {label} (profiler, scaled): " + ", ".join(
        f"{kernel_name(k)} {v:.4f} ms" for k, v in bwd["parts"].items())
          + f"; the zero-fill, the memset and the wrapper's other device work {sum(bwd['others'].values()):.4f} ms")
    if other is not None:
        for p, g in sets:
            if not torch.equal(other.k7(table, p, res, f), enc.hash_encoding_lookup_reference(table, p, res, f)):
                raise AssertionError(f"{name} {label}: the other K7 differs from the plain version")
            got_t, got_p = other.k8(table, p, res, f, g)
            ref_t, ref_p = enc.hash_encoding_vjp_reference(table, p, res, f, g)
            if level_mismatch(got_t, ref_t) or grad_mismatch(got_p, ref_p, GRID_GRAD_TOL).any():
                raise AssertionError(f"{name} {label}: the other K8 disagrees with the plain backward")
        versions = dict(
            fwd=(dict(other=lambda p, g: other.k7(table, p, res, f),
                      this=lambda p, g: enc.hash_lookup_fwd(table, p, res, f)),
                 lambda fn: device_ms(fn, sets, "hash_lookup_fwd_")),
            bwd=(dict(other=lambda p, g: other.k8(table, p, res, f, g),
                      this=lambda p, g: enc.hash_lookup_bwd(table, p, res, f, g)),
                 lambda fn: time_ms(fn, sets)),
            positions_only=(dict(other=lambda p, g: other.k8(table, p, res, f, g, need_table=False),
                                 this=lambda p, g: enc.hash_lookup_bwd(table, p, res, f, g, need_table=False)),
                            lambda fn: time_ms(fn, sets)))
        for key, tm in (("fwd", fwd), ("bwd", bwd), ("positions_only", pos_only)):
            runs, timer = versions[key]
            tm["turns_ms"] = turns = dict(other=[], this=[])
            for version in ("other", "this", "this", "other"):
                turns[version].append(timer(runs[version]))
            print(f"{key} {name} {label} positions in turns: " + ", ".join(
                f"{v} {' / '.join(f'{t:.4f}' for t in ts)} ms" for v, ts in turns.items()))
    return dict(fwd=fwd, bwd=bwd, positions_only=pos_only)


def check_corner_grid(cfg, device, clustered, other=None) -> dict:
    """K7 and K8 against their plain versions at the corner layout's three
    full-width shapes (4,096 rays; the proposals' 5 levels at 2^17, the
    field's 16 at 2^19), a ragged count, F = 1 and F = 4: K7 bit for bit at
    uniform positions (edges, faces and a little outside included), at a
    real training forward's (``clustered``) and on tables whose entries
    store their own slot; K8 twice bit for bit, within GRID_GRAD_TOL of
    autograd through the plain lookup (the table level by level, the
    positions against their largest entry), and its positions-only mode
    equal to its position gradient bit for bit, at uniform positions, at
    the training forwards' and, at the three full-width shapes, at
    positions of which three quarters lie in a cube of side 1e-4 (in one
    cell or a few at every level: a slot's run spans a tile's threads, and
    its partials, one a tile, cross the segmented sum's chunks). Timed at the three shapes at the
    training forwards' positions (``corner_times``; with ``other``, that
    checkout's K7 and K8 in turns)."""
    from uncertainty_nerf_gs_torch.ops import encodings as enc

    rays = cfg.eval_num_rays_per_chunk
    cases = [(name, levels, max_res, log2, rays * spr, 2, i) for i, (name, levels, max_res, log2, spr)
             in enumerate(grid_shapes(cfg))]
    cases += [("ragged", cfg.num_levels, cfg.max_res, cfg.log2_hashmap_size, 1001, 2, None),
              ("f4", 4, 512, 12, 777, 4, None), ("f1", 4, 512, 12, 777, 1, None)]
    fwd_err = bwd_err = 0.0
    failed, per_launch = [], []
    for i, (name, levels, max_res, log2, n, f, field) in enumerate(cases):
        gen = torch.Generator(device=device).manual_seed(SEED + 700 + i)
        res = tuple(int(r) for r in enc.hash_grid_resolutions(levels, 16, max_res))
        table = corner_table(levels, log2, f, gen, device)
        pos = lookup_positions(res, n, gen, device)
        position_sets = [("uniform", pos)] + ([("training", c[field]) for c in clustered] if field is not None else [])
        for label, p in position_sets:
            for tname, t in (("", table), (", slot-coded table", encoded_table(table))):
                got = enc.hash_lookup_fwd(t, p, res, f)
                want = enc.hash_encoding_lookup_reference(t, p, res, f)
                differ = int((got != want).sum())
                fwd_err = max(fwd_err, (got - want).abs().max().item())
                print(f"corner {name} n={p.shape[0]} L={levels} F={f} table 2^{log2}, {label} positions{tname}: "
                      f"K7 {differ} of {got.numel()} features not bit-identical to the plain version's")
                if differ or not torch.isfinite(got).all():
                    failed.append(f"{name} {label}{tname}: {differ} K7 features differ from the plain version's")
        g_out = torch.randn(n, levels * f, generator=gen, device=device)
        k8 = k8_against_plain(table, pos, res, f, g_out)
        print(f"corner {name}: K8 table max_abs_err {k8['e_t']:.3e} (largest |g| {k8['top_t']:.3e}, {k8['bad_t']} "
              f"outside the level bar), positions max_abs_err {k8['e_p']:.3e} (largest |g| {k8['top_p']:.3e}, "
              f"{k8['bad_p']} outside); a second K8 launch bit-identical: {k8['same']}; the positions-only mode's "
              f"g_pos bit-identical: {k8['positions_only_same']}")
        if k8["bad_t"] or k8["bad_p"] or not k8["finite"]:
            failed.append(f"{name}: K8 disagrees with the plain backward")
        if not (k8["same"] and k8["positions_only_same"]):
            failed.append(f"{name}: two K8 launches, or its positions-only mode, differ")
        bwd_err = max(bwd_err, k8["e_t"], k8["e_p"])
        if field is None:
            continue
        lumped = pos.clone()
        lumped[n // 4:] = 0.3 + 1e-4 * torch.rand(n - n // 4, 3, generator=gen, device=device)
        l_k8 = k8_against_plain(table, lumped, res, f, g_out)
        print(f"corner {name}, three quarters of the positions in a cube of side 1e-4: K8 table {l_k8['e_t']:.3e} "
              f"({l_k8['bad_t']} outside), positions {l_k8['e_p']:.3e} ({l_k8['bad_p']} outside); bit-identical "
              f"{l_k8['same']}, positions-only {l_k8['positions_only_same']}; the tile stage leaves "
              f"{corner_partials(lumped, res, table.shape[1])[1]} partials")
        if l_k8["bad_t"] or l_k8["bad_p"] or not (l_k8["finite"] and l_k8["same"] and l_k8["positions_only_same"]):
            failed.append(f"{name} clustered positions: K8 disagrees with the plain backward or itself")
        bwd_err = max(bwd_err, l_k8["e_t"], l_k8["e_p"])
        c_sets = [(c[field], torch.randn(c[field].shape[0], levels * f, generator=gen, device=device))
                  for c in clustered]
        c_k8 = k8_against_plain(table, c_sets[0][0], res, f, c_sets[0][1])
        print(f"corner {name} training positions: K8 table {c_k8['e_t']:.3e} ({c_k8['bad_t']} outside), "
              f"positions {c_k8['e_p']:.3e} ({c_k8['bad_p']} outside); bit-identical {c_k8['same']}, "
              f"positions-only {c_k8['positions_only_same']}")
        if c_k8["bad_t"] or c_k8["bad_p"] or not (c_k8["finite"] and c_k8["same"] and c_k8["positions_only_same"]):
            failed.append(f"{name} training positions: K8 disagrees with the plain backward or itself")
        bwd_err = max(bwd_err, c_k8["e_t"], c_k8["e_p"])
        per_launch.append(dict(training=corner_times(name, table, res, f, c_sets, "training", other)))
    if failed:
        raise AssertionError("corner grid: " + "; ".join(failed))
    for label in ("training",):
        for key, kname in (("fwd", "K7"), ("bwd", "K8"), ("positions_only", "K8 positions only")):
            calls = [p[label][key] for p in per_launch]
            print(f"a corner step's three {kname} calls, {label} positions: {sum(c['ms'] for c in calls):.4f} ms, "
                  f"plain {sum(c['plain_ms'] for c in calls):.4f} ms, bound {sum(c['bound_ms'] for c in calls):.4f} ms"
                  + (f", F.embedding_bag {sum(c['library_ms'] for c in calls):.4f} ms" if key == "fwd" else ""))
    return dict(fwd_err=fwd_err, bwd_err=bwd_err, per_launch=per_launch)


def k5_positions_only_times(cfg, device, other=None) -> dict:
    """K5's positions-only mode (the pose gradient's backward through K4:
    no table needs a gradient; ``cell_lookup_bwd_pos_kernel``) at the cell
    layout's three full-width shapes, against K5's full backward and
    ``cell_lookup_positions_vjp_reference`` (the plain version in the
    kernels' arithmetic): its g_pos bit for bit against both, and times
    beside the bound of what it reads (positions, g_out, the touched cells)
    and writes (the positions' gradient). ``other`` (``other_corner``):
    that checkout's positions-only mode held bit for bit and timed in turns
    with this one's at the same inputs (this, other, other, this), by CUDA
    events and the profiler."""
    from uncertainty_nerf_gs_torch.ops import encodings as enc

    out, failed = [], []
    for i, (name, levels, max_res, log2, spr) in enumerate(grid_shapes(cfg)):
        gen = torch.Generator(device=device).manual_seed(SEED + 750 + i)
        n = cfg.eval_num_rays_per_chunk * spr
        cells, pos, res, table = grid_inputs(levels, max_res, log2, n, gen, device)
        sets = [(pos, torch.randn(n, levels * 2, generator=gen, device=device)),
                (torch.rand(n, 3, generator=gen, device=device), torch.randn(n, levels * 2, generator=gen, device=device))]
        full = enc.cell_lookup_bwd(cells, sets[0][0], res, table, 2, sets[0][1], True)
        only = enc.cell_lookup_bwd(cells, sets[0][0], res, table, 2, sets[0][1], True, need_cells=False)
        plain = enc.cell_lookup_positions_vjp_reference(cells, sets[0][0], res, table, 2, sets[0][1])
        torch.cuda.synchronize()
        equal_full, equal_plain = only[0] is None and torch.equal(only[1], full[1]), torch.equal(only[1], plain)
        if not (equal_full and equal_plain):
            failed.append(name)

        def mine(p, g):
            return enc.cell_lookup_bwd(cells, p, res, table, 2, g, True, need_cells=False)

        tm = kernel_times(f"{name} K5 positions only", mine,
                          lambda p, g: _plain_cell_pos_vjp(cells, p, res, table, g), sets, "cell_lookup_bwd_pos")
        uniq = sum(int(torch.unique(row).numel()) for row in grid_lookups(pos, res, table))
        nbytes = 12 * n + uniq * 64 + 8 * n * levels + 12 * n
        ops = n * levels * K5_OPS(2, True)
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        tm.update(field=name, shape=[n, levels, 2, table], bound_ms=1e3 * max(by_bytes, by_ops),
                  bound_by="bytes" if by_bytes >= by_ops else "operations", bytes=nbytes, library_ms=None,
                  full_ms=device_ms(lambda p, g: enc.cell_lookup_bwd(cells, p, res, table, 2, g), sets,
                                    "cell_lookup_bwd_"), equal_full=equal_full, equal_plain=equal_plain)
        print(f"K5 positions only {name}: {tm['ms']:.4f} ms on the device against the full backward's "
              f"{tm['full_ms']:.4f} ms; plain {tm['plain_ms']:.4f} ms; bound {tm['bound_ms']:.4f} ms "
              f"({nbytes / 1e6:.1f} MB); g_pos bit-identical to the full backward's: {equal_full}, to "
              f"cell_lookup_positions_vjp_reference's: {equal_plain}")
        if other is not None:
            def theirs(p, g):
                return other.k5_positions(cells, p, res, table, 2, g)

            other_equal = torch.equal(theirs(*sets[0]), only[1])
            turns = []
            for who in ("this", "other", "other", "this"):
                fn = mine if who == "this" else theirs
                turns.append(dict(who=who, ms=device_ms(fn, sets, ""), event_ms=time_ms(fn, sets)))
            print(f"K5 positions only {name}, in turns with {other.checkout} at the same inputs (this, other, other, "
                  f"this): device ms " + " / ".join(f"{x['who']} {x['ms']:.4f}" for x in turns)
                  + "; a call back to back " + " / ".join(f"{x['who']} {x['event_ms']:.4f}" for x in turns)
                  + f"; the other's g_pos bit for bit equal to this one's: {other_equal}")
            tm.update(turns=turns, other_equal=other_equal)
        out.append(tm)
    if failed:
        raise AssertionError(f"K5's positions-only g_pos differs from the full backward's or the plain version's: "
                             f"{failed}")
    return dict(per_launch=out)


def _plain_cell_pos_vjp(cells, pos, res, table, g):
    from uncertainty_nerf_gs_torch.ops import encodings as enc

    p = pos.detach().requires_grad_(True)
    with torch.enable_grad():
        return torch.autograd.grad(enc.cell_lookup_reference(cells, p, res, table, 2), [p], g)[0]


def check_png_dir(label, directory) -> int:
    """Every PNG under ``directory`` decodes (``data/png.py::read_png``);
    returns how many."""
    from uncertainty_nerf_gs_torch.data.png import read_png

    files = sorted(Path(directory).glob("*.png"))
    for p in files:
        img = read_png(p)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise AssertionError(f"{label}: {p.name} decodes to {img.dtype} {img.shape}")
    if not files:
        raise AssertionError(f"{label}: no PNG written under {directory}")
    print(f"{label}: {len(files)} PNGs written by the port's codec decode ({', '.join(p.name for p in files[:6])}, ...)")
    return len(files)


def run_corner(name, cli, other=None, k5_pos=None) -> dict:
    """The corner phase, on the CLI phase's Blender tree: K7/K8 at the
    corner layout's full-width shapes (``check_corner_grid``) and K5's
    positions-only mode (``k5_positions_only_times``); full-width
    active-nerfacto with ``--overrides '{"grid_layout": "corner"}'`` trained
    by ``scripts.train.main`` (CORNER_STEPS at CLI_K a launch, K1 2, K7 3
    and K8 3 a step) and a seed-1 run of CORNER_SHORT; from the trained
    state a step against its plain path, two steps from one state, CLI_K
    steps as one graph launch against CLI_K single steps, and the step
    profiled; then ``scripts.eval_uncertainty.main`` on the two runs as an
    ensemble with ``--save-rendered-images`` (per member: K1 2 and K7 3 a
    chunk a member; every PNG decodes) and on the run alone, its PSNR
    printed beside the cell-layout CLI run's (``cli``: the CLI phase's
    result) for the record. ``other``: another checkout's K7/K8, timed in
    turns with this one's (``other_corner``). ``k5_pos``: the positions-only
    mode's result where the caller measured it already (early in a run,
    where the profiler still traces every kernel)."""
    from uncertainty_nerf_gs_torch.engine import checkpointing as ck
    from uncertainty_nerf_gs_torch.ops import backend
    from uncertainty_nerf_gs_torch.ops.encodings import corner_is_dense
    from uncertainty_nerf_gs_torch.scripts.train import build_trainer

    device = torch.device("cuda")
    runs: dict[str, dict] = {}
    scene = cli["dirs"]["scene"]
    corner = json.dumps({"grid_layout": "corner"})

    def train_args(out, steps, *extra):
        return ["active-nerfacto", "--data", scene, "--dataparser", "blender-data", "--output-dir", CLI_DIR / out,
                "--max-num-iterations", steps, "--steps-per-save", steps, "--steps-per-launch", CLI_K,
                "--log-every", CLI_K, "--overrides", corner, *extra]

    run = cli_train("corner", train_args("corner", CORNER_STEPS), runs)
    want = {n: CORNER_STEPS * v for n, v in CORNER_STEP_LAUNCHES.items()}
    got = {n: runs["corner"]["launches"][n] for n in want}
    if got != want or runs["corner"]["launches"]["cell_lookup_fwd"]:
        raise AssertionError(f"the corner run's launches {runs['corner']['launches']}, expected {want}")
    seed1 = cli_train("corner_seed1", train_args("corner_seed1", CORNER_SHORT, "--seed", 1), runs)

    trainer, _, _ = build_trainer("active-nerfacto", scene, "blender-data", config_overrides={"grid_layout": "corner"})
    trainer.restore(ck.load_latest(run)[0])
    n_params = sum(p.numel() for p in trainer.model.parameters())
    enc = trainer.model.field.encoding
    dense = [int(r) for r in enc.resolutions if corner_is_dense(int(r), enc.table_size)]
    print(f"corner trainer: {n_params} parameters; the main field's table {tuple(enc.table.shape)}, "
          f"{enc.table.numel()} parameters, {enc.table.numel() * 4 / 1e6:.1f} MB; dense levels at res {dense}")
    grid = check_corner_grid(trainer.config, device, capture_lookup_positions(trainer), other)
    if k5_pos is None:
        k5_pos = k5_positions_only_times(trainer.config, device, other)
    step_plain = check_nerfacto_train_plain(trainer)
    repeat = check_nerfacto_repeatable(trainer)
    if {k: repeat["launches"][k] for k in CORNER_STEP_LAUNCHES} != CORNER_STEP_LAUNCHES:
        raise AssertionError(f"a repeated corner step launched {repeat['launches']}, expected {CORNER_STEP_LAUNCHES}")
    graph = check_cli_graph(trainer, name, CORNER_STEP_LAUNCHES)
    backend.reset_launch_counts()
    traced = profile_top("corner train step", lambda: trainer.train_step(NERF_RAYS), CORNER_SYMBOLS)
    busy_ms = 1e-3 * sum(us for _, us in traced.values()) if traced else None
    del trainer
    torch.cuda.empty_cache()

    images = CLI_DIR / "corner_images"
    cli_eval("corner_eval_ensemble", ["--load-config", run, "--load-config", seed1, "--output-path",
                                      CLI_DIR / "corner_ens.json", "--save-rendered-images",
                                      "--render-output-path", images], runs)
    lc = runs["corner_eval_ensemble"]["launches"]
    # per member: a chunk's K1 2 and K7 3 for each of the two members; no K6, no K4
    if (lc["packed_cell_lookup_fwd"] or lc["packed_cell_lookup_strided"] or lc["cell_lookup_fwd"]
            or not lc["pdf_resample"] or 2 * lc["hash_lookup_fwd"] != 3 * lc["pdf_resample"]):
        raise AssertionError(f"corner ensemble eval: launches {lc} off the per-member plan K1 2, K7 3 a member")
    pngs = check_png_dir("corner ensemble eval --save-rendered-images", images)
    single = cli_eval("corner_eval", ["--load-config", run, "--output-path", CLI_DIR / "corner.json"], runs)
    cell_psnr = cli["runs"]["eval_active_nerfacto"]["metrics"]["psnr"] if "eval_active_nerfacto" in cli["runs"] else None
    print(f"corner: PSNR after {CORNER_STEPS} steps (no bar) {single['psnr']:.4f} dB against the cell layout's "
          + (f"{cell_psnr:.4f} dB at the same steps" if cell_psnr is not None else "(not run)")
          + f" on {name}; the corner ensemble's {runs['corner_eval_ensemble']['metrics']['psnr']:.4f} dB")
    return dict(runs=runs, grid=grid, k5_positions_only=k5_pos, step_plain=step_plain, repeat=repeat, graph=graph,
                busy_ms=busy_ms, pngs=pngs, psnr=dict(corner=single["psnr"], cell=cell_psnr), dirs=[run, seed1])


# -- the tools phase: the render, pose-gradient and viewer CLIs ----------------

TOOLS_FRAMES = 3  # frames a trajectory
POSE_CHUNK = 1024  # the pose-gradient CLI's --chunk (its default 256 takes 4x the launches and the time)
# The pose Jacobian on the kernel path against the plain path, on one chunk's
# rays whose lookups stayed in their cells: K4/K7 and K1 give the plain
# versions' bits, so the forwards are the same and the Jacobians differ by
# K5's or K8's position gradient against autograd's. Held entry by entry
# against the chunk's largest |J| and each entry's own, at GRID_GRAD_TOL.
POSE_JAC_TOL = GRID_GRAD_TOL
# A central finite difference of the render along the tangent's direction 0
# (step POSE_FD_STEP) against the Jacobian's column, on the POSE_FD_PIXELS
# pixels of largest |J|, on the corner run. The Jacobian, as the JAX
# package's, holds the samples' distances along the ray (the resampler's
# weights carry no gradient), so the difference renders the moved rays at
# the unmoved render's sample distances (``rgb_at_distances``); a render
# that resamples moves its samples with the pose, and is not the derivative
# asked for. The corner layout's render is continuous in the pose, so the
# quotient converges to the Jacobian; the step moves the finest level's
# positions by about a twentieth of a cell, where the trilinear lookup's
# derivative is piecewise. The cell layout's features jump at every cell
# face, and at this step about half of a ray's weighted samples cross one
# at the finest levels: a difference quotient there measures the jumps, so
# the cell run is held by the plain path's Jacobian alone. The loose bar:
# |FD - J| <= 0.5 |J| + 0.05 max|J| on at least three quarters of the
# pixels.
POSE_FD_STEP, POSE_FD_PIXELS, POSE_FD_SHARE = 1e-4, 16, 0.75


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_render_cli(label, run_dir, traj) -> dict:
    """``scripts.render.main`` on a run: every frame's PNG decodes to what
    the render function returns after ``to_u8``/``colorize`` (the same
    render function, called again: the renders repeat bit for bit); each
    GIF decodes through ``data/gif.py::read_gif`` to its frames, the jet
    maps exactly and rgb within ``UNIFORM_BOUND``."""
    from uncertainty_nerf_gs_torch.data.gif import UNIFORM_BOUND, read_gif
    from uncertainty_nerf_gs_torch.data.png import read_png
    from uncertainty_nerf_gs_torch.ops import backend
    from uncertainty_nerf_gs_torch.scripts import render
    from uncertainty_nerf_gs_torch.scripts.eval_uncertainty import _eval_cameras_and_images, _load_run, build_render_fn

    out = CLI_DIR / f"render_{label}_{traj}"
    outputs = ["rgb", "depth", "rgb_std"]
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(None):
        render.main(["--load-config", str(run_dir), "--output-dir", str(out), "--traj", traj, "--num-frames",
                     str(TOOLS_FRAMES), "--outputs", *outputs])
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in backend.launch_counts.items() if v}
    trainer, spec, run_cfg, _ = _load_run(run_dir)
    eval_outputs, _ = _eval_cameras_and_images(run_cfg)
    traj_json = json.loads((out / "trajectory.json").read_text())
    c2ws = np.asarray(traj_json["c2ws"], np.float32)
    fn = render.orbit_path if traj == "orbit" else render.interpolate_path
    if not np.array_equal(c2ws, fn(eval_outputs.cameras, TOOLS_FRAMES)):
        raise AssertionError(f"render {label} {traj}: trajectory.json differs from the path function's")
    render_fn = build_render_fn(trainer, spec, render.path_cameras(eval_outputs.cameras, c2ws), run_dir=run_dir)
    differ, gif_err = {}, {}
    for i in range(TOOLS_FRAMES):
        outs = render_fn(i)
        for k in outputs:
            want = render.frame_image(k, outs[k])
            got = read_png(out / f"{k}_{i:04d}.png")
            differ[f"{k}_{i}"] = int((got != want).sum()) if got.shape == want.shape else -1
    for k in outputs:
        frames, delays = read_gif(out / f"{k}.gif")
        pngs = np.stack([read_png(out / f"{k}_{i:04d}.png") for i in range(TOOLS_FRAMES)])
        gif_err[k] = int(np.abs(frames.astype(np.int64) - pngs).max()) if frames.shape == pngs.shape else -1
    bad = {k: v for k, v in differ.items() if v}
    print(f"render {label} {traj}: {TOOLS_FRAMES} frames x {outputs} in {wall:.1f} s, launches {launches}; PNG frames "
          f"differing from the render function's u8 images: {bad or 'none'}; GIF frames' largest deviation from the "
          f"PNG frames {gif_err} (bar: rgb {UNIFORM_BOUND}, jet maps 0)")
    if bad or gif_err["rgb"] > UNIFORM_BOUND or gif_err["rgb"] < 0 or any(
            gif_err[k] != 0 for k in outputs if k != "rgb"):
        raise AssertionError(f"render {label} {traj}: frames or GIFs differ")
    del trainer
    torch.cuda.empty_cache()
    return dict(wall_s=wall, launches=launches, gif_err=gif_err)


def pose_jacobians(model, cameras, tangent, plain: bool) -> tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """One chunk's (the first POSE_CHUNK pixels of eval camera 0) Jacobians
    and rgb through ``pose_jacobian_render``'s per-ray backward, on the
    kernel path or inside ``backend.plain_versions()``; and each ray's
    cells (``lookup_cells``)."""
    from uncertainty_nerf_gs_torch.cameras.cameras import generate_rays, pixel_grid
    from uncertainty_nerf_gs_torch.ops import backend
    from uncertainty_nerf_gs_torch.scripts.pose_gradient import _ray_cameras

    device = cameras.camera_to_worlds.device
    px, py = (v[:POSE_CHUNK] for v in pixel_grid(cameras.height, cameras.width, device))
    per_ray = _ray_cameras(cameras, 0, POSE_CHUNK)
    tan = torch.as_tensor(tangent, device=device).expand(POSE_CHUNK, 6).clone().requires_grad_(True)
    with backend.plain_versions() if plain else contextlib.nullcontext():
        rb = generate_rays(per_ray, torch.arange(POSE_CHUNK, device=device), px, py, pose_adjustment=tan,
                           pose_adjustment_mode="SE3")
        rb = rb._replace(camera_indices=torch.zeros(POSE_CHUNK, dtype=torch.int64, device=device))
        out = model(rb, train=False, with_grad=True, return_intermediates=True)
    jac = torch.stack([torch.autograd.grad(out["rgb"][:, c].sum(), tan, retain_graph=c < 2)[0] for c in range(3)], 1)
    cells = model.lookup_cells(rb, [e.detach() for e in out["sdist_list"]])
    return jac.cpu().numpy(), out["rgb"].detach().cpu().numpy(), cells


@torch.no_grad()
def rgb_at_distances(model, rb, edges) -> np.ndarray:
    """The eval render's channel-mean rgb of rays ``rb`` with the main
    field's samples at the spacing edges ``edges`` (another render's
    ``sdist_list[-1]``), in float64: the render that the pose Jacobian
    differentiates, its sample distances held."""
    from uncertainty_nerf_gs_torch.models.nerfacto import _edges_to_samples
    from uncertainty_nerf_gs_torch.ops.sampling import spacing_piecewise, spacing_piecewise_inv

    rb = model._with_planes(rb)
    rs = _edges_to_samples(rb, edges, spacing_piecewise, spacing_piecewise_inv)
    field_out = model.field(rs.positions, rb.directions, rb.camera_indices)
    rgb = model._render(field_out, rs, {}, None, None, False)["rgb"]
    return rgb.mean(-1).cpu().numpy().astype(np.float64)


def check_pose_gradient_cli(label, run_dir) -> dict:
    """``scripts.pose_gradient.main`` on a run (``--magnitude-trans 0.01``,
    direction 0): the maps' shapes, every entry finite, the PNGs decode; its
    backward went through the lookups' positions-only mode (K5's or K8's
    table gradient never launched); on one chunk the kernel path's Jacobian
    against the plain path's (POSE_JAC_TOL, rays that flipped a cell
    excluded); on a corner run, at the POSE_FD_PIXELS pixels of largest
    |J|, a central finite difference of the render (POSE_FD_STEP) against
    the Jacobian's column."""
    from uncertainty_nerf_gs_torch.cameras.cameras import generate_rays, pixel_grid
    from uncertainty_nerf_gs_torch.data.png import read_png
    from uncertainty_nerf_gs_torch.ops import backend
    from uncertainty_nerf_gs_torch.scripts import pose_gradient as pg
    from uncertainty_nerf_gs_torch.scripts.eval_uncertainty import _eval_cameras_and_images, _load_run

    out = CLI_DIR / f"pose_{label}"
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(None):
        pg.main(["--load-config", str(run_dir), "--output-dir", str(out), "--magnitude-trans", "0.01",
                 "--direction", "0", "--chunk", str(POSE_CHUNK)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in backend.launch_counts.items() if v}
    jac = np.load(out / "jacobian_0.npy")
    sens = np.load(out / "sensitivity_0.npy")
    for png in ("render_0.png", "sensitivity_0.png"):
        read_png(out / png)
    trainer, _, run_cfg, _ = _load_run(run_dir)
    eval_outputs, _ = _eval_cameras_and_images(run_cfg)
    cams = eval_outputs.cameras.to(trainer.device)
    h, w = cams.height, cams.width
    corner = trainer.config.grid_layout == "corner"
    full, only = ("hash_lookup_bwd", "hash_lookup_bwd_positions") if corner else ("cell_lookup_bwd",
                                                                                 "cell_lookup_bwd_positions")
    if jac.shape != (h, w, 3, 6) or sens.shape != (h, w) or not (np.isfinite(jac).all() and np.abs(jac).sum() > 0):
        raise AssertionError(f"pose gradient {label}: jacobian {jac.shape}, sensitivity {sens.shape}, or not finite")
    if launches.get(full) or not launches.get(only):
        raise AssertionError(f"pose gradient {label}: launches {launches}; the table gradient must not be formed")
    tangent = pg.get_perturbed_6dof_pose(0.01, 0.0, 0)
    with pg.frozen(trainer.model):
        k_jac, k_rgb, k_cells = pose_jacobians(trainer.model, cams, tangent, plain=False)
        p_jac, p_rgb, p_cells = pose_jacobians(trainer.model, cams, tangent, plain=True)
        keep = ~(k_cells != p_cells).any(dim=1).cpu().numpy()
        scale = np.abs(p_jac[keep]).max()
        miss = np.abs(k_jac - p_jac) > POSE_JAC_TOL["atol"] * scale + POSE_JAC_TOL["rtol"] * np.abs(p_jac)
        bad = int(miss[keep].sum())
        jac_err = float(np.abs(k_jac - p_jac)[keep].max())
        same_cli = np.array_equal(k_jac, jac.reshape(-1, 3, 6)[:POSE_CHUNK])
        fd_note, ok = "", np.ones(1, bool)
        if corner:  # the finite difference, on the pixels of largest |J| along direction 0
            col = jac[..., 0].mean(-1).reshape(-1)
            pix = np.argsort(-np.abs(col))[:POSE_FD_PIXELS]
            px, py = pixel_grid(h, w, cams.camera_to_worlds.device)
            idx = torch.as_tensor(pix, device=px.device)
            per_ray = pg._ray_cameras(cams, 0, len(pix))

            def rays_at(t):
                tan = torch.as_tensor(t, device=px.device).expand(len(pix), 6).contiguous()
                rb = generate_rays(per_ray, torch.arange(len(pix), device=px.device), px[idx], py[idx],
                                   pose_adjustment=tan, pose_adjustment_mode="SE3")
                return rb._replace(camera_indices=torch.zeros(len(pix), dtype=torch.int64, device=px.device))

            edges = trainer.model(rays_at(tangent), return_intermediates=True)["sdist_list"][-1]
            e0 = np.zeros(6, np.float32)
            e0[0] = POSE_FD_STEP
            fd = (rgb_at_distances(trainer.model, rays_at(tangent + e0), edges)
                  - rgb_at_distances(trainer.model, rays_at(tangent - e0), edges)) / (2 * POSE_FD_STEP)
            j = col[pix]
            ok = np.abs(fd - j) <= 0.5 * np.abs(j) + 0.05 * np.abs(col).max()
            fd_note = (f"; finite difference at the {len(pix)} pixels of largest |J|: {int(ok.sum())} within the "
                       f"bar (FD / J: {', '.join(f'{a / b:.3f}' for a, b in zip(fd[:8], j[:8]))}, ...)")
    print(f"pose gradient {label} ({trainer.config.grid_layout} layout): {wall:.1f} s, launches {launches}; "
          f"jacobian {jac.shape}, |J| up to {np.abs(jac).max():.4g}; one chunk's kernel path against the plain "
          f"path: {int((~keep).sum())} of {POSE_CHUNK} rays flipped a cell and are excluded, max_abs_err "
          f"{jac_err:.3e} of {scale:.3e}, {bad} entries outside POSE_JAC_TOL; the CLI's chunk equals the kernel "
          f"path's bit for bit: {same_cli}{fd_note}")
    del trainer
    torch.cuda.empty_cache()
    if bad or not same_cli or ok.mean() < POSE_FD_SHARE:
        raise AssertionError(f"pose gradient {label}: the Jacobian disagrees with the plain path, the CLI or a "
                             "finite difference")
    return dict(wall_s=wall, launches=launches, jac_err=jac_err, jac_scale=float(scale),
                fd_within=int(ok.sum()) if corner else None, flipped=int((~keep).sum()))


def check_viewer(label, run_dirs) -> dict:
    """``scripts.viewer``: ``ViewerState`` on the runs served on port 0 in a
    thread; ``GET /info`` and ``GET /``; ``POST /render`` for every mode
    at an orbit pose: each PNG decodes to ``render_pose``'s image of that
    pose after ``to_u8`` (rgb) or ``colorize`` in the mode's frozen window."""
    import threading
    import urllib.request

    from uncertainty_nerf_gs_torch.data.png import read_png
    from uncertainty_nerf_gs_torch.ops import backend
    from uncertainty_nerf_gs_torch.scripts import viewer
    from uncertainty_nerf_gs_torch.utils.images import colorize, to_u8

    state = viewer.ViewerState([Path(d) for d in run_dirs], downscale=2)
    server = viewer.serve(state, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    differ, launches = {}, {}
    try:
        info = json.loads(urllib.request.urlopen(base + "/info", timeout=120).read())
        page = urllib.request.urlopen(base + "/", timeout=120).read()
        c2w = orbit_pose(info["center"], info["radius"])
        for mode in info["modes"]:
            backend.reset_launch_counts()
            req = urllib.request.Request(base + "/render", headers={"content-type": "application/json"},
                                         data=json.dumps({"c2w": c2w.tolist(), "mode": mode}).encode())
            png = urllib.request.urlopen(req, timeout=300).read()
            launches[mode] = {k: v for k, v in backend.launch_counts.items() if v}
            got = read_png(png)
            arr = state.render_pose(c2w)[mode]
            want = to_u8(arr) if mode == "rgb" else colorize(arr, *state._windows[mode])
            differ[mode] = int((got != want).sum()) if got.shape == want.shape else -1
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    print(f"viewer {label}: {info['method']}, {info['num_members']} member(s), {info['width']}x{info['height']}, "
          f"modes {info['modes']}; the page {len(page)} bytes; PNG bytes off render_pose's image by mode {differ}; "
          f"launches by mode {launches}")
    if any(differ.values()) or b"ut-viewer" not in page:
        raise AssertionError(f"viewer {label}: a served PNG differs from render_pose's image: {differ}")
    return dict(modes=info["modes"], launches=launches)


def orbit_pose(center, radius, az=0.5, el=0.3) -> np.ndarray:
    """The page's orbit camera (tests/test_viewer.py's ``_orbit_pose``)."""
    o = np.array(center) + radius * np.array([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)])
    f = np.array(center) - o
    f /= np.linalg.norm(f)
    r = np.array([f[1], -f[0], 0.0])
    r /= max(np.linalg.norm(r), 1e-8)
    u = np.cross(r, f)
    return np.stack([r, u, -f, o], axis=1).astype(np.float32)


def check_live_viewer(scene) -> dict:
    """``scripts.train.main --viewer-port`` (a free port; 0 is off, as in the
    JAX package) for CORNER_SHORT steps at CLI_K a launch, a checkpoint every
    CLI_K, with a client requesting rgb frames all through the run: frames
    render between launches (``LiveViewerState.rendered_at`` holds steps
    between 0 and the last), and the run's checkpoint equals a run without
    the viewer bit for bit."""
    import threading
    import urllib.request

    from uncertainty_nerf_gs_torch.engine import checkpointing as ck
    from uncertainty_nerf_gs_torch.scripts import viewer

    def args(out, *extra):
        return ["active-nerfacto", "--data", str(scene), "--dataparser", "blender-data", "--output-dir",
                str(CLI_DIR / out), "--max-num-iterations", str(CORNER_SHORT), "--steps-per-save", str(CLI_K),
                "--steps-per-launch", str(CLI_K), "--log-every", "0", "--seed", "1", *extra]

    runs: dict[str, dict] = {}
    plain = cli_train("live_reference", args("live_reference"), runs)
    states, done, frames = [], threading.Event(), []
    serve = viewer.serve

    def recording_serve(state, *a, **kw):
        states.append(state)
        return serve(state, *a, **kw)

    port = free_port()

    def client():
        base = f"http://127.0.0.1:{port}"
        while not done.is_set():
            try:
                info = json.loads(urllib.request.urlopen(base + "/info", timeout=60).read())
                req = urllib.request.Request(base + "/render", headers={"content-type": "application/json"},
                                             data=json.dumps({"c2w": orbit_pose(info["center"], info["radius"])
                                                              .tolist(), "mode": "rgb"}).encode())
                frames.append((info["step"], urllib.request.urlopen(req, timeout=120).read()))
            except OSError:
                time.sleep(0.05)  # the server is not up yet, or has gone

    thread = threading.Thread(target=client, daemon=True)
    viewer.serve = recording_serve
    thread.start()
    try:
        live = cli_train("live_viewer", args("live_viewer", "--viewer-port", str(port)), runs)
    finally:
        viewer.serve = serve
        done.set()
        thread.join(timeout=120)
    rendered = states[0].rendered_at if states else []
    between = [s for s in rendered if 0 < s < CORNER_SHORT]
    a, b = ck.load_checkpoint(ck.checkpoint_path(plain, CORNER_SHORT)), ck.load_checkpoint(
        ck.checkpoint_path(live, CORNER_SHORT))
    differ: dict = {}
    items = _tree_differ("", a, b, differ)
    print(f"live viewer: {len(frames)} frames served during the run ({len(rendered)} renders at steps "
          f"{sorted(set(rendered))}); {len(between)} between launches; the run's step-{CORNER_SHORT:09d}.ckpt against "
          f"the run without the viewer: {len(differ)} of {items} items differ")
    if not between or differ or not all(png[:4] == b"\x89PNG" for _, png in frames):
        raise AssertionError(f"live viewer: {len(between)} frames between launches, {list(differ)[:8]} differ")
    return dict(frames=len(frames), rendered_at=sorted(set(rendered)), runs=runs)


def run_tools(cli, corner) -> dict:
    """The tools phase, on runs the CLI and corner phases trained:
    ``scripts.render`` (orbit and interpolate, rgb, depth and rgb_std) on a
    nerfacto run and a splat run; ``scripts.pose_gradient`` on a cell run and
    a corner run; ``scripts.viewer`` on a single run and a two-member fused
    ensemble, and live under ``scripts.train --viewer-port``."""
    dirs = cli["dirs"]
    out = dict(render={}, pose={}, viewer={})
    for traj in ("orbit", "interpolate"):
        out["render"][f"nerfacto_{traj}"] = check_render_cli("nerfacto", dirs["straight"], traj)
        out["render"][f"splat_{traj}"] = check_render_cli("splat", dirs["splat"], traj)
    out["pose"]["cell"] = check_pose_gradient_cli("cell", dirs["straight"])
    out["pose"]["corner"] = check_pose_gradient_cli("corner", corner["dirs"][0])
    out["viewer"]["single"] = check_viewer("single", [dirs["straight"]])
    out["viewer"]["ensemble"] = check_viewer("fused ensemble", [dirs["straight"], dirs["seed1"]])
    out["live"] = check_live_viewer(dirs["scene"])
    return out


def corner_kernel_entries(corner) -> list[dict]:
    """K7, K8, K8's positions-only mode and K5's positions-only mode, each
    an entry of the kernels line, launches 0 until the paths' counts are
    added: times of a step's three calls at a training forward's positions
    (K7, K8 and K8's positions-only mode), and K5's positions-only mode's
    three at uniform positions."""
    src = "uncertainty_nerf_gs_torch/csrc/hash_grid.cu"
    grid = corner["grid"]

    def entry(name, replaces, calls, err, tpu=False, **extra):
        return dict(name=name, route="cuda", source=src, replaces=replaces, tpu_kernel=tpu, launches=0,
                    launches_by_path={}, max_abs_err=err, ms=sum(c["ms"] for c in calls),
                    plain_ms=sum(c["plain_ms"] for c in calls), bound_ms=sum(c["bound_ms"] for c in calls),
                    bound_by=calls[-1]["bound_by"], per_launch=calls, **extra)

    lookup = "uncertainty_nerf_gs_tpu/ops/encodings.py:123"
    training = [p["training"] for p in grid["per_launch"]]
    fwd = [t["fwd"] for t in training]
    return [
        entry("hash_lookup_fwd", lookup, fwd, grid["fwd_err"],
              library_ms=sum(c["library_ms"] for c in fwd),  # F.embedding_bag(mode="sum", per_sample_weights=)
              every_read_bound_ms=sum(c["every_read_bound_ms"] for c in fwd)),
        entry("hash_lookup_bwd", lookup, [t["bwd"] for t in training], grid["bwd_err"], library_ms=None,
              deterministic=True, every_read_bound_ms=sum(t["bwd"]["every_read_bound_ms"] for t in training)),
        entry("hash_lookup_bwd_positions", lookup, [t["positions_only"] for t in training], grid["bwd_err"],
              library_ms=None,
              every_read_bound_ms=sum(t["positions_only"]["every_read_bound_ms"] for t in training)),
        entry("cell_lookup_bwd_positions", "experiments/jobs/403_pallas_gather_probe.py:96",
              corner["k5_positions_only"]["per_launch"], grid["bwd_err"], tpu=True, library_ms=None),
    ]


def kernel_line(run_nerf, train_nerf, resample, nerf_plain, run_splat_, refine, splat_ens, comp, grid,
                ens, gather, methods) -> list[dict]:
    """``methods``: path -> the launch counts of the other nerfacto-family
    methods' runs (MC-dropout, Laplace), added to K1's, K4's and K5's."""
    per = resample["per_launch"]
    # one chunk's two launches as the render makes them: 256 -> 97 with u
    # and edges shared, 96 -> 49 with u shared, at 4096 rays
    render = [p for p in per if p["layout"] == "render"]
    kernels = [dict(
        name="pdf_resample", route="cuda",
        source="uncertainty_nerf_gs_torch/csrc/pdf_resample.cu",
        replaces="uncertainty_nerf_gs_tpu/ops/pdf_pallas.py:120",
        launches=run_nerf["launches"]["pdf_resample"] + train_nerf["launches"]["pdf_resample"]
        + sum(v["pdf_resample"] for v in ens["launches"].values())
        + sum(v["pdf_resample"] for v in methods.values()),
        launches_by_path=dict(render=run_nerf["launches"]["pdf_resample"],
                              train=train_nerf["launches"]["pdf_resample"],
                              **{f"ensemble_{k}": v["pdf_resample"] for k, v in ens["launches"].items()},
                              **{k: v["pdf_resample"] for k, v in methods.items()}),
        max_abs_err=max(resample["max_abs_err"], nerf_plain["edge_err"]),
        ms=sum(p["ms"] for p in render), plain_ms=sum(p["plain_ms"] for p in render),
        bound_ms=sum(p["bound_ms"] for p in render), bound_by=render[0]["bound_by"],
        library_ms=None,  # no single PyTorch call computes this function
        floor_ms=sum(p["floor_ms"] for p in render),
        per_launch=per,
    )]
    full = comp["times"]["full_width"]
    shown = ("ms", "plain_ms", "bound_ms", "bound_by", "shape", "rows", "ms_from")
    for name, key, replaces in (
        ("composite_fwd", "fwd", "uncertainty_nerf_gs_tpu/ops/rasterize_pallas.py:296"),
        ("composite_bwd", "bwd", "uncertainty_nerf_gs_tpu/ops/rasterize_pallas.py:329"),
    ):
        tm, tuned, ens_k2 = full[key], refine["tuned"][key], splat_ens["k2"]
        err = max(comp[f"{key}_err"], refine["tuned"][f"{key}_err"], ens_k2[f"{key}_err"])
        by_path = dict(splat=run_splat_["launches"][name], splat_refine=refine["launches"][name],
                       splat_ensemble=splat_ens["eval_launches"][name])
        entry = dict(
            name=name, route="cuda",
            source="uncertainty_nerf_gs_torch/csrc/composite_tiles.cu",
            replaces=replaces, launches=sum(by_path.values()), launches_by_path=by_path, max_abs_err=err,
            ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=tm["bound_ms"], bound_by=tm["bound_by"],
            library_ms=None,  # no single PyTorch call computes this function
            c1=comp["times"]["full_width_c1"][key],
            event_ms=tm["event_ms"], ms_from=tm["ms_from"], rows=tm["rows"],
            tuned_capacity={k: tuned[k] for k in shown},
        )
        if key == "fwd":
            entry.update(ensemble_capacity={k: ens_k2[k] for k in shown})
        kernels.append(entry)
    # a chunk's (or a step's) three lookups: proposal 0, proposal 1, field
    for name, key, err in (("cell_lookup_fwd", "fwd", grid["fwd_err"]),
                           ("cell_lookup_bwd", "bwd", grid["bwd_err"])):
        per = [p[key] for p in grid["per_launch"]]
        by_path = dict(render=run_nerf["launches"][name], train=train_nerf["launches"][name],
                       **{f"ensemble_{k}": v[name] for k, v in ens["launches"].items()},
                       **{k: v[name] for k, v in methods.items()})
        entry = dict(
            name=name, route="cuda", source="uncertainty_nerf_gs_torch/csrc/hash_grid.cu",
            replaces="experiments/jobs/403_pallas_gather_probe.py:96",
            launches=sum(by_path.values()), launches_by_path=by_path, max_abs_err=err,
            ms=sum(p["ms"] for p in per), plain_ms=sum(p["plain_ms"] for p in per),
            bound_ms=sum(p["bound_ms"] for p in per), bound_by=per[-1]["bound_by"],
            # no single PyTorch call computes this function; index_select of
            # the same rows (K4) and K5's partial yardsticks are in per_launch
            library_ms=None, per_launch=per,
        )
        if key == "fwd":
            # a chunk's three calls at the positions the main path feeds K4
            entry.update(by_positions={label: dict(
                ms=sum(p[k]["ms"] for p in grid["per_launch"]),
                bound_ms=sum(p[k]["bound_ms"] for p in grid["per_launch"]),
                index_select_ms=sum(p[k]["library_ms"] for p in grid["per_launch"]),
                per_launch=[p[k] for p in grid["per_launch"]],
            ) for label, k in (("uniform", "fwd"), ("training", "fwd_training"), ("render", "fwd_render"))})
        if key == "bwd":
            clustered = [p["bwd_clustered"] for p in grid["per_launch"]]
            entry.update(deterministic=True, clustered_ms=sum(p["ms"] for p in clustered),
                         clustered_bound_ms=sum(p["bound_ms"] for p in clustered),
                         per_launch_clustered=clustered)
        kernels.append(entry)
    # a fused chunk's K6 launches at a render chunk's positions: the field's
    # dense call, the proposals' strided calls
    for name, kind, symbol in (("packed_cell_lookup_fwd", "dense", K6_SYMBOL),
                               ("packed_cell_lookup_strided", "strided", K6S_SYMBOL)):
        per = [t for t in ens["k6"]["render"] if t["kind"] == kind]
        entry = dict(
            name=name, route="cuda", source="uncertainty_nerf_gs_torch/csrc/hash_grid.cu",
            replaces="experiments/jobs/403_pallas_gather_probe.py:96", symbol=symbol,
            launches=sum(v[name] for v in ens["launches"].values()),
            launches_by_path={f"ensemble_{k}": v[name] for k, v in ens["launches"].items()},
            max_abs_err=ens["k6"]["err"],
            ms=sum(p["ms"] for p in per), plain_ms=sum(p["plain_ms"] for p in per),
            bound_ms=sum(p["bound_ms"] for p in per), bound_by=per[-1]["bound_by"],
            # index_select of the same packed rows: a yardstick, not the function
            library_ms=None, index_select_ms=sum(p["library_ms"] for p in per), per_launch=per,
        )
        if kind == "dense":
            entry.update(uniform=ens["k6"]["times"])
        else:
            entry.update(strides=ens["plan"], field_strided=ens["k6"]["main_stride"])
        kernels.append(entry)
    # the splat gather's backward: not a TPU kernel (the JAX package's is
    # XLA's transpose of the gather at the line named); timed at the tuned
    # capacity, where the refining steps run it, and at 384 and the
    # splat ensemble's eval capacity
    shapes = dict(capacity_384=gather, tuned_capacity=refine["gather"], eval_capacity=splat_ens["gather"])
    tuned = refine["gather"]
    by_path = dict(splat=run_splat_["launches"]["packed_rows_bwd"],
                   splat_refine=refine["launches"]["packed_rows_bwd"])
    kernels.append(dict(
        name="packed_rows_bwd", route="cuda", source="uncertainty_nerf_gs_torch/csrc/packed_rows.cu",
        replaces="uncertainty_nerf_gs_tpu/ops/rasterize.py:441", tpu_kernel=False,
        launches=sum(by_path.values()), launches_by_path=by_path,
        max_abs_err=max(v["max_abs_err"] for v in shapes.values()), deterministic=True,
        ms=tuned["ms"], plain_ms=tuned["plain_ms"], bound_ms=tuned["bound_ms"], bound_by="bytes",
        library_ms=tuned["library_ms"],  # F.embedding's backward (embedding_dense_backward)
        event_ms=tuned["event_ms"], shape=tuned["shape"], live=tuned["live"],
        by_shape={k: {f: v[f] for f in ("ms", "event_ms", "plain_ms", "library_ms", "bound_ms", "shape", "live",
                                         "max_abs_err", "graph_replay_live", "longest_run", "turns") if f in v}
                  for k, v in shapes.items()},
    ))
    return kernels


def splat_repeatable_only(name) -> int:
    """``--splat-repeatable-only [CHECKOUT]``: ``check_splat_repeatable`` in
    its three places (the splat scene at capacity 384 after its five steps;
    the refining scene after the refines at steps 20 and 70), with this
    checkout's package or CHECKOUT's, each result printed and none
    required; a JSON line of the results last."""
    import uncertainty_nerf_gs_torch
    from uncertainty_nerf_gs_torch.ops import backend

    print(f"package: {Path(uncertainty_nerf_gs_torch.__file__).parent} on {name}")
    backend.build_kernels()
    results = []
    splat = build_splat()
    for _ in range(SPLAT_STEPS):
        splat.train_step()
    results.append(check_splat_repeatable(splat, "at capacity 384", required=False))
    del splat
    refining = build_splat_refine()
    for _ in range(REFINE_STEPS):
        refining.train_step()
        if refining.step in (REFINES[0], REFINES[-1]):
            results.append(check_splat_repeatable(refining, f"after the refine at step {refining.step}",
                                                  required=False))
    print(json.dumps({"splat_repeatable": results}))
    return 0


def corner_only(name, against) -> int:
    """``--corner-only [--corner-against CHECKOUT]``: the corner phase alone
    (``run_corner``) on a Blender tree of the CLI phase's size, with
    ``against``'s K7 and K8 timed in turns where given; the corner kernels'
    entries of the kernels line last. No PSNR of the cell layout beside."""
    import shutil

    from uncertainty_nerf_gs_torch.data.synthetic import write_blender_dataset
    from uncertainty_nerf_gs_torch.ops import backend

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build = other_corner(against) if against else None
    for kernel, report in backend.build_kernels().items():
        for line in ptxas_summary(report, "hash_lookup_"):
            print(f"K7/K8 ptxas: {line}")
    other = build() if build else None
    print(f"build: {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    scene = write_blender_dataset(CLI_DIR / "scene", CLI_TRAIN_VIEWS, CLI_TEST_VIEWS, CLI_SIZE, CLI_SIZE)
    corner = run_corner(name, dict(dirs=dict(scene=scene), runs={}), other)
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    kernels = corner_kernel_entries(corner)
    for entry in kernels:
        for label, r in corner["runs"].items():
            n = r["launches"].get(entry["name"], 0)
            if n:
                entry["launches_by_path"][f"cli_{label}"] = n
                entry["launches"] += n
    print(f"corner done at {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [e for e in kernels if e["launches"]]}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    corner_against = None
    if "--corner-against" in args[:-1]:
        at = args.index("--corner-against")
        corner_against = args[at + 1]
        del args[at:at + 2]
    if args == ["--corner-only"]:
        return corner_only(card(), corner_against)
    if args[:1] == ["--splat-repeatable-only"] and len(args) <= 2:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return splat_repeatable_only(card())
    if args == ["--ensemble-train-only"]:
        from uncertainty_nerf_gs_torch.ops import backend

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        name = card()
        backend.build_kernels()
        ens_train = run_ensemble_train(torch.device("cuda"), name)
        print(json.dumps({"ensemble_train": ensemble_train_summary(ens_train),
                          "launches_by_path": ensemble_train_paths(ens_train)}))
        return 0
    if args == ["--sparse-only"]:
        from uncertainty_nerf_gs_torch.ops import backend

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        name = card()
        backend.build_kernels()
        sparse = run_sparse(name)
        print(json.dumps({"kernels": sparse_kernel_entries(sparse)}))
        return 0
    if args and (len(args) != 2 or args[0] != "--k4-against"):
        print(__doc__, file=sys.stderr)
        return 2
    from uncertainty_nerf_gs_torch.ops import backend

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # the SSIM convolution
    name = card()
    print(f"card: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    other_build = other_k4(args[1]) if args else None
    corner_build = other_corner(corner_against) if corner_against else None
    for kernel, report in backend.build_kernels().items():
        print(f"built {kernel}:\n{report.strip()}")
        for line in ptxas_summary(report, "cell_lookup_fwd_kernel"):
            print(f"K4 ptxas: {line}")
        for line in ptxas_summary(report, "packed_lookup_"):
            print(f"K6 ptxas: {line}")
    other = other_build() if other_build else None
    other_k7 = corner_build() if corner_build else None
    print(f"build: {time.perf_counter() - t0:.1f} s")
    device = torch.device("cuda")

    resample = check_resampler(device)
    t0 = time.perf_counter()
    splat = build_splat()
    print(f"active-splatfacto: {sum(p.numel() for p in splat.params.values())} parameters, "
          f"{int(splat.splat_state.alive.sum())} live Gaussians; set-up {time.perf_counter() - t0:.1f} s")
    comp = check_compositor(splat, device)
    print(f"kernel checks done at {time.perf_counter() - t_start:.1f} s")

    t0 = time.perf_counter()
    nerf = build_nerfacto()
    n_params = sum(p.numel() for p in nerf.model.parameters())
    print(f"active-nerfacto: {n_params} parameters; set-up {time.perf_counter() - t0:.1f} s")
    grid = check_hash_grid(nerf.config, device, capture_lookup_positions(nerf),
                           capture_render_positions(nerf), other)
    # K5's positions-only mode (the pose gradient's), timed here: late in a
    # long run the profiler has been seen to trace none of its kernels
    k5_pos = k5_positions_only_times(nerf.config, device, other_k7)
    print(f"hash-grid checks done at {time.perf_counter() - t_start:.1f} s")
    run_nerf = render_nerfacto(nerf)
    for i, s in enumerate(run_nerf["seconds"]):
        print(f"nerfacto image {i}: {1e3 * s:.1f} ms/image, {run_nerf['rays'] / s:.0f} rays/s "
              f"({run_nerf['chunks']} chunks of {nerf.config.eval_num_rays_per_chunk}) on {name}")
    nerf_plain = check_nerfacto_plain_chunk(nerf)
    profile_nerfacto(nerf)
    train_nerf = train_nerfacto(nerf, name)
    check_nerfacto_train_plain(nerf)
    repeat = check_nerfacto_repeatable(nerf)
    want = dict(pdf_resample=2, cell_lookup_fwd=3, cell_lookup_bwd=3)
    if any(repeat["launches"][k] != v for k, v in want.items()):
        raise AssertionError(f"a repeated step launched {repeat['launches']}, expected {want}")
    audit_determinism(nerf)
    step = profile_top("nerfacto train step", lambda: nerf.train_step(NERF_RAYS), NERF_SYMBOLS)
    k5 = [(c, us) for k, (c, us) in step.items() if NERF_SYMBOLS["cell_lookup_bwd"] in k]
    print(f"  K5 in the step: {1e-3 * sum(us for _, us in k5):.3f} ms for its 3 calls "
          f"({sum(c for c, _ in k5)} kernels)")
    check_bf16(nerf, name)
    del nerf
    torch.cuda.empty_cache()
    print(f"nerfacto done at {time.perf_counter() - t_start:.1f} s")
    mcd = run_mcdropout(name)
    print(f"nerfacto-mcdropout done at {time.perf_counter() - t_start:.1f} s")
    lap = run_laplace(name)
    print(f"nerfacto-laplace done at {time.perf_counter() - t_start:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    run = run_splat(splat, name)
    check_splat_plain(splat)
    captured = capture_gather(splat)
    gather = check_packed_rows("at capacity 384", captured, torch.Generator(device=device).manual_seed(SEED + 13),
                               capture_gather(splat, cam_idx=3), other_k7)
    repeat_splat = check_splat_repeatable(splat, "at capacity 384")
    audit_splat_determinism(splat, captured)
    del captured
    profile_splat(splat)
    print(f"splat done at {time.perf_counter() - t_start:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    t0 = time.perf_counter()
    refining = build_splat_refine()
    print(f"splat refine: {int(refining.splat_state.alive.sum())} live Gaussians in {refining.config.capacity} "
          f"slots; set-up {time.perf_counter() - t0:.1f} s")
    refine = run_splat_refine(refining, name, other_k7)
    del refining
    torch.cuda.empty_cache()
    print(f"splat refine done at {time.perf_counter() - t_start:.1f} s")
    splat_ens = run_splat_ensemble(device, name, other_k7)
    torch.cuda.empty_cache()
    print(f"splat ensemble done at {time.perf_counter() - t_start:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    from uncertainty_nerf_gs_torch.ops import encodings as enc

    for f in enc.PACKED_FEATURES:
        print(f"K6 dynamic shared memory a block (M = {NUM_MEMBERS}, F = {f}): " + ", ".join(
            f"{enc._entry('packed_cell_lookup_shared_bytes')(levels, NUM_MEMBERS, f, 0)} B at L = {levels}"
            for levels in (5, 16)))
    ens = run_ensemble(device, name, other)
    print(f"ensemble done at {time.perf_counter() - t_start:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    torch.cuda.empty_cache()
    ens_train = run_ensemble_train(device, name)
    torch.cuda.empty_cache()
    print(f"ensemble training, its render and the mesh forms done at {time.perf_counter() - t_start:.1f} s")

    cli = run_cli(name)
    print(f"cli done at {time.perf_counter() - t_start:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    corner = run_corner(name, cli, other_k7, k5_pos)
    print(f"corner done at {time.perf_counter() - t_start:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    tools = run_tools(cli, corner)
    import shutil

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    print(f"tools done at {time.perf_counter() - t_start:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    sparse = run_sparse(name)
    print(f"sparse done at {time.perf_counter() - t_start:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    methods = dict(mcdropout_train=mcd["train"]["launches"], mcdropout_image=mcd["mc"]["launches"],
                   mcdropout_deterministic_image=mcd["single"]["launches"], laplace_fit=lap["fit_launches"],
                   laplace_image=lap["image"]["launches"])
    kernels = kernel_line(run_nerf, train_nerf, resample, nerf_plain, run, refine, splat_ens, comp, grid, ens,
                          gather, methods)
    # the CLI phase's runs, a path each; of the sparse phase's, the cell run
    # and its eval, and every run's K1 (its hybrid K4/K5 and its K6 have
    # entries of their own)
    paths = dict(cli["runs"], **{k: v for k, v in sparse["runs"].items() if k in ("sparse_cell", "sparse_eval_cell")})
    kernels += corner_kernel_entries(corner)
    # the corner phase's runs and the tools phase's, paths of their own
    tool_runs = {f"render_{k}": v for k, v in tools["render"].items()}
    tool_runs.update({f"pose_gradient_{k}": v for k, v in tools["pose"].items()})
    tool_runs.update({f"viewer_{k}_{m}": dict(launches=n) for k, v in tools["viewer"].items()
                      for m, n in v["launches"].items()})
    tool_runs.update(tools["live"]["runs"])
    paths.update(corner["runs"])
    paths.update(tool_runs)
    for entry in kernels:
        for label, r in paths.items():
            n = r["launches"].get(entry["name"], 0)
            if n:
                entry["launches_by_path"][f"cli_{label}"] = n
                entry["launches"] += n
    for label, r in sparse["runs"].items():
        if label not in paths and r["launches"].get("pdf_resample"):
            kernels[0]["launches_by_path"][f"cli_{label}"] = r["launches"]["pdf_resample"]
            kernels[0]["launches"] += r["launches"]["pdf_resample"]
    kernels += sparse_kernel_entries(sparse)
    for label, launches in ensemble_train_paths(ens_train).items():
        for entry in kernels:
            n = launches.get(entry["name"], 0)
            if n:
                entry["launches_by_path"][label] = n
                entry["launches"] += n
    unlaunched = [e["name"] for e in kernels if not e["launches"]]
    if unlaunched:
        raise AssertionError(f"kernels of the path never launched: {unlaunched}")
    print(json.dumps({"cli": {k: {f: v for f, v in r.items() if f != "launches"} for k, r in cli["runs"].items()},
                      "graph": cli["graph"], "grad_checkpoint_peak_gb": cli["memory"]}))
    print(json.dumps({"sparse": {
        "runs": {k: {f: v for f, v in r.items() if f != "launches"} for k, r in sparse["runs"].items()},
        "graph": sparse["graph"], "expansion": sparse["expansion"], "step_busy_ms": sparse["busy_ms"],
        "psnr": sparse["psnr"], "metrics_by_table_dtype": sparse["metrics"],
        "step_plain_max_grad_l2_err": sparse["step_plain"]["max_grad_l2_err"]}}))
    print(json.dumps({"corner": {
        "runs": {k: {f: v for f, v in r.items() if f != "launches"} for k, r in corner["runs"].items()},
        "graph": corner["graph"], "step_busy_ms": corner["busy_ms"], "psnr": corner["psnr"],
        "step_plain_max_grad_l2_err": corner["step_plain"]["max_grad_l2_err"]},
        "tools": {"render": {k: {f: v for f, v in r.items() if f != "launches"} for k, r in tools["render"].items()},
                  "pose_gradient": {k: {f: v for f, v in r.items() if f != "launches"}
                                    for k, r in tools["pose"].items()},
                  "viewer_modes": {k: v["modes"] for k, v in tools["viewer"].items()},
                  "live_frames": tools["live"]["frames"], "live_rendered_at": tools["live"]["rendered_at"]}}))
    print(json.dumps({"ensemble_train": ensemble_train_summary(ens_train)}))
    print(json.dumps({"kernels": kernels}))
    print(name)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
