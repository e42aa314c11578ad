"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--k4-against OTHER_CHECKOUT]

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
a step, and profiles one image and one step. Exits non-zero, with no result
line, when there is no card or any phase fails. The last line of standard
output is a JSON object naming the device; the line before it the card's
name and power limit; before that a ``{"kernels": [...]}`` line with each
kernel's launches, error, times and bound.

``--k4-against OTHER_CHECKOUT`` also builds that checkout's ``uncertainty_
nerf_gs_torch/csrc/hash_grid.cu`` (for example the parent commit unpacked
with ``git archive``; it must have the same ``cell_lookup_fwd_f32`` entry
point), holds its K4 within TOL of the plain version and times it in turns
with this K4 at every shape and position set K4 is timed at.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from torch_parity import (  # noqa: E402  (the tolerances the CPU tests hold)
    GRID_GRAD_TOL,
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
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for e in prof.key_averages():
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


def kernel_times(name, kernel, plain, sets, symbol) -> dict:
    """A kernel's and its plain version's time per call over ``sets``: device
    time from the profiler where it traced the device, else CUDA events. The
    kernel's time is the sum of every device kernel whose name holds
    ``symbol`` (a pipeline of several kernels shares one prefix), per call;
    ``parts`` holds each of them, ``others`` what else the wrapper ran (a
    zero-fill) per call."""
    event_ms = time_ms(kernel, sets)
    plain_event_ms = time_ms(plain, sets)
    traced, _ = device_kernels(lambda: [kernel(*a) for a in sets])
    own = {k: v for k, v in traced.items() if symbol in k}
    plain_traced, _ = device_kernels(lambda: [plain(*a) for a in sets])
    per_call = {k: 1e-3 * us / len(sets) for k, (_, us) in traced.items()}
    parts = {k: v for k, v in per_call.items() if k in own}
    others = {k: v for k, v in per_call.items() if k not in own}
    if own and plain_traced:
        ms = sum(parts.values())
        plain_ms = 1e-3 * sum(us for _, us in plain_traced.values()) / len(sets)
        source = "profiler"
    else:
        print(f"{name}: the profiler traced no device time; times are CUDA events")
        ms, plain_ms, source = event_ms, plain_event_ms, "events"
    return dict(ms=ms, plain_ms=plain_ms, event_ms=event_ms, plain_event_ms=plain_event_ms,
                ms_from=source, parts=parts, others=others,
                kernel_launches=sum(c for c, _ in own.values()) / len(sets))


def device_ms(fn, sets, symbol) -> float:
    """Device time per call of ``fn`` over ``sets``: the profiler's time of
    the kernels whose name holds ``symbol``, else CUDA events."""
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


def print_families(g, ref_g, exact) -> None:
    """Per column family of g_packed: its largest and median nonzero |g|,
    the absolute part of its bar, the kernel's error, both float32 versions'
    distance to float64, the entries outside the bar and outside the
    elementwise bar, and the share of its nonzero entries on which a zeroed
    family would fail the bar."""
    for fam, cols in PACKED_FAMILIES.items():
        got, want, ex = g[..., cols], ref_g[..., cols], exact[..., cols]
        mag = want.abs()
        nonzero = mag[mag > 0]
        top = mag.max().item()
        median = nonzero.median().item() if nonzero.numel() else 0.0
        outside = int(grad_mismatch(got, want).sum())
        elementwise = int((~torch.isclose(got, want, **SPLAT_GRAD_TOL)).sum())
        zeroed = grad_mismatch(torch.zeros_like(want), want)[mag > 0]
        caught = zeroed.float().mean().item() if zeroed.numel() else 0.0
        print(f"  {fam}: largest |g| {top:.3e}, median nonzero {median:.3e}, absolute bar "
              f"{SPLAT_GRAD_TOL['atol'] * top:.3e}; max_abs_err {(got - want).abs().max().item():.3e} "
              f"(kernel to float64 {(got - ex).abs().max().item():.3e}, plain to float64 "
              f"{(want - ex).abs().max().item():.3e}); {outside} outside the bar, {elementwise} "
              f"outside it elementwise; a zeroed family fails on {caught:.1%} of its nonzero entries")


def check_compositor(trainer, device) -> dict:
    """K2 and K3 against their plain versions on every case; times and
    bounds at full width (C = 6 and the indirection pass's C = 1)."""
    from uncertainty_nerf_gs_torch.models import splatfacto as sf
    from uncertainty_nerf_gs_torch.ops import composite as tc
    from uncertainty_nerf_gs_torch.ops.rasterize import select_and_pack

    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    # the full-width scene's packed tiles, camera 0, as render_splat packs them
    cfg = trainer.config
    params = {k: v.detach() for k, v in trainer.params.items()}
    c2w, fx, fy, cx, cy = trainer.camera(0)
    w, h = trainer.cameras.width, trainer.cameras.height
    with torch.no_grad():
        proj = sf.project_gaussians(params["means"], torch.exp(params["scales"]), params["quats"],
                                    sf.opengl_to_viewmat(c2w), fx, fy, cx, cy, w, h)
        proj = proj._replace(valid=proj.valid & trainer.splat_state.alive)
        opac = torch.sigmoid(params["opacities"]) * proj.compensation
        depth = proj.depths
        payload = torch.cat([torch.rand(depth.shape[0], 3, generator=gen, device=device),
                             depth[:, None], depth[:, None] ** 2,
                             0.5 + torch.rand(depth.shape[0], 1, generator=gen, device=device)], 1)
        full = select_and_pack(proj, opac, payload, w, h, cfg.rasterize_capacity,
                               cfg.rasterize_row_capacity)
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
        t, k, d = packed.shape
        g_img = torch.randn(t, 256, d - 6, generator=gen, device=device)
        g_alpha = torch.randn(t, 256, generator=gen, device=device)
        img, alpha = tc.composite_fwd(packed, pix, counts)
        ref_img, ref_alpha = tc.composite_tiles_reference(packed, pix, counts)
        # both backwards read their total from K2's outputs, as the main path's
        g = tc.composite_bwd(packed, pix, counts, img, alpha, g_img, g_alpha)
        ref_g = tc.composite_tiles_vjp_reference(packed, pix, counts, img, alpha, g_img, g_alpha)
        # the plain forward and backward in float64, to see which float32
        # version is the closer
        exact = composite_vjp_float64(packed, pix, counts, g_img, g_alpha)
        rows = tc.executed_rows(packed, pix, counts)
        torch.cuda.synchronize()
        e_f = max((img - ref_img).abs().max().item(), (alpha - ref_alpha).abs().max().item())
        e_b = (g - ref_g).abs().max().item()
        bad = grad_mismatch(g, ref_g, families=PACKED_FAMILIES)
        print(f"composite {name} {tuple(packed.shape)}: fwd max_abs_err {e_f:.3e}; bwd max_abs_err "
              f"{e_b:.3e}, {int(bad.sum())} entries outside atol 1e-4 x the family's largest "
              f"|g| + rtol 1e-3; rows composited {int(rows.sum())} of {int(counts.sum())} live, "
              f"max alpha {alpha.max().item():.6f}")
        print_families(g, ref_g, exact)
        finite = all(torch.isfinite(x).all() for x in (img, alpha, g))
        if not finite or e_f > SPLAT_FWD_ATOL or bad.any():
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
            again = tc.composite_bwd(packed, pix, counts, img, alpha, g_img, g_alpha)
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

    times = {}
    for name in ("full_width", "full_width_c1"):
        packed, pix, counts = cases[name]
        t, k, d = packed.shape
        per_set = 4 * (packed.numel() * 2 + pix.numel() + t * 256 * (d - 5) * 4)
        sets = []
        for _ in range(-(-MIN_SET_BYTES // per_set)):
            p = packed.clone()
            p[:, :, 6:] += 1e-3 * torch.rand(p[:, :, 6:].shape, generator=gen, device=device)
            pix_, counts_ = pix.clone(), counts.clone()
            sets.append((p, pix_, counts_, *tc.composite_fwd(p, pix_, counts_),
                         torch.randn(t, 256, d - 6, generator=gen, device=device),
                         torch.randn(t, 256, generator=gen, device=device)))
        rows = int(tc.executed_rows(packed, pix, counts).sum())
        fwd = kernel_times(f"{name} K2", tc.composite_fwd, tc.composite_tiles_reference,
                           [s[:3] for s in sets], "composite_fwd_kernel")
        bwd = kernel_times(f"{name} K3", tc.composite_bwd, tc.composite_tiles_vjp_reference,
                           sets, "composite_bwd_kernel")
        for label, tm, backward in (("K2", fwd, False), ("K3", bwd, True)):
            bound, bound_by, nbytes, ops = composite_bound_ms(rows, packed, backward)
            tm.update(bound_ms=bound, bound_by=bound_by, bytes=nbytes, operations=ops,
                      shape=list(packed.shape), rows=rows)
            print(f"{label} {name} {tuple(packed.shape)}, {rows} rows composited: kernel "
                  f"{tm['ms']:.4f} ms on the device ({tm['event_ms']:.4f} ms a call back to back), "
                  f"plain {tm['plain_ms']:.4f} ms ({tm['plain_event_ms']:.4f}), bound {bound:.4f} ms "
                  f"({bound_by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP)")
        times[name] = dict(fwd=fwd, bwd=bwd)
    return dict(fwd_err=fwd_err, bwd_err=bwd_err, times=times)


# -- K4 / K5: the hash-grid cell lookup against its plain versions -------------

# float32 operations per lookup (csrc/hash_grid.cu): scaled, frac, the axis
# weights and the 8 corner weights (25), then K4's 8 F multiply-adds; K5's
# 8 F scatter products and, with the position gradient, the 8 F-wide dots
# and the weight derivatives (3 x 8 x 3), times res
K4_OPS = lambda f: 25 + 16 * f  # noqa: E731
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
    pos = torch.rand(n, 3, generator=gen, device=device)
    edge = [[0, 0, 0], [1, 1, 1], [1, 0, 1], [0.5, 1, 0], [-1e-7, 0.5, 1 + 1e-7], [1 + 1e-7, -1e-7, 0.3]]
    for r in res:
        k = torch.arange(int(r) + 1, device=device, dtype=torch.float32)
        faces = (k / float(r))[torch.randint(0, int(r) + 1, (3, 3), generator=gen, device=device)]
        edge += faces.tolist()
    edge = torch.tensor(edge, dtype=torch.float32, device=device)[:n]
    pos[: edge.shape[0]] = edge
    return cells, pos, tuple(int(r) for r in res), table


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
    """(L, n) int64: each lookup's cell, by the plain ``cell_indices``."""
    from uncertainty_nerf_gs_torch.ops.encodings import cell_indices

    return torch.stack([cell_indices(pos, r, table)[0] for r in res])


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
    return dict(
        e_c=(g_cells - ref_cells).abs().max().item(), e_p=(g_pos - ref_pos).abs().max().item(),
        top_c=ref_cells.abs().max().item(), top_p=ref_pos.abs().max().item(),
        bad_c=level_mismatch(g_cells, ref_cells),
        bad_p=int(grad_mismatch(g_pos, ref_pos, GRID_GRAD_TOL).sum()),
        finite=bool(torch.isfinite(g_cells).all() and torch.isfinite(g_pos).all()),
        same=torch.equal(g_cells, again_cells) and torch.equal(g_pos, again_pos),
        same_without_pos=none is None and torch.equal(g_only, g_cells),
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


def other_k4(checkout):
    """Starts ``nvcc`` on another checkout's ``hash_grid.cu`` (for example
    the parent commit unpacked with ``git archive``) with the port's flags,
    into ``build/torch_kernels/``. Returns a function that waits for it,
    prints its K4's ``ptxas -v`` lines and returns a K4 call through that
    library, ``run(cells, positions, res, table, f)`` (no launch counted)."""
    import ctypes
    import hashlib

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
        for line in ptxas_summary(log, "cell_lookup_fwd_kernel"):
            print(f"other K4 ptxas: {line}")
        fn = ctypes.CDLL(str(out)).cell_lookup_fwd_f32
        fn.argtypes, fn.restype = enc._ARGTYPES["cell_lookup_fwd_f32"], ctypes.c_int

        def run(cells, pos, res, table, f):
            got = torch.empty((pos.shape[0], cells.shape[0] * f), dtype=torch.float32, device=cells.device)
            err = fn(pos.data_ptr(), cells.data_ptr(), got.data_ptr(), pos.shape[0],
                     *enc._level_args(cells, res, table, f), backend.current_stream_handle(cells.device))
            if err != 0:
                raise RuntimeError(f"the other K4's launch failed: CUDA error {err}")
            return got

        return run

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
    blocks = cells.reshape(levels, -1, 8, f)
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
            if not torch.isclose(other(cells, p, res, table, f), want, **TOL).all():
                raise AssertionError(f"{name} {positions}: the other K4 disagrees with the plain version")
        runs = dict(other=lambda p, g: other(cells, p, res, table, f),
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
            "cell_lookup_bwd_") for ss in (sets, c_sets))
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


def build_nerfacto(device=None, num_cameras=4, size=256):
    """Full-width active-nerfacto as the method ships it (camera optimizer
    on), random weights and training images drawn from a numpy seed, the
    weights through ``interop.params_from_jax``."""
    from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras
    from uncertainty_nerf_gs_torch.engine.trainer import NerfactoTrainer
    from uncertainty_nerf_gs_torch.interop import (
        draw_params,
        params_from_jax,
        params_to_jax,
    )
    from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig

    cams = hemisphere_cameras(num_cameras, size, size)
    cfg = NerfactoConfig(uncertainty_channels=1, num_images=num_cameras, background_color="white")
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
    them. With ``plain`` the forward runs inside ``backend.plain_versions()``
    and autograd runs the backward after the block has closed: it follows
    the forward's path."""
    from uncertainty_nerf_gs_torch.cameras.cameras import generate_rays
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

    gen = torch.Generator(device=trainer.device).manual_seed(SEED + 300)
    batch = trainer.sample_batch(NERF_RAYS)
    draws = trainer.model.draw(NERF_RAYS, gen)
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


# -- active-splatfacto at full width -------------------------------------------

SPLAT_IMAGES, SPLAT_STEPS = 2, 5


def build_splat(device=None):
    """The repo's splat benchmark shape (bench.py:289-297): 65,536 slots with
    65,000 live Gaussians in a +-1.5 cube, capacity 384, SH degree 3,
    active-splatfacto, 640x480 with fx = fy = 500. ``sh_degree_interval=2``
    ramps the SH degree to 2 within the five steps, so every parameter group
    trains; images and a perturbation of the initial log-scales from a
    numpy seed."""
    from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras
    from uncertainty_nerf_gs_torch.engine.splat_trainer import SplatfactoTrainer
    from uncertainty_nerf_gs_torch.models.splatfacto import SplatfactoConfig

    cfg = SplatfactoConfig(
        capacity=1 << 16, num_random=65_000, random_scale=1.5, rasterize_capacity=384,
        uncertainty_channels=1, background_color="white", sh_degree_interval=2,
    )
    cams = hemisphere_cameras(4, 480, 640, radius=4.0, focal_mult=0.78125)
    rng = np.random.default_rng(SEED)
    images = rng.uniform(size=(4, 480, 640, 3)).astype(np.float32)
    trainer = SplatfactoTrainer(cfg, cams, images, seed=SEED, device=device)
    # anisotropic scales: at init every Gaussian is isotropic, and the
    # gradient of its quaternion is float32 noise
    params = {k: v.detach().cpu().numpy() for k, v in trainer.params.items()}
    params["scales"] += rng.uniform(-0.5, 0.3, params["scales"].shape).astype(np.float32)
    trainer.restore({"params": params, "splat_alive": trainer.splat_state.alive.cpu().numpy(),
                     "step": 0})
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
          f"composite_bwd {SPLAT_STEPS}")
    if (launches["composite_fwd"], launches["composite_bwd"]) != (SPLAT_IMAGES + SPLAT_STEPS, SPLAT_STEPS):
        raise AssertionError("the splat path did not go through the compositing kernels")
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
    if backend.launch_counts["composite_bwd"] != 1:
        raise AssertionError("the kernel-path gradients did not launch K3")
    backend.reset_launch_counts()
    p_losses, p_grads = splat_grads(trainer, 2, plain=True)
    if backend.launch_counts["composite_fwd"] or backend.launch_counts["composite_bwd"]:
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
    symbols = {"composite_fwd": "composite_fwd_kernel", "composite_bwd": "composite_bwd_kernel"}
    profile_top("splat train step", trainer.train_step, symbols)
    profile_top("splat image 0", lambda: trainer.render_image(0), symbols, top=8)


def kernel_line(run_nerf, train_nerf, resample, nerf_plain, run_splat_, comp, grid) -> list[dict]:
    per = resample["per_launch"]
    # one chunk's two launches as the render makes them: 256 -> 97 with u
    # and edges shared, 96 -> 49 with u shared, at 4096 rays
    render = [p for p in per if p["layout"] == "render"]
    kernels = [dict(
        name="pdf_resample", route="cuda",
        source="uncertainty_nerf_gs_torch/csrc/pdf_resample.cu",
        replaces="uncertainty_nerf_gs_tpu/ops/pdf_pallas.py:120",
        launches=run_nerf["launches"]["pdf_resample"] + train_nerf["launches"]["pdf_resample"],
        launches_by_path=dict(render=run_nerf["launches"]["pdf_resample"],
                              train=train_nerf["launches"]["pdf_resample"]),
        max_abs_err=max(resample["max_abs_err"], nerf_plain["edge_err"]),
        ms=sum(p["ms"] for p in render), plain_ms=sum(p["plain_ms"] for p in render),
        bound_ms=sum(p["bound_ms"] for p in render), bound_by=render[0]["bound_by"],
        library_ms=None,  # no single PyTorch call computes this function
        floor_ms=sum(p["floor_ms"] for p in render),
        per_launch=per,
    )]
    full = comp["times"]["full_width"]
    for name, key, err, replaces in (
        ("composite_fwd", "fwd", comp["fwd_err"], "uncertainty_nerf_gs_tpu/ops/rasterize_pallas.py:296"),
        ("composite_bwd", "bwd", comp["bwd_err"], "uncertainty_nerf_gs_tpu/ops/rasterize_pallas.py:329"),
    ):
        tm = full[key]
        kernels.append(dict(
            name=name, route="cuda",
            source="uncertainty_nerf_gs_torch/csrc/composite_tiles.cu",
            replaces=replaces, launches=run_splat_["launches"][name], max_abs_err=err,
            ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=tm["bound_ms"], bound_by=tm["bound_by"],
            library_ms=None,  # no single PyTorch call computes this function
            c1=comp["times"]["full_width_c1"][key],
            event_ms=tm["event_ms"], ms_from=tm["ms_from"], rows=tm["rows"],
        ))
    # a chunk's (or a step's) three lookups: proposal 0, proposal 1, field
    for name, key, err in (("cell_lookup_fwd", "fwd", grid["fwd_err"]),
                           ("cell_lookup_bwd", "bwd", grid["bwd_err"])):
        per = [p[key] for p in grid["per_launch"]]
        by_path = dict(render=run_nerf["launches"][name], train=train_nerf["launches"][name])
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
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    args = sys.argv[1:]
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
    for kernel, report in backend.build_kernels().items():
        print(f"built {kernel}:\n{report.strip()}")
        for line in ptxas_summary(report, "cell_lookup_fwd_kernel"):
            print(f"K4 ptxas: {line}")
    other = other_build() if other_build else None
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
    del nerf
    torch.cuda.empty_cache()
    print(f"nerfacto done at {time.perf_counter() - t_start:.1f} s")

    run = run_splat(splat, name)
    check_splat_plain(splat)
    profile_splat(splat)
    print(f"splat done at {time.perf_counter() - t_start:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    kernels = kernel_line(run_nerf, train_nerf, resample, nerf_plain, run, comp, grid)
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
