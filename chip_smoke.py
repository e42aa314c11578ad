"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``uncertainty_nerf_gs_torch/
csrc`` with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, all started
together) and holds each against its plain PyTorch version on the card:
the PDF resampler (K1), and the tile compositor's forward (K2) and backward
(K3) on the full-width splat scene's packed tiles, a saturated scene, a
tile the saturation exit cuts short, a tile with no rows, a one-channel
payload, and hand-built tiles whose row counts end ragged against K3's
row groups and K2/K3's 128-row batches at 1, 5, 6 and 16 channels; K3
twice on the same full-width inputs, bit for bit. Then it drives both slices of the port at full width with random
weights from a seed: two 256x256 images of active-nerfacto through
``NerfactoTrainer.render_image``, and two 640x480 images and five training
steps of active-splatfacto (65,536 Gaussian slots) through
``SplatfactoTrainer``, checks from the launch counters that each went
through its kernels, holds each against the same work on the plain
versions, and profiles one image and one step. Exits non-zero, with no
result line, when there is no card or any phase fails. The last line of
standard output is a JSON object naming the device; the line before it the
card's name and power limit; before that a ``{"kernels": [...]}`` line with
each kernel's launches, error, times and bound.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from torch_parity import (  # noqa: E402  (the tolerances the CPU tests hold)
    MAX_FLIPPED_RAY_SHARE,
    OUTPUT_TOLS,
    PACKED_FAMILIES,
    SPLAT_FWD_ATOL,
    SPLAT_FWD_TOL,
    SPLAT_GRAD_TOL,
    SPLAT_OUTPUT_TOLS,
    TOL,
    composite_vjp_float64,
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
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            kernels[e.key] = (e.count, us)
    return kernels, wall


def kernel_times(name, kernel, plain, sets, symbol) -> dict:
    """A kernel's and its plain version's time per call over ``sets``: device
    time from the profiler where it traced the device, else CUDA events."""
    event_ms = time_ms(kernel, sets)
    plain_event_ms = time_ms(plain, sets)
    traced, _ = device_kernels(lambda: [kernel(*a) for a in sets])
    own = [v for k, v in traced.items() if symbol in k]
    plain_traced, _ = device_kernels(lambda: [plain(*a) for a in sets])
    if own and plain_traced:
        ms = 1e-3 * own[0][1] / own[0][0]
        plain_ms = 1e-3 * sum(us for _, us in plain_traced.values()) / len(sets)
        source = "profiler"
    else:
        print(f"{name}: the profiler traced no device time; times are CUDA events")
        ms, plain_ms, source = event_ms, plain_event_ms, "events"
    return dict(ms=ms, plain_ms=plain_ms, event_ms=event_ms, plain_event_ms=plain_event_ms,
                ms_from=source)


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
                print(f"  port kernel {label_}: {1e-3 * us:.3f} ms {us / (1e6 * busy):.1%} x{count}")
    return kernels


# -- K1: the PDF resampler against its plain version --------------------------


def resample_inputs(num_rays, num_bins, num_queries, gen, device):
    """Weights rand**4 with two all-zero rows, sorted random edges, and the
    eval path's queries u = clip((arange(N) + 0.5) / N, 0, 1 - 1e-6)."""
    w = torch.rand(num_rays, num_bins, generator=gen, device=device) ** 4
    w[0] = 0.0
    w[num_rays // 2] = 0.0
    e = torch.sort(
        torch.rand(num_rays, num_bins + 1, generator=gen, device=device), dim=1
    ).values
    u = (torch.arange(num_queries, dtype=torch.float32, device=device) + 0.5) / num_queries
    u = torch.clamp(u, 0.0, 1.0 - 1e-6).expand(num_rays, num_queries).contiguous()
    return w, e, u


def resample_bytes(num_rays, num_bins, num_queries) -> int:
    """Bytes one call must move: each input read once, the output written once."""
    return 4 * num_rays * (num_bins + (num_bins + 1) + 2 * num_queries)


def resample_bound_ms(num_rays, num_bins, num_queries) -> tuple[float, str]:
    """Least time for one call and what sets it: its bytes against the
    float32 work (padding, normalising and scanning each bin; a binary search
    and the interpolation per query)."""
    nbytes = resample_bytes(num_rays, num_bins, num_queries)
    ops = num_rays * (4 * num_bins + num_queries * (np.log2(num_bins + 1) + 6))
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def check_resampler(device) -> dict:
    from uncertainty_nerf_gs_torch.ops.pdf_resample import (
        resample_edges,
        resample_edges_reference,
    )

    cases = [(4096, 256, 97), (4096, 96, 49), (4099, 256, 97), (4099, 96, 49)]
    main_path = {(4096, 256, 97), (4096, 96, 49)}
    worst, per_launch = 0.0, []
    for i, shape in enumerate(cases):
        gen = torch.Generator(device=device).manual_seed(SEED + i)
        w, e, u = resample_inputs(*shape, gen, device)
        got = resample_edges(w, e, u)
        want = resample_edges_reference(w, e, u)
        # both float32 versions against the same arithmetic in float64
        exact = resample_edges_reference(w.double(), e.double(), u.double())
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        step = torch.diff(got, dim=1).min().item()
        print(f"resample {shape}: max_abs_err {err:.3e} (kernel to float64 "
              f"{(got - exact).abs().max().item():.3e}, plain to float64 "
              f"{(want - exact).abs().max().item():.3e}), least step {step:.3e}")
        if not (torch.isclose(got, want, **TOL).all() and torch.isfinite(got).all()):
            raise AssertionError(f"resample {shape}: kernel disagrees, {err:.3e}")
        if step < -1e-6:
            raise AssertionError(f"resample {shape}: a row decreases by {step:.3e}")
        worst = max(worst, err)
        if shape not in main_path:
            continue
        num_sets = -(-MIN_SET_BYTES // resample_bytes(*shape))
        sets = [resample_inputs(*shape, gen, device) for _ in range(num_sets)]
        times = kernel_times("resample", resample_edges, resample_edges_reference, sets,
                             "pdf_resample_kernel")
        bound, bound_by = resample_bound_ms(*shape)
        print(f"resample {shape}: kernel {times['ms']:.4f} ms on the device "
              f"({times['event_ms']:.4f} ms a call back to back), plain {times['plain_ms']:.4f} ms "
              f"({times['plain_event_ms']:.4f}), bound {bound:.4f} ms ({bound_by})")
        per_launch.append(dict(shape=list(shape), bound_ms=bound, bound_by=bound_by, **times))
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


# -- active-nerfacto at full width ---------------------------------------------


def build_nerfacto(device=None, num_cameras=4, size=256):
    """Full-width active-nerfacto with random weights drawn from a numpy seed
    through ``interop.params_from_jax``."""
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
    trainer = NerfactoTrainer(cfg, cams, seed=SEED, device=device)
    tree = params_to_jax(trainer.model.state_dict())
    trainer.restore(params_from_jax(draw_params(tree, np.random.default_rng(SEED))))
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
    want_launches = 2 * chunks * num_images
    print(f"nerfacto launches {launches}, expected pdf_resample {want_launches}")
    if launches["pdf_resample"] != want_launches:
        raise AssertionError("the render did not go through the resampling kernel")
    return dict(launches=launches, seconds=times, chunks=chunks, rays=h * w)


def check_nerfacto_plain_chunk(trainer) -> dict:
    """One chunk again with the plain resampler; every output within the CPU
    tests' tolerances on every ray whose lookups stayed in the same cells."""
    from uncertainty_nerf_gs_torch.cameras.cameras import generate_rays, pixel_grid

    dev = trainer.device
    chunk = trainer.config.eval_num_rays_per_chunk
    px, py = pixel_grid(trainer.cameras.height, trainer.cameras.width, dev)
    idx = torch.zeros(chunk, dtype=torch.int64, device=dev)
    rb = generate_rays(trainer.cameras, idx, px[:chunk], py[:chunk])
    model = trainer.model
    kern = model(rb, return_intermediates=True)
    plain = model(rb, return_intermediates=True, plain=True)
    # the first resampler call sees identical inputs on both paths
    edge_err = (kern["sdist_list"][1] - plain["sdist_list"][1]).abs().max().item()
    flipped = (
        model.lookup_cells(rb, kern["sdist_list"]) != model.lookup_cells(rb, plain["sdist_list"])
    ).any(dim=1)
    bad = torch.zeros_like(flipped)
    for k, tol in OUTPUT_TOLS.items():
        miss = ~torch.isclose(kern[k], plain[k], **tol)
        bad |= miss.reshape(chunk, -1).any(dim=1)
    n_flip, n_bad = int(flipped.sum()), int((bad & ~flipped).sum())
    print(f"nerfacto plain chunk: first-stage edges max_abs_err {edge_err:.3e}; "
          f"{n_flip} of {chunk} rays flipped a cell; {n_bad} others differ")
    edges_close = torch.isclose(kern["sdist_list"][1], plain["sdist_list"][1], **TOL).all()
    if not edges_close or n_bad or n_flip > MAX_FLIPPED_RAY_SHARE * chunk:
        raise AssertionError("the kernel path and the plain path disagree")
    return dict(edge_err=edge_err, flipped=n_flip)


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


def profile_nerfacto(trainer, idx: int = 1) -> None:
    kernels = profile_top(f"nerfacto image {idx}", lambda: trainer.render_image(idx),
                          {"pdf_resample": "pdf_resample_kernel"})
    for name, (count, us) in kernels.items():
        if "vectorized_gather" in name:  # index_select of the hash-grid cells
            gb = gather_bytes(trainer)
            print(f"  {name[:40]}: {count} launches, {1e-3 * us:.3f} ms; the lookups read "
                  f"{gb / 1e6:.1f} MB of cells, {gb / (us * 1e-6) / 1e12:.3f} TB/s")


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
    tap) at the trainer's state, without updating it."""
    from uncertainty_nerf_gs_torch.models import splatfacto as sf

    cfg = trainer.config
    params = {k: v.detach().clone().requires_grad_(True) for k, v in trainer.params.items()}
    tap = torch.zeros((cfg.capacity, 2), device=trainer.device, requires_grad=True)
    out = sf.render_splat(
        params, trainer.splat_state.alive, *trainer.camera(cam_idx),
        trainer.cameras.width, trainer.cameras.height, cfg,
        sh_deg=sf.active_sh_degree(trainer.step, cfg),
        background=sf.fixed_background(cfg, trainer.device), means2d_tap=tap, plain=plain,
    )
    total, losses = sf.splatfacto_loss(out, trainer.images[cam_idx], params, cfg)
    total.backward()
    grads = {k: p.grad for k, p in params.items()}
    grads["means2d_tap"] = tap.grad
    return {k: float(v.detach()) for k, v in losses.items()}, grads


def check_splat_plain(trainer) -> dict:
    """One image and one step's gradients again with the compositor's plain
    versions: outputs within the CPU tests' forward tolerances, gradients
    within SPLAT_GRAD_TOL relative to their largest entry."""
    from uncertainty_nerf_gs_torch.ops import backend

    kern = trainer.render_image(1)
    plain = trainer.render_image(1, plain=True)
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
    p_losses, p_grads = splat_grads(trainer, 2, plain=True)
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


def kernel_line(run_nerf, resample, nerf_plain, run_splat_, comp) -> list[dict]:
    per = resample["per_launch"]
    kernels = [dict(
        name="pdf_resample", route="cuda",
        source="uncertainty_nerf_gs_torch/csrc/pdf_resample.cu",
        replaces="uncertainty_nerf_gs_tpu/ops/pdf_pallas.py:120",
        launches=run_nerf["launches"]["pdf_resample"],
        max_abs_err=max(resample["max_abs_err"], nerf_plain["edge_err"]),
        # one chunk's two launches: 256 -> 97 and 96 -> 49 at 4096 rays
        ms=sum(p["ms"] for p in per), plain_ms=sum(p["plain_ms"] for p in per),
        bound_ms=sum(p["bound_ms"] for p in per), bound_by=per[0]["bound_by"],
        library_ms=None,  # no single PyTorch call computes this function
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
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from uncertainty_nerf_gs_torch.ops import backend

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # the SSIM convolution
    name = card()
    print(f"card: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    for kernel, report in backend.build_kernels().items():
        print(f"built {kernel}:\n{report.strip()}")
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
    run_nerf = render_nerfacto(nerf)
    for i, s in enumerate(run_nerf["seconds"]):
        print(f"nerfacto image {i}: {1e3 * s:.1f} ms/image, {run_nerf['rays'] / s:.0f} rays/s "
              f"({run_nerf['chunks']} chunks of {nerf.config.eval_num_rays_per_chunk}) on {name}")
    nerf_plain = check_nerfacto_plain_chunk(nerf)
    profile_nerfacto(nerf)
    del nerf
    torch.cuda.empty_cache()
    print(f"nerfacto done at {time.perf_counter() - t_start:.1f} s")

    run = run_splat(splat, name)
    check_splat_plain(splat)
    profile_splat(splat)
    print(f"splat done at {time.perf_counter() - t_start:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    kernels = kernel_line(run_nerf, resample, nerf_plain, run, comp)
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
