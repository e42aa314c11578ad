"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``uncertainty_nerf_gs_torch/
csrc`` with ``nvcc`` for ``sm_90a``, holds each against its plain PyTorch
version on the card, then renders two full 256x256 images with a full-width
active-nerfacto model (random weights from a numpy seed) through
``NerfactoTrainer.render_image``, and checks that the render went through the
kernels. Exits non-zero, with no result line, when there is no card or any
phase fails. The last line of standard output is a JSON object naming the
device; the line before it the card's name and power limit; before that a
``{"kernels": [...]}`` line with each kernel's launches, error and times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
# the JAX package's Pallas-vs-XLA bar (tests/test_ops.py:496), which the CPU
# tests hold the plain resampler to as well
RESAMPLE_TOL = dict(atol=2e-5, rtol=1e-4)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
# the whole-forward tolerances of the CPU parity tests (tests/torch_parity.py)
COMPOSITE_TOL = dict(atol=5e-4, rtol=2e-3)
MOMENT_TOL = dict(atol=1e-3, rtol=1e-2)
OUTPUT_TOLS = {
    "rgb": COMPOSITE_TOL,
    "accumulation": COMPOSITE_TOL,
    "depth": COMPOSITE_TOL,
    "expected_depth": MOMENT_TOL,
    "depth_var": MOMENT_TOL,
    "depth_std": MOMENT_TOL,
    "rgb_var": MOMENT_TOL,
    "rgb_std": MOMENT_TOL,
}
MAX_FLIPPED_RAY_SHARE = 0.1


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


# -- phase 2: the PDF resampler against its plain version --------------------


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
        if not (torch.isclose(got, want, **RESAMPLE_TOL).all() and torch.isfinite(got).all()):
            raise AssertionError(f"resample {shape}: kernel disagrees, {err:.3e}")
        if step < -1e-6:
            raise AssertionError(f"resample {shape}: a row decreases by {step:.3e}")
        worst = max(worst, err)
        if shape not in main_path:
            continue
        # input sets that together pass 100 MB, twice the L2 cache, so each
        # timed call reads its inputs from device memory
        num_sets = -(-100_000_000 // resample_bytes(*shape))
        sets = [resample_inputs(*shape, gen, device) for _ in range(num_sets)]
        event_ms = time_ms(resample_edges, sets)
        plain_event_ms = time_ms(resample_edges_reference, sets)
        # device time alone, from the profiler's trace of the same calls
        traced, _ = device_kernels(lambda: [resample_edges(*a) for a in sets])
        own = [v for k, v in traced.items() if "pdf_resample_kernel" in k]
        plain_traced, _ = device_kernels(lambda: [resample_edges_reference(*a) for a in sets])
        if own and plain_traced:
            ms = 1e-3 * own[0][1] / own[0][0]
            plain_ms = 1e-3 * sum(us for _, us in plain_traced.values()) / len(sets)
            source = "profiler"
        else:
            print("resample: the profiler traced no device time; times are CUDA events")
            ms, plain_ms, source = event_ms, plain_event_ms, "events"
        bound, bound_by = resample_bound_ms(*shape)
        print(f"resample {shape}: kernel {ms:.4f} ms on the device ({event_ms:.4f} ms "
              f"a call back to back), plain {plain_ms:.4f} ms ({plain_event_ms:.4f}), "
              f"bound {bound:.4f} ms ({bound_by})")
        per_launch.append(dict(
            shape=list(shape), ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
            event_ms=event_ms, plain_event_ms=plain_event_ms, ms_from=source,
        ))
    return dict(max_abs_err=worst, per_launch=per_launch)


# -- phase 3: the slice at full width -----------------------------------------


def build_trainer(device=None, num_cameras=4, size=256, config_overrides=None):
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
    cfg = NerfactoConfig(
        uncertainty_channels=1, num_images=num_cameras, background_color="white",
        **(config_overrides or {}),
    )
    trainer = NerfactoTrainer(cfg, cams, seed=SEED, device=device)
    tree = params_to_jax(trainer.model.state_dict())
    trainer.restore(params_from_jax(draw_params(tree, np.random.default_rng(SEED))))
    return trainer


def render_slice(trainer, num_images: int = 2) -> dict:
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
    print(f"launches {launches}, expected pdf_resample {want_launches}")
    if launches["pdf_resample"] != want_launches:
        raise AssertionError("the render did not go through the resampling kernel")
    return dict(launches=launches, seconds=times, chunks=chunks, rays=h * w)


def check_plain_chunk(trainer) -> dict:
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
    print(f"plain chunk: first-stage edges max_abs_err {edge_err:.3e}; "
          f"{n_flip} of {chunk} rays flipped a cell; {n_bad} others differ")
    edges_close = torch.isclose(
        kern["sdist_list"][1], plain["sdist_list"][1], **RESAMPLE_TOL
    ).all()
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


def profile_render(trainer, idx: int = 1) -> None:
    """One more image under torch.profiler: the device's busy and idle share,
    the kernels that take the most device time, and the port's own."""
    kernels, wall = device_kernels(lambda: trainer.render_image(idx))
    if not kernels:
        print("profile: the profiler traced no device time; idle share not measured")
        return
    busy = 1e-6 * sum(us for _, us in kernels.values())
    print(f"profile image {idx}: wall {1e3 * wall:.1f} ms under the profiler, device busy "
          f"{1e3 * busy:.1f} ms, idle share {1 - busy / wall:.3f}")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    for name, (count, us) in top[:15]:
        print(f"  {1e-3 * us:9.3f} ms {us / (1e6 * busy):6.1%} x{count:<5d} {name[:110]}")
    for name, (count, us) in top:
        if "pdf_resample_kernel" in name:
            print(f"  port kernel pdf_resample: {1e-3 * us:.3f} ms {us / (1e6 * busy):.1%} x{count}")
        if "vectorized_gather" in name:  # index_select of the hash-grid cells
            gb = gather_bytes(trainer)
            print(f"  {name[:40]}: {count} launches, {1e-3 * us:.3f} ms; the lookups read "
                  f"{gb / 1e6:.1f} MB of cells, {gb / (us * 1e-6) / 1e12:.3f} TB/s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from uncertainty_nerf_gs_torch.ops import backend

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    print(f"card: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    for kernel, report in backend.build_kernels().items():
        print(f"built {kernel}:\n{report.strip()}")
    print(f"build: {time.perf_counter() - t0:.1f} s")

    device = torch.device("cuda")
    resample = check_resampler(device)

    t0 = time.perf_counter()
    trainer = build_trainer()
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"active-nerfacto: {n_params} parameters; set-up {time.perf_counter() - t0:.1f} s")
    run = render_slice(trainer)
    for i, s in enumerate(run["seconds"]):
        print(f"image {i}: {1e3 * s:.1f} ms/image, {run['rays'] / s:.0f} rays/s "
              f"({run['chunks']} chunks of {trainer.config.eval_num_rays_per_chunk}) on {name}")
    plain = check_plain_chunk(trainer)
    profile_render(trainer)

    per = resample["per_launch"]
    kernels = [dict(
        name="pdf_resample",
        route="cuda",
        source="uncertainty_nerf_gs_torch/csrc/pdf_resample.cu",
        replaces="uncertainty_nerf_gs_tpu/ops/pdf_pallas.py:120",
        launches=run["launches"]["pdf_resample"],
        max_abs_err=max(resample["max_abs_err"], plain["edge_err"]),
        # one chunk's two launches: 256 -> 97 and 96 -> 49 at 4096 rays
        ms=sum(p["ms"] for p in per),
        plain_ms=sum(p["plain_ms"] for p in per),
        bound_ms=sum(p["bound_ms"] for p in per),
        bound_by=per[0]["bound_by"],
        library_ms=None,  # no single PyTorch call computes this function
        per_launch=per,
    )]
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
