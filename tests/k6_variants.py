"""K6 (``csrc/hash_grid.cu``, the member-packed lookup) against variants of
its own source, on one NVIDIA GPU.

    python3 tests/k6_variants.py

Builds the source as it is and each variant below (the source with one
constant or one block rewritten, one ``nvcc`` each, all started together),
captures a fused ensemble chunk's three K6 launches (two render chunks of
``chip_smoke.py``'s five-member model: the two proposals' strided calls and
the field's dense call) and a dense field call at uniform positions, holds
every variant equal to the plain version bit for bit on each, and times
them in turns by CUDA events: the source as it is first and last. Then the
cycles a warp spends in each phase of a job (locating, issuing the row
copies, waiting for them, summing and lerping, writing the stage out), read
with ``clock64`` in an instrumented build (each warp's sums added up once
at its end), per launch. Prints the
card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from uncertainty_nerf_gs_torch.ops import backend  # noqa: E402
from uncertainty_nerf_gs_torch.ops import encodings as enc  # noqa: E402

SOURCE = ROOT / "uncertainty_nerf_gs_torch" / "csrc" / "hash_grid.cu"
DIRECT = "a.out[(static_cast<long long>(m) * a.n + wp.g) * (a.num_levels * F) + job.level * F + f]"
VARIANTS = {
    "2 warps a block": [("constexpr int kK6Warps = 1;", "constexpr int kK6Warps = 2;")],
    "4 warps a block": [("constexpr int kK6Warps = 1;", "constexpr int kK6Warps = 4;")],
    "stage 40 floats": [("constexpr int kK6Stage = 80;", "constexpr int kK6Stage = 40;")],
    "stage 160 floats": [("constexpr int kK6Stage = 80;", "constexpr int kK6Stage = 160;")],
    "rows unpadded": [("k.row_stride = k.row + 4;", "k.row_stride = k.row;")],
    # each lane's sums stored straight into the output, no stage
    "no stage": [
        ("for (int f = 0; f < F; ++f) stage[m * member_stage + f] = v[f];",
         f"for (int f = 0; f < F; ++f) {DIRECT} = v[f];"),
        ("                    stage[m * member_stage + f] =\n", f"                    {DIRECT} =\n"),
        ("            k6_flush<F>(a, k, w, mine + k.stage_at, l - l % k.levels_a_pass, l + 1, lane);",
         "            (void)0;"),
    ],
}
# the instrumented build: each warp's clock64 around each phase of its jobs,
# summed in registers and added to the totals once a warp
LOOP = """    for (unsigned phase = 0;; phase ^= 1u) {
        const K6Lookup lk = k6_locate(a, lv, w, job, q, lane);
        const K6Job next = k6_next(a, w, job);
        if (next.level < a.num_levels) k6_position(a, w, next, p, lane, q);
        k6_copy(a, k, job, lk, mine, lane);
        k6_finish<F>(a, k, w, job, lk, mine, phase, lane);
        const int l = job.level;
        if (job.round + 1 == job.rounds && ((l + 1) % k.levels_a_pass == 0 || l + 1 == a.num_levels))
            k6_flush<F>(a, k, w, mine + k.stage_at, l - l % k.levels_a_pass, l + 1, lane);
        if (next.level == a.num_levels) break;
        job = next;
    }
}"""
TIMED_LOOP = """    unsigned long long cycles[6] = {0, 0, 0, 0, 0, 0};
    for (unsigned phase = 0;; phase ^= 1u) {
        const long long c0 = clock64();
        const K6Lookup lk = k6_locate(a, lv, w, job, q, lane);
        const long long c1 = clock64();
        const K6Job next = k6_next(a, w, job);
        if (next.level < a.num_levels) k6_position(a, w, next, p, lane, q);
        k6_copy(a, k, job, lk, mine, lane);
        const long long c2 = clock64();
        bar_wait(reinterpret_cast<unsigned long long*>(mine + k.bar_at), phase);
        const long long c3 = clock64();
        k6_finish<F>(a, k, w, job, lk, mine, phase, lane);
        const long long c4 = clock64();
        const int l = job.level;
        if (job.round + 1 == job.rounds && ((l + 1) % k.levels_a_pass == 0 || l + 1 == a.num_levels))
            k6_flush<F>(a, k, w, mine + k.stage_at, l - l % k.levels_a_pass, l + 1, lane);
        const long long c5 = clock64();
        const long long c[6] = {c0, c1, c2, c3, c4, c5};
        for (int i = 0; i < 5; ++i) cycles[i] += static_cast<unsigned long long>(c[i + 1] - c[i]);
        ++cycles[5];
        if (next.level == a.num_levels) break;
        job = next;
    }
    if (lane == 0)
        for (int i = 0; i < 6; ++i) atomicAdd(&k6_phases[i], cycles[i]);
}"""
PHASES = ("locate", "issue the copies", "wait for them", "sum and lerp", "write the stage out")
READ_PHASES = """
extern "C" int k6_phases_read(unsigned long long* out) {
    cudaMemcpyFromSymbol(out, k6_phases, 6 * sizeof(unsigned long long));
    const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
    return static_cast<int>(cudaMemcpyToSymbol(k6_phases, zero, sizeof(zero)));
}
"""


def rewritten(text: str, subs) -> str:
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"the source no longer holds {old[:70]!r}")
        text = text.replace(old, new)
    return text


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """name -> library, one nvcc a source, all started together."""
    backend.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu = backend.BUILD_DIR / f"k6_variant_{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen([backend._nvcc(), *backend.NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def k6_of(lib):
    """A recorded call (``chip_smoke.record_k6``) through the library's K6."""
    dense, strided = lib.packed_cell_lookup_fwd_f32, lib.packed_cell_lookup_strided_fwd_f32
    for fn, name in ((dense, "packed_cell_lookup_fwd_f32"), (strided, "packed_cell_lookup_strided_fwd_f32")):
        fn.argtypes, fn.restype = enc._ARGTYPES[name], ctypes.c_int

    def run(c):
        pk = c["packed"]
        levels, _, _, m, f = pk.shape
        res = (ctypes.c_int * levels)(*c["res"])
        stream = backend.current_stream_handle(pk.device)
        out = torch.empty((m, *c["pos"].shape[:-1], levels * f), device=pk.device)
        if c["kind"] == "dense":
            err = dense(c["pos"].data_ptr(), pk.data_ptr(), out.data_ptr(), c["pos"].shape[0], levels,
                        c["table"], m, f, res, stream)
        else:
            err = strided(c["pos"].data_ptr(), c["t"].data_ptr(), pk.data_ptr(), out.data_ptr(),
                          *c["pos"].shape[:2], levels, c["table"], m, f, res,
                          (ctypes.c_int * levels)(*c["strides"]), stream)
        if err != 0:
            raise RuntimeError(f"K6 launch failed: CUDA error {err}")
        return out

    return run


def captured_calls(device) -> list[tuple[str, list[dict]]]:
    """(label, the call over two input sets) of a fused chunk's three K6
    launches and of a dense field call at uniform positions."""
    from uncertainty_nerf_gs_torch.parallel.ensemble_fused import build_fused_ensemble_render, pack_ensemble_tables

    model, stacked, cams = cs.build_ensemble(device)
    packed = pack_ensemble_tables(model, stacked)
    chunk = model.config.eval_num_rays_per_chunk
    middle = cams.height * cams.width // chunk // 2
    render = build_fused_ensemble_render(model)
    chunks = []
    for c in (middle, middle + 1):
        with cs.record_k6() as calls:
            render(stacked, packed, cs.chunk_rays(cams, 1, c, chunk, device))
        chunks.append(calls)
    gen = torch.Generator(device=device).manual_seed(cs.SEED + 400)
    field = chunks[0][-1]
    uniform = [dict(field, pos=torch.rand(field["pos"].shape, generator=gen, device=device)) for _ in range(2)]
    labels = [f"render launch {i} ({c['kind']}, {c['pos'].numel() // 3} samples)" for i, c in enumerate(chunks[0])]
    return [(label, [ch[i] for ch in chunks]) for i, label in enumerate(labels)] + [("field uniform", uniform)]


def main() -> int:
    if not torch.cuda.is_available():
        print("k6_variants: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(cs.card())
    source = SOURCE.read_text()
    timed = rewritten(source, [("constexpr int kK6Warps = 1;",
                                "constexpr int kK6Warps = 1;\n__device__ unsigned long long k6_phases[6];"),
                               (LOOP, TIMED_LOOP)]) + READ_PHASES
    libs = build({"as is": source, **{k: rewritten(source, v) for k, v in VARIANTS.items()},
                  "phases": timed})
    runs = {name: k6_of(lib) for name, lib in libs.items() if name != "phases"}
    for label, calls in captured_calls(torch.device("cuda")):
        for name, run in runs.items():
            for c in calls:
                if not torch.equal(run(c), cs.k6_plain(c)):
                    raise AssertionError(f"{name}: K6 differs from its plain version at {label}")
        order = ["as is", *VARIANTS, "as is"]
        print(f"{label}, ms a call in turns: " + ", ".join(
            f"{name} {cs.time_ms(runs[name], [(c,) for c in calls], reps=40):.4f}" for name in order))
        phases, read = (ctypes.c_ulonglong * 6)(), libs["phases"].k6_phases_read
        read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
        k6_of(libs["phases"])(calls[0])
        torch.cuda.synchronize()
        read(phases)  # the first launch warms up
        k6_of(libs["phases"])(calls[0])
        torch.cuda.synchronize()
        read(phases)
        v = list(phases)
        total = sum(v[:5])
        print(f"  cycles a job ({v[5]} jobs): " + ", ".join(
            f"{name} {v[i] / v[5]:.0f} ({v[i] / total:.1%})" for i, name in enumerate(PHASES)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
