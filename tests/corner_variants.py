"""K7 and K8 (``csrc/hash_grid.cu``, the corner layout's lookup and its
backward) against variants of their own source and, where given, another
checkout's, on one NVIDIA GPU.

    python3 tests/corner_variants.py [OTHER_CHECKOUT]

Builds the source as it is and each variant below (the source with one
constant or one line rewritten; one ``nvcc`` each, all started together),
an instrumented build that counts the cycles of K8's tile stage phase by
phase, and OTHER_CHECKOUT's ``hash_grid.cu`` (the parent commit unpacked with
``git archive``, whose entry points take the same arguments). It trains
full-width active-nerfacto with the corner layout as ``chip_smoke.py``'s
corner phase does (a Blender tree of the CLI phase's size, CORNER_STEPS
steps at CLI_K a launch) and captures two training forwards' positions at
each of the three fields (proposal 0, proposal 1, the field). On them it
holds every build's K7 equal to the plain version bit for bit and its K8
within GRID_GRAD_TOL of autograd through it, repeatable bit for bit, then
times K7, K8 and K8's positions-only mode by CUDA events back to back in
turns, the source as it is first and last. Prints the card's name and power limit first, and each
build's ``ptxas -v`` lines for K7 and K8's tile stage.
"""

from __future__ import annotations

import ctypes
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from uncertainty_nerf_gs_torch.ops import encodings as enc  # noqa: E402

SOURCE = ROOT / "uncertainty_nerf_gs_torch" / "csrc" / "hash_grid.cu"
OUT = ROOT / "build" / "corner_variants"
# K8's tile sort ranking each round before the next round's peers, as K5's
# scatter does
ROUND_BY_ROUND = [
    ("""        rank[r] = warp0 + r * 32 < count ? __match_any_sync(kFull, digit[r]) : 0u;
    }
#pragma unroll
    for (int r = 0; r < kK8Items; ++r) {
        if (warp0 + r * 32 >= count) break;  // the whole warp: rounds past the count
        const bool valid = warp0 + r * 32 + lane < count;
        const unsigned peers = rank[r];""", """        rank[r] = 0u;
        if (warp0 + r * 32 >= count) continue;
        const unsigned peers = __match_any_sync(kFull, digit[r]);"""),
]
VARIANTS = {
    "K7 walk on every table": [("constexpr long long kK7WalkBytes = 25LL << 20;", "constexpr long long kK7WalkBytes = 0;")],
    "K7 a thread a lookup on every table": [("constexpr long long kK7WalkBytes = 25LL << 20;",
                                             "constexpr long long kK7WalkBytes = 1LL << 40;")],
    "K8 no cell-run sums": [("    const unsigned starts = __ballot_sync(\n", "    const unsigned starts = kFull | __ballot_sync(\n")],
    "K8 tile digits of 8 bits": [("constexpr int kK8DigitBits = 10;", "constexpr int kK8DigitBits = 8;")],
    "K8 tile sort ranks round by round": ROUND_BY_ROUND,
    "K8 tile 3 blocks an SM": [("__launch_bounds__(kK8Threads) hash_lookup_bwd_tile_kernel",
                                "__launch_bounds__(kK8Threads, 3) hash_lookup_bwd_tile_kernel")],
}
# the instrumented build: thread 0 of each tile-level reads clock64 between
# the phases of k8_tile_level (and around its position gradient) and adds
# the differences to k8_phases
PHASE_EDITS = [
    ("constexpr int kK8Lookups = 256;", "__device__ unsigned long long k8_phases[6];\nconstexpr int kK8Lookups = 256;"),
    ("    const bool live = t < lookups;\n", "    const bool live = t < lookups;\n    const long long k8c0 = clock64();\n"),
    ("    __syncthreads();\n    const int count = static_cast<int>(items);\n",
     "    __syncthreads();\n    const long long k8c1 = clock64();\n    const int count = static_cast<int>(items);\n"),
    ("    const unsigned short* si = ids + in * kK8Pairs;\n",
     "    const unsigned short* si = ids + in * kK8Pairs;\n    const long long k8c2 = clock64();\n"),
    ("    __syncthreads();  // the shared memory is the next level's\n    return runs;\n",
     "    __syncthreads();  // the shared memory is the next level's\n    if (t == 0) {\n"
     "        const long long c[4] = {k8c0, k8c1, k8c2, clock64()};\n"
     "        for (int i = 0; i < 3; ++i) atomicAdd(&k8_phases[i], static_cast<unsigned long long>(c[i + 1] - c[i]));\n"
     "        atomicAdd(&k8_phases[5], 1ull);\n    }\n    return runs;\n"),
    ("            if (reads) corner_pos_grad<F>(c, v, lv.res[l], go, grad);\n",
     "            const long long k8g0 = clock64();\n"
     "            if (reads) corner_pos_grad<F>(c, v, lv.res[l], go, grad);\n"
     "            if (t == 0 && grad[0] == grad[0])\n"
     "                atomicAdd(&k8_phases[3], static_cast<unsigned long long>(clock64() - k8g0));\n"),
]
PHASES = ("form and sum the cell runs, write the items", "sort the items", "sum the slots' runs, write the partials",
          "the position gradient (thread 0)")
READ_PHASES = """
extern "C" int k8_phases_read(unsigned long long* out) {
    cudaMemcpyFromSymbol(out, k8_phases, 6 * sizeof(unsigned long long));
    const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
    return static_cast<int>(cudaMemcpyToSymbol(k8_phases, zero, sizeof(zero)));
}
"""


def rewritten(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise AssertionError(f"{old[:70]!r} is not in the source once")
        text = text.replace(old, new)
    return text


def training_positions() -> tuple[object, list[list[torch.Tensor]]]:
    """(config, two training forwards' positions [proposal 0, proposal 1,
    field]) of full-width corner active-nerfacto after CORNER_STEPS steps."""
    from uncertainty_nerf_gs_torch.data.synthetic import write_blender_dataset
    from uncertainty_nerf_gs_torch.scripts.train import build_trainer

    shutil.rmtree(OUT / "scene", ignore_errors=True)
    scene = write_blender_dataset(OUT / "scene", cs.CLI_TRAIN_VIEWS, cs.CLI_TEST_VIEWS, cs.CLI_SIZE, cs.CLI_SIZE)
    trainer, _, _ = build_trainer("active-nerfacto", scene, "blender-data", config_overrides={"grid_layout": "corner"})
    trainer.train(cs.CORNER_STEPS, steps_per_launch=cs.CLI_K)
    positions = cs.capture_lookup_positions(trainer)
    shutil.rmtree(OUT / "scene", ignore_errors=True)
    return trainer.config, positions


def main() -> int:
    if not torch.cuda.is_available():
        print("corner_variants: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    print(cs.card())
    text = SOURCE.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {name: rewritten(text, edits) for name, edits in VARIANTS.items()}
    sources["phases"] = rewritten(text, PHASE_EDITS) + READ_PHASES
    builds = {"as is": cs.corner_library(SOURCE, "corner_as_is")}
    for i, (name, src) in enumerate(sources.items()):
        path = OUT / f"variant_{i}.cu"
        path.write_text(src)
        builds[name] = cs.corner_library(path, f"corner_variant_{i}")
    if len(sys.argv) > 1:
        builds["other checkout"] = cs.other_corner(sys.argv[1])
    libs = {name: finish() for name, finish in builds.items()}
    for name, lib in libs.items():
        for line in cs.ptxas_summary(lib.report, "hash_lookup_fwd_") + cs.ptxas_summary(
                lib.report, "hash_lookup_bwd_tile_kernelILi2ELb1E"):
            print(f"{name}: {line.split(': ', 1)[1]}")
    read_phases = libs["phases"].lib.k8_phases_read
    read_phases.argtypes, read_phases.restype = [ctypes.c_void_p], ctypes.c_int
    timed = [n for n in libs if n != "phases"]
    order = ["as is", *[n for n in timed if n != "as is"], "as is"]
    cfg, captured = training_positions()
    for i, (shape, levels, max_res, log2, _) in enumerate(cs.grid_shapes(cfg)):
        gen = torch.Generator(device=device).manual_seed(cs.SEED + 900 + i)
        res = tuple(int(r) for r in enc.hash_grid_resolutions(levels, 16, max_res))
        table = cs.corner_table(levels, log2, 2, gen, device)
        sets = [(c[i], torch.randn(c[i].shape[0], levels * 2, generator=gen, device=device)) for c in captured]
        pos, g = sets[0]
        want = enc.hash_encoding_lookup_reference(table, pos, res, 2)
        want_t, want_p = enc.hash_encoding_vjp_reference(table, pos, res, 2, g)
        for name, lib in libs.items():
            if not torch.equal(lib.k7(table, pos, res, 2), want):
                raise AssertionError(f"{shape}: {name}'s K7 differs from the plain version")
            got_t, got_p = lib.k8(table, pos, res, 2, g)
            again_t, _ = lib.k8(table, pos, res, 2, g)
            if cs.level_mismatch(got_t, want_t) or cs.grad_mismatch(got_p, want_p, cs.GRID_GRAD_TOL).any():
                raise AssertionError(f"{shape}: {name}'s K8 disagrees with the plain backward")
            if not torch.equal(got_t, again_t):
                raise AssertionError(f"{shape}: two launches of {name}'s K8 differ")
        pairs, parts = cs.corner_partials(pos, res, table.shape[1])
        print(f"{shape} ({pos.shape[0]} samples x {levels} levels, 2^{log2}, training positions): K7 and K8 of every "
              f"build hold; {pairs} pairs, {parts} partials after a tile of {cs.K8_TILE} samples ({parts / pairs:.3f})")
        for kname, call in (("K7", lambda lib: (lambda p, g: lib.k7(table, p, res, 2))),
                            ("K8", lambda lib: (lambda p, g: lib.k8(table, p, res, 2, g))),
                            ("K8 positions only", lambda lib: (lambda p, g: lib.k8(table, p, res, 2, g, False)))):
            times = {name: [] for name in timed}
            for name in order:
                times[name].append(cs.time_ms(call(libs[name]), sets))
            print(f"  {kname} {shape}, ms a call back to back: " + ", ".join(
                f"{name} {' / '.join(f'{t:.4f}' for t in ts)}" for name, ts in times.items()))
        phases = (ctypes.c_ulonglong * 6)()
        for _ in range(2):  # the first call warms up
            libs["phases"].k8(table, pos, res, 2, g)
            torch.cuda.synchronize()
            read_phases(phases)
        v = list(phases)
        print(f"  K8 {shape} tile stage, cycles a tile-level ({v[5]} of them): " + ", ".join(
            f"{name} {v[j] / v[5]:.0f}" for j, name in enumerate(PHASES)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
