"""K5's positions-only mode (``csrc/hash_grid.cu::cell_lookup_bwd_pos_kernel``)
and the splat path's packed-row backward (``csrc/packed_rows.cu``) against
variants of their own source and, where given, another checkout's, on one
NVIDIA GPU.

    python3 tests/backward_variants.py [OTHER_CHECKOUT]

Builds each source as it is and each variant below (the source with one
constant rewritten; one ``nvcc`` each, all started together), and
OTHER_CHECKOUT's ``hash_grid.cu`` and ``packed_rows.cu`` (the parent commit
unpacked with ``git archive``; ``chip_smoke.py::other_corner``). K5's mode
runs at full-width active-nerfacto's three lookups (proposal 0, proposal 1,
the field; F = 2) on uniform positions, as ``chip_smoke.py``'s
``k5_positions_only_times`` does, and on the positions of two training
forwards (samples along rays: neighbours share the coarse levels' cells);
every build's g_pos must equal ``cell_lookup_positions_vjp_reference`` bit
for bit. The packed-row backward runs on a real splat step's inputs
(``chip_smoke.py``'s splat scene, 65,000 Gaussians at 640x480) at capacity
384 and at 3,328, and on the refine phase's scene after its 80 steps (at
its tuned capacity, about 114,000 live slots of 131,072 rows), a second
camera's step as a second input set; every build must equal
``packed_rows_vjp_reference`` bit for bit. Each is timed by CUDA events back
to back and by the profiler's device time, in turns, the source as it is
first and last. Prints the card's name and power limit first, and each
build's ``ptxas -v`` lines for the two kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from uncertainty_nerf_gs_torch.ops import backend, rasterize  # noqa: E402
from uncertainty_nerf_gs_torch.ops import encodings as enc  # noqa: E402

CSRC = ROOT / "uncertainty_nerf_gs_torch" / "csrc"
OUT = ROOT / "build" / "backward_variants"
K5_VARIANTS = {
    "prefetch on every table": {"kK5PosPrefetchBytes": "0"},
    "prefetch on no table": {"kK5PosPrefetchBytes": "1LL << 40"},
    "prefetch at 4 blocks an SM": {"kK5PosPrefetchBlocks": "4"},
    "own reads only": {"kK5PosOwnMaxRuns": "32"},
    "shared reads only": {"kK5PosOwnMaxRuns": "0"},
}
ROWS_VARIANTS = {
    "one slot in flight a thread": {"kCountItems": "1"},
    "runs of up to 16 a thread": {"kThreadRun": "16"},
    "sum at 8 blocks an SM": {"kSumMinBlocks": "8"},
    "scan blocks of 256 threads, 16 counts each": {"kScanThreads": "256", "kScanItems": "16"},
}


def rewritten(text: str, constants: dict[str, str]) -> str:
    """``text`` with each named constant's value replaced."""
    import re

    for name, value in constants.items():
        text, count = re.subn(rf"(constexpr \w+(?: \w+)? {name} = )[^;]+;", rf"\g<1>{value};", text)
        if count != 1:
            raise AssertionError(f"{name} is not a constant of the source")
    return text


def rows_library(src: Path, tag: str):
    """Starts ``nvcc`` on a ``packed_rows.cu``; returns a function that waits
    for it and returns (its backward as ``chip_smoke.py::other_packed_rows``
    calls it, ``ptxas -v``'s output)."""
    out = backend.BUILD_DIR / f"{tag}-{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so"
    proc = subprocess.Popen([backend._nvcc(), *backend.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        return cs.other_packed_rows(ctypes.CDLL(str(out)), None), log

    return finish


def in_turns(fns: dict, sets) -> dict[str, list[tuple[float, float]]]:
    """(CUDA-event ms back to back, profiled device ms) a call of each
    function, in turns: the first one first and last."""
    names = list(fns)
    times = {name: [] for name in names}
    for name in [names[0], *names[1:], names[0]]:
        times[name].append((cs.time_ms(fns[name], sets), cs.device_ms(fns[name], sets, "")))
    return times


def report(label: str, times: dict) -> None:
    print(f"  {label}, ms a call (events back to back | device): " + "; ".join(
        f"{name} " + " / ".join(f"{e:.4f} | {d:.4f}" for e, d in ts) for name, ts in times.items()))


def main() -> int:
    if not torch.cuda.is_available():
        print("backward_variants: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    print(cs.card())
    OUT.mkdir(parents=True, exist_ok=True)
    backend.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    grid_text, rows_text = (CSRC / "hash_grid.cu").read_text(), (CSRC / "packed_rows.cu").read_text()
    k5_builds = {"as is": cs.corner_library(CSRC / "hash_grid.cu", "k5_as_is")}
    rows_builds = {"as is": rows_library(CSRC / "packed_rows.cu", "rows_as_is")}
    for i, (name, constants) in enumerate(K5_VARIANTS.items()):
        path = OUT / f"hash_grid_{i}.cu"
        path.write_text(rewritten(grid_text, constants))
        k5_builds[name] = cs.corner_library(path, f"k5_variant_{i}")
    for i, (name, constants) in enumerate(ROWS_VARIANTS.items()):
        path = OUT / f"packed_rows_{i}.cu"
        path.write_text(rewritten(rows_text, constants))
        rows_builds[name] = rows_library(path, f"rows_variant_{i}")
    other = cs.other_corner(sys.argv[1]) if len(sys.argv) > 1 else None
    k5 = {name: finish() for name, finish in k5_builds.items()}
    rows = {}
    for name, finish in rows_builds.items():
        rows[name], log = finish()
        for line in cs.ptxas_summary(log, "packed_rows_"):
            print(f"{name}: {line}")
    if other is not None:
        theirs = other()
        k5["other checkout"], rows["other checkout"] = theirs, theirs.packed_rows_bwd
    for name, lib in k5.items():
        for line in cs.ptxas_summary(lib.report, "cell_lookup_bwd_pos_kernelILi2E"):
            print(f"{name}: {line.split(': ', 1)[1]}")

    nerf = cs.build_nerfacto()
    cfg = nerf.config
    captured = cs.capture_lookup_positions(nerf)
    del nerf
    torch.cuda.empty_cache()
    for i, (shape, levels, max_res, log2, spr) in enumerate(cs.grid_shapes(cfg)):
        gen = torch.Generator(device=device).manual_seed(cs.SEED + 750 + i)
        n = cfg.eval_num_rays_per_chunk * spr
        cells, pos, res, table = cs.grid_inputs(levels, max_res, log2, n, gen, device)
        uniform = [(pos, torch.randn(n, levels * 2, generator=gen, device=device)),
                   (torch.rand(n, 3, generator=gen, device=device),
                    torch.randn(n, levels * 2, generator=gen, device=device))]
        training = [(c[i], torch.randn(c[i].shape[0], levels * 2, generator=gen, device=device)) for c in captured]
        print(f"K5 positions only, {shape} ({n} samples x {levels} levels, 2^{log2} cells a level):")
        for label, sets in (("uniform positions", uniform), ("training positions", training)):
            want = enc.cell_lookup_positions_vjp_reference(cells, sets[0][0], res, table, 2, sets[0][1])
            fns = {}
            for name, lib in k5.items():
                fns[name] = (lambda lib_: lambda p, g: lib_.k5_positions(cells, p, res, table, 2, g))(lib)
                if not torch.equal(fns[name](*sets[0]), want):
                    raise AssertionError(f"{shape}: {name}'s g_pos differs from the plain version")
            report(label, in_turns(fns, sets))

    for label in ("capacity 384", "capacity 3,328", "the refine phase's tuned capacity"):
        if label == "the refine phase's tuned capacity":
            splat = cs.build_splat_refine()
            for _ in range(cs.REFINE_STEPS):
                splat.train_step()
        else:
            splat = cs.build_splat(**({} if label == "capacity 384" else dict(rasterize_capacity=3328)))
        sets = [cs.capture_gather(splat), cs.capture_gather(splat, cam_idx=3)]
        del splat
        torch.cuda.empty_cache()
        g, idx, counts, n = sets[0]
        want = rasterize.packed_rows_vjp_reference(g, idx, counts, n)
        live = torch.arange(idx.shape[1], device=device)[None, :] < counts[:, None]
        runs = torch.bincount(idx[live], minlength=n + 1)[:n]
        for name, fn in rows.items():
            if not torch.equal(fn(*sets[0]), want):
                raise AssertionError(f"{label}: {name}'s packed-row backward differs from the plain version")
        print(f"packed-row backward, {label}: g_packed {tuple(g.shape)}, {int(counts.sum())} and "
              f"{int(sets[1][2].sum())} live slots, {n} rows, longest run {int(runs.max())}")
        report("real steps", in_turns(rows, sets))
    return 0


if __name__ == "__main__":
    sys.exit(main())
