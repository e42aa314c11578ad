"""Device resolution and kernel dispatch for the port.

Counterpart of ``uncertainty_nerf_gs_tpu/ops/backend.py``. There, two call
sites once tested the backend on their own and ran the fallback on the real
chip while the benchmark reported the kernel's time. Here every decision goes
through this module:

* ``resolve_device(None)`` is CUDA, and raises when no card is present. Entry
  points never fall back to the CPU on their own.
* ``use_kernel(t)`` is True exactly when ``t`` lies on a CUDA device and no
  ``plain_versions()`` block is open. A CUDA tensor then launches the
  hand-written kernel or raises; a CPU tensor takes the kernel's plain
  PyTorch version. Nothing catches a failed launch.
* ``with plain_versions():`` makes every wrapper run its plain version on
  the card too. It exists for checks that hold the kernel path against the
  plain path on the same card (``chip_smoke.py``). It is never a fallback:
  nothing in the package opens it, and outside it a failed build or launch
  still raises. It is a context variable, restored on exit and on an
  exception; an autograd Function records the forward's decision, so its
  backward follows the forward's path wherever autograd runs it.

Kernels are CUDA C++ sources in ``uncertainty_nerf_gs_torch/csrc``. Each is
compiled at first use with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, keyed by a hash of its source and flags, under
``build/torch_kernels/`` beside the package, and loaded with ``ctypes``.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("pdf_resample", "composite_tiles", "hash_grid", "packed_rows")  # sources in csrc/
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# kernel name -> launches since the last reset; each wrapper adds one where
# it launches its kernel and nowhere else
LAUNCH_COUNTERS = (
    "pdf_resample", "composite_fwd", "composite_bwd", "cell_lookup_fwd", "cell_lookup_bwd",
    "cell_lookup_bwd_positions", "packed_cell_lookup_fwd", "packed_cell_lookup_strided", "packed_rows_bwd",
    "hash_lookup_fwd", "hash_lookup_bwd", "hash_lookup_bwd_positions",
)
launch_counts: dict[str, int] = {name: 0 for name in LAUNCH_COUNTERS}
_libraries: dict[str, ctypes.CDLL] = {}
_plain = contextvars.ContextVar("plain_versions", default=False)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card. Raises rather than run on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev


def use_kernel(t: torch.Tensor) -> bool:
    """True: launch the CUDA kernel. False: the tensor is on the CPU, or a
    ``plain_versions()`` block is open, and the plain version runs. Any other
    device raises."""
    if t.device.type == "cuda":
        return not _plain.get()
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel or plain version for device {t.device}")


@contextlib.contextmanager
def plain_versions():
    """Within the block every wrapper runs its plain version, on the card
    too: for checks of the kernel path against the plain path only."""
    token = _plain.set(True)
    try:
        yield
    finally:
        _plain.reset(token)


def count_launch(name: str) -> None:
    launch_counts[name] += 1


def count_replays(launches: dict[str, int], replays: int) -> None:
    """Adds ``replays`` times a captured CUDA graph's launches: a replay
    launches the kernels its capture recorded without running a wrapper."""
    for name, n in launches.items():
        launch_counts[name] += n * replays


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def library_path(name: str) -> Path:
    """Build output for ``csrc/<name>.cu``, keyed by source and flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit on this machine")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build_kernels(names: tuple[str, ...] = KERNELS) -> dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns name -> ``ptxas -v`` report (empty
    for a library that was already built). Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load_library(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built at first use."""
    lib = _libraries.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_kernels((name,))
        lib = ctypes.CDLL(str(path))
        _libraries[name] = lib
    return lib


def entry(library: str, name: str, argtypes: list, restype=ctypes.c_int):
    """A C entry point of a kernel library, built and loaded at first use,
    its argument and result types set once."""
    fn = getattr(load_library(library), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def current_stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
