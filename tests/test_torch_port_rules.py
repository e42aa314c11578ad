"""Rules the PyTorch port keeps: it stands apart from the JAX package, it runs
on the card unless asked for the CPU, and its kernel wrapper refuses what the
kernel does not take."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras
from uncertainty_nerf_gs_torch.engine.trainer import NerfactoTrainer
from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig, NerfactoModel
from uncertainty_nerf_gs_torch.ops import backend
from uncertainty_nerf_gs_torch.ops.pdf_resample import MAX_BINS, resample_edges

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "uncertainty_nerf_gs_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "uncertainty_nerf_gs_tpu"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_jax(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_trainer_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cams = hemisphere_cameras(2, 4, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NerfactoTrainer(NerfactoConfig(num_images=2), cams, device=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NerfactoModel(NerfactoConfig(num_images=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        backend.resolve_device(None)
    assert backend.resolve_device("cpu") == torch.device("cpu")


def test_dispatch_follows_the_tensor():
    assert backend.use_kernel(torch.zeros(1)) is False
    with pytest.raises(RuntimeError):
        backend.use_kernel(torch.zeros(1, device="meta"))


def _inputs(r=4, s=8, n=5, dtype=torch.float32):
    w = torch.rand(r, s, dtype=dtype)
    e = torch.sort(torch.rand(r, s + 1, dtype=dtype), dim=1).values
    u = torch.rand(r, n, dtype=dtype)
    return w, e, u


@pytest.mark.parametrize(
    "case,error",
    [
        ("float64", TypeError),
        ("weights_1d", ValueError),
        ("edges_width", ValueError),
        ("u_rows", ValueError),
        ("u_empty", ValueError),
        ("too_many_bins", ValueError),
        ("mixed_devices", ValueError),
    ],
)
def test_resample_wrapper_refuses(case, error):
    w, e, u = _inputs()
    if case == "float64":
        w, e, u = _inputs(dtype=torch.float64)
    elif case == "weights_1d":
        w = w[0]
    elif case == "edges_width":
        e = e[:, :-1]
    elif case == "u_rows":
        u = u[:-1]
    elif case == "u_empty":
        u = u[:, :0]
    elif case == "too_many_bins":
        w, e, u = _inputs(r=1, s=MAX_BINS + 1)
    elif case == "mixed_devices":
        u = u.to("meta")
    with pytest.raises(error):
        resample_edges(w, e, u)


def test_kernel_build_is_keyed_by_source():
    path = backend.library_path("pdf_resample")
    assert path.parent == backend.BUILD_DIR and path.suffix == ".so"
    assert path == backend.library_path("pdf_resample")
    assert (backend.CSRC_DIR / "pdf_resample.cu").exists()


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py would run for real")
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
