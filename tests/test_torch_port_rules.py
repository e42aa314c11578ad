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
from uncertainty_nerf_gs_torch.engine.splat_trainer import SplatfactoTrainer
from uncertainty_nerf_gs_torch.engine.trainer import NerfactoTrainer
from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig, NerfactoModel
from uncertainty_nerf_gs_torch.models.splatfacto import SplatfactoConfig
from uncertainty_nerf_gs_torch.ops import backend
from uncertainty_nerf_gs_torch.ops.composite import MAX_CHANNELS, composite_bwd, composite_fwd
from uncertainty_nerf_gs_torch.ops.gaussians import Projection
from uncertainty_nerf_gs_torch.ops.pdf_resample import MAX_BINS, resample_edges
from uncertainty_nerf_gs_torch.ops.rasterize import rasterize_gaussians

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
        SplatfactoTrainer(SplatfactoConfig(capacity=8, num_random=4), cams,
                          torch.zeros(2, 4, 4, 3).numpy(), device=None)
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


def _composite_inputs(t=3, k=5, c=4, dtype=torch.float32):
    """packed, pix, counts, and the backward's img, alpha, g_img, g_alpha."""
    packed = torch.rand(t, k, 6 + c, dtype=dtype)
    pix = torch.rand(t, 256, 2, dtype=dtype)
    counts = torch.full((t,), k, dtype=torch.int32)
    return (packed, pix, counts, torch.rand(t, 256, c, dtype=dtype), torch.rand(t, 256, dtype=dtype),
            torch.rand(t, 256, c, dtype=dtype), torch.rand(t, 256, dtype=dtype))


@pytest.mark.parametrize(
    "case,error",
    [
        ("float64", TypeError),
        ("counts_int64", TypeError),
        ("too_many_channels", ValueError),
        ("no_channels", ValueError),
        ("packed_2d", ValueError),
        ("pix_shape", ValueError),
        ("counts_shape", ValueError),
        ("g_img_channels", ValueError),
        ("g_alpha_shape", ValueError),
        ("out_img_channels", ValueError),
        ("out_alpha_shape", ValueError),
        ("out_img_float64", TypeError),
        ("out_alpha_device", ValueError),
        ("not_contiguous", ValueError),
        ("mixed_devices", ValueError),
    ],
)
def test_composite_wrappers_refuse(case, error):
    packed, pix, counts, img, alpha, g_img, g_alpha = _composite_inputs()
    if case == "float64":
        packed, pix, counts, img, alpha, g_img, g_alpha = _composite_inputs(dtype=torch.float64)
    elif case == "counts_int64":
        counts = counts.long()
    elif case == "too_many_channels":
        packed, pix, counts, img, alpha, g_img, g_alpha = _composite_inputs(c=MAX_CHANNELS + 1)
    elif case == "no_channels":
        packed = packed[:, :, :6].contiguous()
    elif case == "packed_2d":
        packed = packed[0]
    elif case == "pix_shape":
        pix = pix[:, :128].contiguous()
    elif case == "counts_shape":
        counts = counts[:2]
    elif case == "g_img_channels":
        g_img = g_img[:, :, :3].contiguous()
    elif case == "g_alpha_shape":
        g_alpha = g_alpha[:2]
    elif case == "out_img_channels":
        img = img[:, :, :3].contiguous()
    elif case == "out_alpha_shape":
        alpha = alpha[:, :128].contiguous()
    elif case == "out_img_float64":
        img = img.double()
    elif case == "out_alpha_device":
        alpha = alpha.to("meta")
    elif case == "not_contiguous":
        packed = packed.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "mixed_devices":
        pix = pix.to("meta")
    if not case.startswith(("g_", "out_")):  # the backward's own arguments
        with pytest.raises(error):
            composite_fwd(packed, pix, counts)
    with pytest.raises(error):
        composite_bwd(packed, pix, counts, img, alpha, g_img, g_alpha)


@pytest.mark.parametrize("backend_name", ["xla", "matmul"])
def test_rasterize_refuses_tpu_backends(backend_name):
    n = 4
    proj = Projection(torch.rand(n, 2) * 16, torch.ones(n), torch.ones(n, 3), torch.ones(n),
                      torch.ones(n), torch.ones(n, dtype=torch.bool))
    with pytest.raises(ValueError, match="backend"):
        rasterize_gaussians(proj, torch.ones(n), torch.ones(n, 3), 16, 16, backend=backend_name)
    with pytest.raises(ValueError, match="pack_via"):
        rasterize_gaussians(proj, torch.ones(n), torch.ones(n, 3), 16, 16, pack_via="onehot")


@pytest.mark.parametrize("name", backend.KERNELS)
def test_kernel_build_is_keyed_by_source(name):
    path = backend.library_path(name)
    assert path.parent == backend.BUILD_DIR and path.suffix == ".so"
    assert path == backend.library_path(name)
    assert (backend.CSRC_DIR / f"{name}.cu").exists()
    assert set(backend.launch_counts) == set(backend.LAUNCH_COUNTERS)


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py would run for real")
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
