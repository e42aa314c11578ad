"""Rules the PyTorch port keeps: it stands apart from the JAX package, it runs
on the card unless asked for the CPU, and its kernel wrapper refuses what the
kernel does not take."""

import ast
import inspect
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras
from uncertainty_nerf_gs_torch.engine.splat_trainer import SplatfactoTrainer
from uncertainty_nerf_gs_torch.engine.trainer import NerfactoTrainer
from uncertainty_nerf_gs_torch.models.ensemble import ensemble_render_splat
from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig, NerfactoModel
from uncertainty_nerf_gs_torch.models import splatfacto
from uncertainty_nerf_gs_torch.models.splatfacto import SplatfactoConfig
from uncertainty_nerf_gs_torch.ops import backend
from uncertainty_nerf_gs_torch.ops.encodings import (
    MAX_LEVELS,
    MAX_MEMBERS,
    CellLookup,
    cell_lookup,
    cell_lookup_bwd,
    hash_encoding_lookup,
    packed_cell_lookup,
    packed_cell_lookup_strided,
)
from uncertainty_nerf_gs_torch.ops.composite import (
    MAX_CHANNELS,
    CompositeTiles,
    composite_bwd,
    composite_fwd,
    composite_tiles,
)
from uncertainty_nerf_gs_torch.ops.gaussians import Projection
from uncertainty_nerf_gs_torch.ops.pdf_resample import MAX_BINS, resample_edges
from uncertainty_nerf_gs_torch.ops.rasterize import rasterize_gaussians
from uncertainty_nerf_gs_torch.ops.sampling import sample_pdf

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
        NerfactoTrainer(NerfactoConfig(num_images=2), cams, images=torch.zeros(2, 4, 4, 3).numpy(),
                        use_camera_optimizer=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NerfactoModel(NerfactoConfig(num_images=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SplatfactoTrainer(SplatfactoConfig(capacity=8, num_random=4), cams,
                          torch.zeros(2, 4, 4, 3).numpy(), device=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        backend.resolve_device(None)
    assert backend.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("option", [dict(use_camera_optimizer=True),
                                    dict(config=dict(rasterize_capacity_auto=True)),
                                    dict(config=dict(capacity_retune_every=5))],
                         ids=["camera_optimizer", "capacity_auto", "capacity_retune"])
def test_splat_trainer_options_without_cuda_raise(monkeypatch, option):
    """The splat trainer's camera optimizer and capacity tuner run on the
    card like the rest of it: without one, ``device=None`` raises before
    any of them runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SplatfactoConfig(capacity=8, num_random=4, **option.get("config", {}))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SplatfactoTrainer(cfg, hemisphere_cameras(2, 4, 4), torch.zeros(2, 4, 4, 3).numpy(), device=None,
                          use_camera_optimizer=option.get("use_camera_optimizer", False))


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
        ("u_row_stride", ValueError),
        ("edges_transposed", ValueError),
        ("u_expanded_dim1", ValueError),
        ("weights_not_contiguous", ValueError),
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
    elif case == "u_row_stride":  # rows neither shared nor packed
        u = torch.rand(4, 8)[:, :5]
    elif case == "edges_transposed":
        e = e.t().contiguous().t()
    elif case == "u_expanded_dim1":
        u = u[:, :1].expand(4, 5)
    elif case == "weights_not_contiguous":
        w = w[:1].expand(4, 8)
    with pytest.raises(error):
        resample_edges(w, e, u)


def test_plain_versions_switch():
    """``plain_versions()`` makes use_kernel False for every tensor, nests,
    and restores the kernel path on exit and on an exception."""
    on_card = SimpleNamespace(device=torch.device("cuda"))  # use_kernel reads .device
    on_cpu = torch.zeros(1)
    assert backend.use_kernel(on_card) is True
    with backend.plain_versions():
        assert backend.use_kernel(on_card) is False
        assert backend.use_kernel(on_cpu) is False
        with backend.plain_versions():
            assert backend.use_kernel(on_card) is False
        assert backend.use_kernel(on_card) is False
    assert backend.use_kernel(on_card) is True
    with pytest.raises(KeyError):
        with backend.plain_versions():
            raise KeyError("inside the block")
    assert backend.use_kernel(on_card) is True
    assert backend.use_kernel(on_cpu) is False


@pytest.mark.parametrize("fn", [
    sample_pdf, NerfactoModel.forward, CompositeTiles.forward, composite_tiles,
    rasterize_gaussians, splatfacto._rasterize, splatfacto.render_splat,
    SplatfactoTrainer.render_image, cell_lookup, CellLookup.forward,
    NerfactoTrainer.train_step, NerfactoTrainer._loss_fn, packed_cell_lookup, packed_cell_lookup_strided,
    SplatfactoTrainer.train_step, splatfacto.refine_gaussians, splatfacto.probe_tile_counts,
    ensemble_render_splat,
], ids=lambda f: f.__qualname__)
def test_no_plain_parameter(fn):
    """The plain path is chosen by ``backend.plain_versions()``, not by an
    argument: the model, trainer and op signatures match the JAX package's."""
    assert "plain" not in inspect.signature(fn).parameters


def _lookup_inputs(levels=3, n=7, dtype=torch.float32):
    """cells (L, 64, 128) (512 cells a level at F = 2), positions (n, 3),
    resolutions, table size."""
    return torch.rand(levels, 64, 128, dtype=dtype), torch.rand(n, 3, dtype=dtype), (4, 8, 16)[:levels], 512


@pytest.mark.parametrize(
    "case,error",
    [
        ("cells_float64", TypeError),
        ("positions_float64", TypeError),
        ("positions_not_contiguous", ValueError),
        ("cells_not_contiguous", ValueError),
        ("positions_2d_wide", ValueError),
        ("cells_lanes", ValueError),
        ("resolutions_count", ValueError),
        ("too_many_levels", ValueError),
        ("table_too_large", ValueError),
        ("features", ValueError),
        ("mixed_devices", ValueError),
        ("key_bits", ValueError),
        ("cells_misaligned", ValueError),
    ],
)
def test_cell_lookup_wrapper_refuses(case, error):
    """The lookup refuses what K4/K5 do not take, on every device, rather
    than copy or convert."""
    cells, pos, res, table = _lookup_inputs()
    feats = 2
    if case == "cells_float64":
        cells = cells.double()
    elif case == "positions_float64":
        pos = pos.double()
    elif case == "positions_not_contiguous":
        pos = torch.rand(3, 7).t()
    elif case == "cells_not_contiguous":
        cells = cells.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "positions_2d_wide":
        pos = torch.rand(7, 4)
    elif case == "cells_lanes":
        cells = torch.rand(3, 128, 64)
    elif case == "resolutions_count":
        res = res[:2]
    elif case == "too_many_levels":
        cells, res = torch.rand(MAX_LEVELS + 1, 64, 128), (4,) * (MAX_LEVELS + 1)
    elif case == "table_too_large":
        table = 513
    elif case == "features":
        feats = 3
    elif case == "mixed_devices":
        pos = pos.to("meta")
    elif case == "key_bits":  # 32 levels of 2^27 cells: K5's keys would need 32 bits
        cells = torch.empty(MAX_LEVELS, 2**24, 128, device="meta")
        pos, res, table = torch.empty(7, 3, device="meta"), (4,) * MAX_LEVELS, 2**27
    elif case == "cells_misaligned":  # contiguous, but K4's float4 reads need 16 bytes
        cells = torch.rand(cells.numel() + 1)[1:].view(cells.shape)
    with pytest.raises(error):
        cell_lookup(cells, pos, res, table, feats)


@pytest.mark.parametrize(
    "case,error",
    [
        ("table_float64", TypeError),
        ("positions_float64", TypeError),
        ("positions_not_contiguous", ValueError),
        ("table_not_contiguous", ValueError),
        ("positions_2d_wide", ValueError),
        ("features", ValueError),
        ("resolutions_count", ValueError),
        ("too_many_levels", ValueError),
        ("mixed_devices", ValueError),
        ("key_bits", ValueError),
        ("table_misaligned", ValueError),
    ],
)
def test_hash_lookup_wrapper_refuses(case, error):
    """The corner lookup refuses what K7/K8 do not take, on every device,
    rather than copy or convert."""
    table, pos, res, feats = torch.rand(3, 64, 2), torch.rand(7, 3), (4, 8, 16), 2
    if case == "table_float64":
        table = table.double()
    elif case == "positions_float64":
        pos = pos.double()
    elif case == "positions_not_contiguous":
        pos = torch.rand(3, 7).t()
    elif case == "table_not_contiguous":
        table = torch.rand(3, 2, 64).transpose(1, 2)
    elif case == "positions_2d_wide":
        pos = torch.rand(7, 4)
    elif case == "features":
        table, feats = torch.rand(3, 64, 3), 3
    elif case == "resolutions_count":
        res = res[:2]
    elif case == "too_many_levels":
        table, res = torch.rand(MAX_LEVELS + 1, 64, 2), (4,) * (MAX_LEVELS + 1)
    elif case == "mixed_devices":
        pos = pos.to("meta")
    elif case == "key_bits":  # 32 levels of 2^27 entries: K8's keys would need 32 bits
        table, res = torch.empty(MAX_LEVELS, 2**27, 2, device="meta"), (4,) * MAX_LEVELS
        pos = torch.empty(7, 3, device="meta")
    elif case == "table_misaligned":  # contiguous, but K7's vector reads need 16 bytes
        table = torch.rand(table.numel() + 1)[1:].view(table.shape)
    with pytest.raises(error):
        hash_encoding_lookup(table, pos, res, feats)


@pytest.mark.parametrize("case", ["float64", "shape", "not_contiguous", "device"])
def test_cell_lookup_backward_wrapper_refuses_g_out(case):
    cells, pos, res, table = _lookup_inputs()
    g_out = torch.rand(7, 6)
    if case == "float64":
        g_out = g_out.double()
    elif case == "shape":
        g_out = g_out[:, :4].contiguous()
    elif case == "not_contiguous":
        g_out = torch.rand(6, 7).t()
    elif case == "device":
        g_out = g_out.to("meta")
    with pytest.raises(ValueError):
        cell_lookup_bwd(cells, pos, res, table, 2, g_out)


def _packed_inputs(levels=3, m=3, f=2, n=7, dtype=torch.float32):
    """packed (L, 512, 8, M, F), positions (n, 3), resolutions, table size."""
    return (torch.rand(levels, 512, 8, m, f, dtype=dtype), torch.rand(n, 3, dtype=dtype),
            (4, 8, 16)[:levels], 512)


@pytest.mark.parametrize(
    "case,error",
    [
        ("packed_float64", TypeError),
        ("positions_float64", TypeError),
        ("packed_not_contiguous", ValueError),
        ("positions_not_contiguous", ValueError),
        ("too_many_members", ValueError),
        ("members_asked", ValueError),
        ("features_3", ValueError),
        ("features_8", ValueError),
        ("features_asked", ValueError),
        ("packed_4d", ValueError),
        ("not_8_corners", ValueError),
        ("table_size", ValueError),
        ("resolutions_count", ValueError),
        ("positions_shape", ValueError),
        ("mixed_devices", ValueError),
        ("packed_misaligned", ValueError),
    ],
)
def test_packed_lookup_wrapper_refuses(case, error):
    """The packed lookup refuses what K6 does not take (dtype, layout, M,
    F, the table's shape, the device), on every device, rather than copy."""
    packed, pos, res, table = _packed_inputs()
    m, f = 3, 2
    if case == "packed_float64":
        packed = packed.double()
    elif case == "positions_float64":
        pos = pos.double()
    elif case == "packed_not_contiguous":
        packed = torch.rand(3, 512, 8, 2, 3).transpose(3, 4)  # (.., 3, 2), strided
    elif case == "positions_not_contiguous":
        pos = torch.rand(3, 7).t()
    elif case == "too_many_members":
        packed, pos, res, table = _packed_inputs(m=MAX_MEMBERS + 1)
        m = MAX_MEMBERS + 1
    elif case == "members_asked":
        m = 2
    elif case == "features_3":
        packed, pos, res, table = _packed_inputs(f=3)
        f = 3
    elif case == "features_8":
        packed, pos, res, table = _packed_inputs(f=8)
        f = 8
    elif case == "features_asked":
        f = 4
    elif case == "packed_4d":
        packed = packed.reshape(3, 512, 8, 6)
    elif case == "not_8_corners":
        packed = torch.rand(3, 512, 4, 3, 2)
    elif case == "table_size":
        table = 256
    elif case == "resolutions_count":
        res = res[:2]
    elif case == "positions_shape":
        pos = torch.rand(7, 2)
    elif case == "mixed_devices":
        pos = pos.to("meta")
    elif case == "packed_misaligned":  # contiguous, but K6's vector reads need 16 bytes
        packed = torch.rand(packed.numel() + 1)[1:].view(packed.shape)
    with pytest.raises(error):
        packed_cell_lookup(packed, pos, res, table, m, f)



@pytest.mark.parametrize("case", ["positions_not_contiguous", "positions_2d", "positions_float64",
                                  "t_mid_float64", "t_mid_not_contiguous", "t_mid_shape", "t_mid_device",
                                  "members_asked"])
def test_strided_lookup_wrapper_refuses(case):
    """The strided packed lookup refuses what K6's strided entry does not
    take (the rays' layout, t_mid's dtype, layout, shape and device), on
    every device, rather than copy."""
    packed, _, res, table = _packed_inputs()
    pos, t, m = torch.rand(4, 9, 3), torch.rand(4, 9), 3
    if case == "positions_not_contiguous":
        pos = torch.rand(9, 4, 3).transpose(0, 1)
    elif case == "positions_2d":
        pos = pos.reshape(36, 3)
    elif case == "positions_float64":
        pos = pos.double()
    elif case == "t_mid_float64":
        t = t.double()
    elif case == "t_mid_not_contiguous":
        t = torch.rand(9, 4).t()
    elif case == "t_mid_shape":
        t = t[:, :8].contiguous()
    elif case == "t_mid_device":
        t = t.to("meta")
    elif case == "members_asked":
        m = 2
    with pytest.raises((TypeError, ValueError)):
        packed_cell_lookup_strided(packed, pos, t, res, table, m, 2)

EVAL_MODULES = [
    "uncertainty_nerf_gs_torch.eval.evaluator",
    "uncertainty_nerf_gs_torch.metrics.image_metrics",
    "uncertainty_nerf_gs_torch.metrics.ause",
    "uncertainty_nerf_gs_torch.metrics.auce",
    "uncertainty_nerf_gs_torch.metrics.nll",
    "uncertainty_nerf_gs_torch.ops.lpips",
    "uncertainty_nerf_gs_torch.models.ensemble",
    "uncertainty_nerf_gs_torch.parallel.ensemble_fused",
    "uncertainty_nerf_gs_torch.scripts.eval_uncertainty",
]


def test_eval_modules_import_without_pil_or_matplotlib():
    """The card's machine has neither PIL nor matplotlib: the evaluator,
    the metrics and the ensemble modules import (with what they import)
    in an interpreter where both are missing; only the PNG and plot writers
    need them, and import them inside."""
    code = ("import sys\nsys.modules['PIL'] = None\nsys.modules['matplotlib'] = None\n"
            + "".join(f"import {m}\n" for m in EVAL_MODULES)
            + "assert not any(k.split('.')[0] in ('PIL', 'matplotlib') and v is not None "
              "for k, v in sys.modules.items())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


CLI_MODULES = [
    "uncertainty_nerf_gs_torch.configs.flags",
    "uncertainty_nerf_gs_torch.configs.methods",
    "uncertainty_nerf_gs_torch.data.corruption",
    "uncertainty_nerf_gs_torch.data.dataparsers",
    "uncertainty_nerf_gs_torch.data.datasets",
    "uncertainty_nerf_gs_torch.data.image_io",
    "uncertainty_nerf_gs_torch.data.png",
    "uncertainty_nerf_gs_torch.data.synthetic",
    "uncertainty_nerf_gs_torch.engine.checkpointing",
    "uncertainty_nerf_gs_torch.scripts.eval_uncertainty",
    "uncertainty_nerf_gs_torch.scripts.train",
    "uncertainty_nerf_gs_torch.scripts.render",
    "uncertainty_nerf_gs_torch.scripts.pose_gradient",
    "uncertainty_nerf_gs_torch.scripts.viewer",
    "uncertainty_nerf_gs_torch.data.gif",
    "uncertainty_nerf_gs_torch.utils.colormaps",
    "uncertainty_nerf_gs_torch.utils.images",
    "uncertainty_nerf_gs_torch.utils.writer",
]


def test_cli_modules_import_without_pil_yaml_or_matplotlib():
    """The card's machine has no PIL, PyYAML or matplotlib: the data layer,
    the checkpoints and the CLIs import without them; only non-PNG images,
    blender-downscale's LANCZOS copies, a block-YAML config and the plots
    import them, inside the function that needs them."""
    code = ("import sys\nfor m in ('PIL', 'yaml', 'matplotlib'):\n    sys.modules[m] = None\n"
            + "".join(f"import {m}\n" for m in CLI_MODULES)
            + "assert not any(k.split('.')[0] in ('PIL', 'yaml', 'matplotlib') and v is not None "
              "for k, v in sys.modules.items())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("cli", ["train", "eval_uncertainty", "render", "pose_gradient", "viewer"])
def test_cli_without_device_raises_without_cuda(monkeypatch, tmp_path, cli):
    """Every CLI runs on the card unless ``--device cpu`` asks for the CPU."""
    from uncertainty_nerf_gs_torch.scripts import eval_uncertainty, pose_gradient, render, train, viewer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if cli == "train":
            train.main(["active-nerfacto", "--data", str(tmp_path), "--output-dir", str(tmp_path / "run")])
        elif cli == "eval_uncertainty":
            eval_uncertainty.main(["--load-config", str(tmp_path), "--output-path", str(tmp_path / "m.json")])
        else:
            dict(render=render, pose_gradient=pose_gradient, viewer=viewer)[cli].main(
                ["--load-config", str(tmp_path)])


HASH_GRID_CU = REPO / "uncertainty_nerf_gs_torch" / "csrc" / "hash_grid.cu"
PACKED_ROWS_CU = REPO / "uncertainty_nerf_gs_torch" / "csrc" / "packed_rows.cu"


def _k5_source() -> str:
    """csrc/hash_grid.cu from K5's first kernel on, comments dropped."""
    text = HASH_GRID_CU.read_text()
    text = text[text.index("// -- K5, stage 1"):]
    return "\n".join(line.split("//")[0] for line in text.splitlines())


def test_k5_source_has_no_float_atomic():
    """K5 adds no float atomically: every atomic in its kernels is an
    integer count of the sort's histogram (a tile's bins in shared memory,
    the digit totals), and there is no inline-PTX atom or red."""
    import re

    src = _k5_source()
    calls = re.findall(r"\batomic\w*\s*\(\s*([^,]+),", src)
    assert calls, "the histogram's integer atomics are expected"
    assert all(re.fullmatch(r"&(hist|totals)\[.*\]", c.strip()) for c in calls), calls
    for name in ("hist", "totals"):
        assert re.search(rf"unsigned\*?\s*(__restrict__\s+)?{name}\b|unsigned {name}\[", src), name
    assert not re.search(r"\b(atom|red)\.", src)


def test_k5_path_calls_no_library_sort():
    """K5's sort is the hand-written one in csrc/hash_grid.cu: no CUB or
    Thrust there, and no torch.sort, argsort or unique on the Python path
    from CellLookup.backward to the launch."""
    from uncertainty_nerf_gs_torch.ops import encodings

    src = HASH_GRID_CU.read_text()
    assert "#include" in src and not any(lib in src for lib in ("cub/", "thrust", "cub::"))
    path = "".join(inspect.getsource(f) for f in (
        CellLookup.backward, encodings.cell_lookup_bwd, encodings._bwd, encodings._scratch, encodings._entry))
    assert "cell_lookup_bwd_f32" in path
    assert not any(call in path for call in ("sort(", "argsort", "unique"))


def test_packed_rows_source_has_no_atomic():
    """The splat gather's backward (csrc/packed_rows.cu) adds no float
    atomically, nor anything else: each element of g_src is one thread's
    left-to-right sum, stored once; no inline-PTX atom or red either."""
    import re

    src = "\n".join(line.split("//")[0] for line in PACKED_ROWS_CU.read_text().splitlines())
    assert "__fadd_rn" in src
    assert not re.search(r"\batomic\w*\s*\(", src) and not re.search(r"\b(atom|red)\.", src)


def test_packed_rows_path_calls_no_library_sort():
    """The gather's backward on the card sorts with K5's hand-written radix
    sort (``radix_sort_u32`` in csrc/hash_grid.cu): no torch.sort, argsort or
    unique on the Python path from PackedRowGather.backward to the launches,
    and no CUB or Thrust in its source."""
    from uncertainty_nerf_gs_torch.ops import rasterize

    src = PACKED_ROWS_CU.read_text()
    assert not any(lib in src for lib in ("cub/", "thrust", "cub::"))
    path = "".join(inspect.getsource(f) for f in (
        rasterize.PackedRowGather.backward, rasterize.packed_rows_bwd))
    assert "radix_sort_u32" in path and "packed_rows_sum" in path
    assert not any(call in path for call in ("sort(", "argsort", "unique"))
    assert "radix_sort_u32_scratch_bytes" in HASH_GRID_CU.read_text()


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
