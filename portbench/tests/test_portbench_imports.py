"""Nothing under portbench imports JAX or the JAX package, and the reference
imports nothing of the program: checked on every import statement by whole
top-level module names."""

import ast
from pathlib import Path

from portbench.run import loaded_forbidden

ROOT = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "uncertainty_nerf_gs_tpu"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = list(ROOT.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not top_level_imports(path) & JAX_SIDE, path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").rglob("*.py"):
        assert "uncertainty_nerf_gs_torch" not in top_level_imports(path), path


def test_loaded_module_check_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "uncertainty_nerf_gs_torchlike", types.ModuleType("x"))
    assert loaded_forbidden(JAX_SIDE) == []
    monkeypatch.setitem(sys.modules, "uncertainty_nerf_gs_tpu.ops", types.ModuleType("y"))
    assert loaded_forbidden(JAX_SIDE) == ["uncertainty_nerf_gs_tpu"]
