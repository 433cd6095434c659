"""Nothing under portbench/ imports JAX, its libraries or the JAX package
(top-level module names compared whole), and the plain reference imports
nothing of the port."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "multihmr_tpu"}


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert "multihmr_tpu_torch" not in imported(path)


def test_whole_names():
    src = "import multihmr_tpu_torch.config\nfrom multihmr_tpu.ops import x\n"
    tmp = ROOT / "tests" / "_probe_imports.txt"
    tmp.write_text(src)
    try:
        assert imported(tmp) == {"multihmr_tpu_torch", "multihmr_tpu"}
    finally:
        tmp.unlink()


def test_run_checks_modules(monkeypatch):
    import sys
    import types

    from portbench import harness

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["jax"]
