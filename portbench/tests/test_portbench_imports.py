"""No module of the benchmark imports JAX or the JAX package, and the plain
side (references, generators, the comparison, the yardstick) imports
nothing of the program."""

import ast
import pathlib

import pytest

HOME = pathlib.Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro"}
PLAIN = ["queries/q15.py", "queries/q7.py", "queries/sessions.py",
         "plain.py", "judge.py", "bounds.py"]


def _imports(path: pathlib.Path) -> set:
    """Top-level names of every module `path` imports, whole."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _modules():
    return sorted(p for p in HOME.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", _modules(), ids=lambda p: str(p.relative_to(HOME)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & BANNED


@pytest.mark.parametrize("rel", PLAIN)
def test_plain_side_imports_nothing_of_the_program(rel):
    names = _imports(HOME / rel)
    assert "repro_torch" not in names
    # what it takes from the benchmark itself is plain too
    for node in ast.walk(ast.parse((HOME / rel).read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("portbench."):
            assert node.module.split(".")[1] + ".py" in PLAIN


def test_the_scan_sees_a_banned_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import repro.core\nfrom jax import numpy\nimport repro_torch\n")
    assert _imports(p) == {"repro", "jax", "repro_torch"}


def test_banned_modules_compares_top_level_names_whole(monkeypatch):
    import sys
    import types

    from portbench import harness

    monkeypatch.setitem(sys.modules, "repro_torch_probe", types.ModuleType("x"))
    assert "repro_torch_probe" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "flax.core", types.ModuleType("flax.core"))
    assert "flax.core" in harness.banned_modules()
