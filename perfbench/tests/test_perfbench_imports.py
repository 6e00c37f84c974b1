"""Nothing under perfbench/ imports JAX or the JAX package, and the plain
references import nothing of the program.  Top-level names are compared
whole: ``repro_torch`` is the program, ``repro`` the JAX package."""

import ast

from harness import files

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    for path in files.BENCH.rglob("*.py"):
        assert not FORBIDDEN & set(imported(path)), path


def test_references_import_only_torch_and_numpy():
    for path in (files.BENCH / "configs").glob("*.py"):
        assert set(imported(path)) <= {"__future__", "math", "numpy", "torch"}, path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys

    import run

    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert run.forbidden_modules() == [m for m in run.forbidden_modules() if m.split(".")[0] in FORBIDDEN]
    assert "repro_torch_like" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib.fake" in run.forbidden_modules()
