"""The port's first rule: ``repro_torch`` and ``chip_smoke.py`` import neither
``jax`` nor anything of the reference package ``repro``.

Every module of the port is imported in a fresh interpreter in which both
names are blocked, and every source file of the port, and the smoke script,
is parsed for such an import anywhere (inside functions too, where an
import would run only later).
"""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_modules():
    return sorted(
        name for _, name, _ in pkgutil.walk_packages([str(PORT)], prefix="repro_torch.")
    )


def _forbidden_imports(path: Path) -> list[str]:
    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [f"{path.name}:{node.lineno} {n}" for n in names if n.split(".")[0] in FORBIDDEN]
    return found


def test_every_port_module_imports_with_jax_and_the_reference_blocked():
    modules = _port_modules()
    assert "repro_torch.core.pca" in modules and "repro_torch.distributed_pca" in modules
    assert {"repro_torch.train.trainer", "repro_torch.train.checkpoint", "repro_torch.data.pipeline",
            "repro_torch.launch.train", "repro_torch.configs.musicgen_large", "repro_torch.train_resilient_lm",
            "repro_torch.launch.mesh_runs", "repro_torch.launch.mesh", "repro_torch.launch.sharding",
            "repro_torch.launch.specs", "repro_torch.launch.collectives", "repro_torch.launch.dryrun",
            "repro_torch.launch.make_tables", "repro_torch.analysis", "repro_torch.analysis.registry",
            "repro_torch.analysis.callgraph", "repro_torch.analysis.ast_lint", "repro_torch.analysis.baseline",
            "repro_torch.analysis.hotpaths", "repro_torch.analysis.sync_audit",
            "repro_torch.analysis.__main__"} <= set(modules)
    script = (
        "import sys, importlib\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None  # any import of it raises ImportError\n"
        f"sys.path[:] = [{str(ROOT / 'src')!r}] + [p for p in sys.path if p not in ('', {str(ROOT)!r})]\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro') "
        "and sys.modules[m] is not None)\n"
        "assert not leaked, leaked\n"
        "print(len(" + repr(modules) + "))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=300, cwd=str(PORT.parent),
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip() == str(len(modules))


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_source_of_the_port_imports_jax_or_the_reference(path):
    assert _forbidden_imports(path) == []
