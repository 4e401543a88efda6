"""Package hygiene of the port: ``src/repro_torch`` and ``chip_smoke.py``
import neither jax nor the reference package ``repro`` -- checked on the
source (AST) and by importing every module with both blocked."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_modules_import_with_jax_and_reference_blocked():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    script = "\n".join([
        "import importlib, sys",
        *[f"sys.modules[{m!r}] = None" for m in FORBIDDEN],
        f"sys.path.insert(0, {str(ROOT / 'src')!r})",
        f"sys.path.insert(0, {str(ROOT)!r})",
        f"for m in {modules!r} + ['chip_smoke']:",
        "    importlib.import_module(m)",
        "print('ok', len(sys.modules))",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=120, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("ok")
