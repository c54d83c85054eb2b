"""The port stands alone: no file of `src/repro_torch/`, not
`chip_smoke.py` and no port-side example twin (`examples/*_torch.py`)
imports jax or any module of the reference package, and importing the port
loads neither."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "examples").glob("*_torch.py")))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    code = (
        "import sys, importlib, pkgutil, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Alone in a directory, or with no CUDA device, the chip check fails
    and prints no result line."""
    import shutil

    if shutil.which("nvidia-smi"):
        pytest.skip("a card may be present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((tmp_path, lone), (ROOT, ROOT / "chip_smoke.py")):
        run = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=120, env=dict(os.environ, PYTHONPATH=""))
        assert run.returncode != 0
        assert '"ok": true' not in run.stdout


DIST_MODULES = ("dist/sharding.py", "dist/grad_compression.py", "launch/mesh.py",
                "launch/specs.py")


@pytest.mark.parametrize("rel", DIST_MODULES)
def test_distribution_modules_exist_and_import_neither_jax_nor_the_reference(rel):
    """The distribution layer's modules are the port's own copies: present,
    checked by the walk above, and free of jax and the reference."""
    path = ROOT / "src" / "repro_torch" / rel
    assert path in PORT_FILES
    assert [m for m in _imported_modules(path) if _forbidden(m)] == []
