"""The port stands alone: no module under ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax``, the JAX package ``repro``, ``ml_dtypes``
or ``triton`` (checked on the source's AST), and no module builds or loads
a kernel when imported."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "ml_dtypes",
                           "triton"), \
            f"{path.name} imports {mod}"


def test_importing_the_port_loads_no_kernel():
    """Importing every module (in a fresh interpreter) builds, loads and
    imports nothing of the kernel toolchain."""
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            .removesuffix(".__init__") for p in PORT_FILES[:-1]]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from repro_torch.kernels import _build\n"
            "assert _build._libs == {}, _build._libs\n"
            "assert 'triton' not in sys.modules\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " for m in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
