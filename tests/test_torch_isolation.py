"""The PyTorch port stands alone: ``scgib_tpu_torch`` and ``chip_smoke.py``
import nothing of JAX, flax, optax or the JAX package ``scgib_tpu``, nor the
``msgpack`` package (the card's machine may not have it), and
import cleanly on a machine without a GPU, ``nvcc`` or ``triton`` (the
kernels are built at first use, never at import)."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "optax", "scgib_tpu", "msgpack")
SOURCES = sorted((ROOT / "scgib_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_banned_import_in_source(path):
    bad = sorted(set(_imported_roots(path)) & set(BANNED))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_training_layer_imports_no_kernel_module():
    """``train/`` reads the counts from ``utils/counters.py`` alone: none of
    its modules imports from ``ops.kernels``."""
    for path in sorted((ROOT / "scgib_tpu_torch" / "train").glob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        names = [alias.name for node in ast.walk(tree)
                 if isinstance(node, ast.Import) for alias in node.names]
        names += [f"{node.module or ''}.{alias.name}"
                  for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom)
                  for alias in node.names]
        bad = [n for n in names if "ops.kernels" in n]
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_blocked():
    """Every module of the package (and chip_smoke.py) imports in a fresh
    interpreter where importing any banned name raises."""
    code = f"""
import importlib, pkgutil, sys
for name in {BANNED!r}:
    sys.modules[name] = None
sys.path.insert(0, {str(ROOT)!r})
import scgib_tpu_torch
names = [m.name for m in pkgutil.walk_packages(scgib_tpu_torch.__path__,
                                               "scgib_tpu_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
leaked = sorted(n for n in sys.modules if n.split(".")[0] in {BANNED!r}
                and sys.modules[n] is not None)
assert not leaked, leaked
print(len(names))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20
