"""The port stands alone: importing varanneal_tpu_torch loads neither jax
nor any module of varanneal_tpu, and no source of the port or of
chip_smoke.py imports either (the card's machine has no JAX)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "varanneal_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0], node.lineno


def test_import_leaves_jax_out():
    code = ("import sys, varanneal_tpu_torch\n"
            "import varanneal_tpu_torch.kernels.ag\n"
            "import varanneal_tpu_torch.kernels._build\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_source_imports_jax():
    files = sorted((ROOT / "varanneal_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in files for mod, line in _imported_roots(p)
           if mod in FORBIDDEN]
    assert not bad, bad
