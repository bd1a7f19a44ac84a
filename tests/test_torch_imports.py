"""The port stands alone: it imports torch and numpy, never JAX and nothing
of the JAX package ``repro``, and importing it builds no kernel."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(p.relative_to(ROOT) for p in PORT.rglob("*.py")) + [
    Path("chip_smoke.py")] + sorted(
        p.relative_to(ROOT) for p in (ROOT / "tools").glob("*.py"))


def _imports(path):
    tree = ast.parse((ROOT / path).read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=str)
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton")]
    assert not bad, f"{path} imports {bad}"


def test_import_repro_torch_loads_neither_jax_nor_repro():
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in PORT.rglob("*.py")]
    mods = [m.removesuffix(".__init__") for m in mods]
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "from repro_torch.kernels import _build\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton'))\n"
            "assert not bad, bad\n"
            "assert not _build._libs, 'a kernel was loaded on import'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Alone in a directory (no package beside it) and without a CUDA card,
    chip_smoke.py exits nonzero and prints no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, lone)):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
