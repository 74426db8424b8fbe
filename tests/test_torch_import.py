"""The port must import and run without JAX: the GPU machine has none."""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "pli_slam_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_with_jax_blocked():
    mods = list(_modules())
    assert len(mods) > 20
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=str(ROOT),
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_imports_no_jax():
    """Neither JAX nor any module of the JAX package (the port re-exports the
    shared configuration)."""
    src = (ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import jax|from jax)\b", src, re.M)
    assert not re.search(r"^\s*(from|import)\s+pli_slam_tpu\b(?!_torch)", src, re.M)
    assert "pli_slam_tpu." not in src


def test_no_source_file_mentions_a_jax_import():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    offenders = [str(p) for p in PKG.rglob("*.py") if pattern.search(p.read_text())]
    assert not offenders, offenders
