"""The port must import and run without JAX and without the JAX package:
the GPU machine has no JAX, and the port keeps its own copy of whatever it
needs from that package."""

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
        "sys.modules['pli_slam_tpu'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('jax', 'pli_slam_tpu') for k, v in sys.modules.items() if v is not None)\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=str(ROOT),
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_imports_no_jax():
    """Neither JAX nor any module of the JAX package: the script reaches the
    configuration through the port's own `utils/config.py`."""
    src = (ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import jax|from jax)\b", src, re.M)
    assert not re.search(r"^\s*(from|import)\s+pli_slam_tpu\b(?!_torch)", src, re.M)
    assert "pli_slam_tpu." not in src


def test_no_source_file_imports_the_jax_package():
    """No file of the port, and not chip_smoke.py, imports `pli_slam_tpu`,
    directly or from a submodule: not even a module there that imports no JAX."""
    pattern = re.compile(r"^\s*(from|import)\s+pli_slam_tpu\b(?!_torch)", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert not offenders, offenders


def test_no_source_file_mentions_a_jax_import():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    offenders = [str(p) for p in PKG.rglob("*.py") if pattern.search(p.read_text())]
    assert not offenders, offenders
