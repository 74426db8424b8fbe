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
    # the walk reaches the stereo-inertial, loop-closing, sensor / facade and ingest slices' modules, the
    # profiling helpers and the drivers
    for name in ("ops.imu", "ops.autodiff", "solve.inertial", "solve.vi_ba", "solve.imu_init", "utils.profile",
                 "utils.kernel_bench", "solve.sim3", "solve.pgo", "solve.pnp", "frontend.loop_closing",
                 "worldmap.atlas", "solve.twoview", "ops.rectify", "utils.trajectory", "system", "utils.euroc",
                 "utils.datasets", "utils.native_loader", "utils.pngio", "utils.log", "utils.livefeed",
                 "utils.viewer", "utils.dataset_writers", "scripts", "scripts.common", "scripts.run_euroc",
                 "scripts.run_tum", "scripts.run_kitti", "scripts.run_synthetic", "scripts.run_live",
                 "scripts.train_vocab", "scripts.diag_ate", "scripts.profile_stages"):
        assert f"pli_slam_tpu_torch.{name}" in mods, name
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pli_slam_tpu'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('jax', 'pli_slam_tpu') for k, v in sys.modules.items() if v is not None)\n"
        "from pli_slam_tpu_torch.utils import native_loader\n"
        "native_loader.build()\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=str(ROOT),
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_native_loader_builds_from_the_port_source():
    """The PNG decoder and prefetcher come from the port's own C++ source
    (no libpng, no zlib: it inflates itself), built into build/native/, never
    from native/, and the port reads PNGs through it, not through pillow."""
    from pli_slam_tpu_torch.utils import native_loader

    assert native_loader.SRC == PKG / "csrc" / "slamio.cpp"
    assert native_loader.BUILD_DIR == ROOT / "build" / "native"
    src = native_loader.SRC.read_text()
    assert "#include <png.h>" not in src and "#include <zlib.h>" not in src
    pil = re.compile(r"^\s*(from|import)\s+PIL\b", re.M)
    assert not [str(p) for p in PKG.rglob("*.py") if pil.search(p.read_text())]


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


def test_no_module_picks_the_cpu_by_itself():
    """An entry point of the port runs on the GPU unless the caller asks for
    the CPU: no source file names the CPU as a device (a default argument, a
    fallback when no GPU is found), and none asks whether CUDA is there in
    order to choose. `utils/profile.py` and `utils/kernel_bench.py` ask only
    to refuse to run without a GPU; `chip_smoke.py` likewise, and its
    card-against-CPU checks name the CPU on purpose. The drivers' one
    device choice, `scripts/common.pick_device`, names the CPU only under
    the caller's `--cpu` flag, and refuses to run without a GPU otherwise."""
    cpu_device = re.compile(r"""(device\s*=\s*["']cpu["']|torch\.device\(\s*["']cpu["']|\.to\(\s*["']cpu["']\s*\)|"""
                            r"""["']cpu["']\s+if\b|else\s+["']cpu["'])""")
    asks_cuda = re.compile(r"cuda\.is_available\(\)")
    refuses = re.compile(r"if not torch\.cuda\.is_available\(\):\s*\n(\s*print\(.*\n)?\s*(?:raise SystemExit|return 2)")
    offenders = []
    for path in PKG.rglob("*.py"):
        src = path.read_text()
        if path == PKG / "scripts" / "common.py":
            assert re.search(r"if cpu:\n\s*return torch\.device\(\"cpu\"\)\n", src)
            src = src.replace('if cpu:\n        return torch.device("cpu")\n', "")
        if cpu_device.search(src):
            offenders.append((str(path), "names the CPU as a device"))
        if len(asks_cuda.findall(src)) != len(refuses.findall(src)):
            offenders.append((str(path), "asks for CUDA other than to refuse to run"))
    assert not offenders, offenders
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert len(asks_cuda.findall(smoke)) == len(refuses.findall(smoke)) == 1
