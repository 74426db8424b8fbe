"""Times the tier-1 test command (ROADMAP.md, "Tier-1 verify": 6 xdist
workers, `--dist loadfile`, a 1470 s limit) and reads where its time goes.

    python tests/tier1_time.py run TAG [--cold] [--limit 2400]
        the command from the repository's root with `--durations=0` added,
        and this module as a plugin that records, in the controller, when
        each test's setup and teardown reports arrive and from which worker;
        its log, its junitxml and that record go to build/tier1/TAG.{log,
        xml,events}. `--cold` points the reference's XLA compile cache
        (tests/conftest.py's `jax_compilation_cache_dir`) at a new empty
        directory, build/tier1/TAG.jax_cache, in the controller and in every
        worker, so that every compile of the run is a new one; the directory
        is removed when the run ends.
    python tests/tier1_time.py report TAG [TAG ...]
        per run: pytest's counts and wall time, the tests' summed time, the
        20 longest files (setup + call + teardown, summed from the junitxml),
        and the files still running in the last 10% of the run.
    python tests/tier1_time.py compare COLD WARM
        the port's files whose cold time exceeds their warm time the most:
        what the reference's compiles cost them.

`--out DIR` reads and writes DIR instead of build/tier1. The junitxml lists
the tests in the order they started, not the order they ended, so the tail
is read from the record, which only `run` makes.
"""

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PYTEST_ARGS = ["tests/", "-q", "-m", "not slow", "--continue-on-collection-errors", "-p", "no:cacheprovider",
               "-p", "xdist", "-n", "6", "--dist", "loadfile", "-p", "no:randomly", "--durations=0"]
EVENTS = "TIER1_TIME_EVENTS"  # where the plugin writes its record; unset, it records nothing
COLD = "TIER1_TIME_JAX_CACHE"  # the compile cache directory of a cold run; unset, conftest's stays


def run(tag: str, out: Path, cold: bool, limit: float) -> int:
    out = out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    cache = out / f"{tag}.jax_cache"
    shutil.rmtree(cache, ignore_errors=True)
    path = os.pathsep.join(p for p in (str(ROOT / "tests"), os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, JAX_PLATFORMS="cpu", ALLOW_MULTIPLE_LIBTPU_LOAD="1", PYTHONPATH=path,
               **{EVENTS: str(out / f"{tag}.events")})
    env.pop(COLD, None)
    if cold:
        cache.mkdir()
        env[COLD] = str(cache)
    cmd = ["timeout", "-k", "10", str(limit), sys.executable, "-m", "pytest", *PYTEST_ARGS, "-p", "tier1_time",
           f"--junitxml={out / (tag + '.xml')}"]
    import xdist

    if not xdist.__version__.startswith("3.8."):  # the verify skill's budget rule reads 3.8's order of files
        print(f"pytest-xdist {xdist.__version__}, not 3.8: check the order in which it hands out files")
    t0 = time.monotonic()
    with open(out / f"{tag}.log", "wb") as log:
        rc = subprocess.run(cmd, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT).returncode
        log.write(f"RC={rc} WALL={time.monotonic() - t0:.1f}\n".encode())
    print(f"{tag}: rc {rc}, {time.monotonic() - t0:.1f} s" + (f", {_entries(cache)} new cache entries" if cold else ""))
    shutil.rmtree(cache, ignore_errors=True)
    return rc


def _entries(cache: Path) -> int:
    return sum(1 for _ in cache.iterdir()) if cache.is_dir() else 0


# -- the plugin: loaded by the controller and by every worker, it records in the controller only --
_record = None


def pytest_configure(config):
    """Runs after tests/conftest.py has set the cache directory and before
    any test compiles, in each process."""
    global _record
    if os.environ.get(COLD):
        import jax

        jax.config.update("jax_compilation_cache_dir", os.environ[COLD])
    if os.environ.get(EVENTS) and not hasattr(config, "workerinput"):
        _record = open(os.environ[EVENTS], "w")
        _record.write(json.dumps({"t0": time.time()}) + "\n")


def pytest_runtest_logreport(report):
    if _record is not None and report.when in ("setup", "teardown"):
        node = getattr(report, "node", None)
        _record.write(json.dumps({"t": time.time(), "id": report.nodeid, "when": report.when,
                                  "duration": report.duration,
                                  "worker": node.gateway.id if node is not None else "main"}) + "\n")
        _record.flush()


def pytest_unconfigure(config):
    if _record is not None:
        _record.close()


# -- reading a run --
def _file(name: str) -> str:
    """The test file of a junitxml classname or a node id."""
    return next(p for p in re.split(r"[./:]+", name) if p.startswith("test_"))


def _cases(out: Path, tag: str) -> list[tuple[str, str, float]]:
    """(file, test, seconds) from the junitxml."""
    return [(_file(c.get("classname")), c.get("name"), float(c.get("time")))
            for c in ET.parse(out / f"{tag}.xml").getroot().iter("testcase")]


def per_file(cases) -> dict[str, list[float]]:
    files = collections.defaultdict(list)
    for f, _, t in cases:
        files[f].append(t)
    return files


def spans(out: Path, tag: str) -> dict[str, tuple[str, float, float]]:
    """file -> (worker, start, end), in seconds from the run's start, from the record."""
    path = out / f"{tag}.events"
    if not path.exists():
        return {}
    lines = [json.loads(line) for line in open(path)]
    t0, found = lines[0]["t0"], {}
    for e in lines[1:]:
        f = _file(e["id"])
        begin = e["t"] - t0 - (e["duration"] if e["when"] == "setup" else 0.0)
        w, s, end = found.get(f, (e["worker"], begin, begin))
        found[f] = (w, min(s, begin), max(end, e["t"] - t0))
    return found


def report(out: Path, tag: str) -> None:
    files = {f: sum(v) for f, v in per_file(_cases(out, tag)).items()}
    log = (out / f"{tag}.log").read_bytes()
    summary = re.findall(rb"\n=* ?(.*? in [0-9.]+s)", log)
    rc = re.search(rb"RC=(-?\d+)", log)
    print(f"## {tag}: rc {rc.group(1).decode() if rc else '?'}; "
          f"{summary[-1].decode() if summary else 'no summary (cut)'}; "
          f"the tests' times sum to {sum(files.values()):.1f} s (the port's files "
          f"{sum(t for f, t in files.items() if f.startswith('test_torch_')):.1f} s)")
    print("  longest files (s): " + ", ".join(f"{f} {t:.1f}"
                                                for f, t in sorted(files.items(), key=lambda kv: -kv[1])[:20]))
    found = spans(out, tag)
    if found:
        last = max(e for _, _, e in found.values())
        tail = sorted((f for f in found if found[f][2] >= 0.9 * last), key=lambda f: found[f][2])
        print(f"  last test ended at {last:.1f} s; running after {0.9 * last:.1f} s: "
              + ", ".join(f"{f} ({found[f][0]}, {found[f][1]:.0f}-{found[f][2]:.0f})" for f in tail))


def compare(out: Path, cold: str, warm: str, n: int = 10) -> None:
    c = {f: sum(v) for f, v in per_file(_cases(out, cold)).items()}
    w = {f: sum(v) for f, v in per_file(_cases(out, warm)).items()}
    rows = sorted(((c[f] - w.get(f, 0.0), f) for f in c if f.startswith("test_torch_")), reverse=True)[:n]
    print(f"## cold {cold} minus warm {warm}, the port's files")
    for d, f in rows:
        print(f"  {f}: cold {c[f]:.1f} s, warm {w.get(f, 0.0):.1f} s, difference {d:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("run", "report", "compare"))
    ap.add_argument("tags", nargs="+")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "tier1")
    ap.add_argument("--cold", action="store_true")
    ap.add_argument("--limit", type=float, default=1470.0)
    args = ap.parse_args(argv)
    if args.what == "run":
        return run(args.tags[0], args.out, args.cold, args.limit)
    if args.what == "report":
        for tag in args.tags:
            report(args.out, tag)
    else:
        compare(args.out, *args.tags[:2])
    return 0


if __name__ == "__main__":
    sys.exit(main())
