"""Leveled logger and per-stage timing CSV (port of pli_slam_tpu.utils.log).

The levels are the reference's `Verbose` (QUIET .. DEBUG; QUIET by
default, set with `PLI_SLAM_VERBOSITY=normal|verbose|very_verbose|debug`).
`StageTimer` accumulates each frame's stage wall times and writes the
SAVE_TIMES-style CSV (`frame,<stage>,...` in ms).

On a GPU the host returns from a stage as soon as its work is queued, so a
host clock alone times the launches, not the work. `StageTimer(stages,
device=...)` with a CUDA device synchronises that device at both ends of
every stage: each recorded time is then the stage's whole wall time, its
device work included (and the frame is serialised, which costs the overlap
of host and device work that an unsynchronised run has). Without a device,
or with the CPU, it records host time only, as the reference does.
"""

from __future__ import annotations

import os
import sys
import time

import torch

QUIET, NORMAL, VERBOSE, VERY_VERBOSE, DEBUG = 0, 1, 2, 3, 4
_NAMES = {QUIET: "QUIET", NORMAL: "NORMAL", VERBOSE: "VERBOSE", VERY_VERBOSE: "VERY_VERBOSE", DEBUG: "DEBUG"}

_level = QUIET
_env = os.environ.get("PLI_SLAM_VERBOSITY", "").upper()
for _k, _v in _NAMES.items():
    if _env == _v:
        _level = _k


def set_level(level: int) -> None:
    global _level
    _level = level


def get_level() -> int:
    return _level


def log(msg: str, level: int = NORMAL) -> None:
    """Print `msg` to stderr if `level` is within the current verbosity."""
    if level <= _level:
        print(msg, file=sys.stderr, flush=True)


def debug(msg: str) -> None:
    log(msg, DEBUG)


class StageTimer:
    """Per-frame stage wall times and their CSV:

        timer = StageTimer(["ingest", "track"], device=tracker.device)
        with timer.stage("track"): ...
        timer.end_frame()
        timer.save_csv("track_times.csv")
    """

    def __init__(self, stages: list[str], device=None):
        self.stages = list(stages)
        self.rows: list[dict[str, float]] = []
        self._cur: dict[str, float] = {}
        dev = None if device is None else torch.device(device)
        self.device = dev if dev is not None and dev.type == "cuda" else None

    def _sync(self) -> None:
        if self.device is not None:
            torch.cuda.synchronize(self.device)

    class _Ctx:
        def __init__(self, timer: "StageTimer", name: str):
            self.timer, self.name = timer, name

        def __enter__(self):
            self.timer._sync()
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.timer._sync()
            dt = time.perf_counter() - self.t0
            self.timer._cur[self.name] = self.timer._cur.get(self.name, 0.0) + dt
            return False

    def stage(self, name: str) -> "StageTimer._Ctx":
        return StageTimer._Ctx(self, name)

    def end_frame(self) -> None:
        self.rows.append(self._cur)
        self._cur = {}

    def save_csv(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("frame," + ",".join(self.stages) + "\n")
            for i, row in enumerate(self.rows):
                f.write(f"{i}," + ",".join(f"{row.get(s, 0.0) * 1e3:.3f}" for s in self.stages) + "\n")

    def means_ms(self) -> dict[str, float]:
        if not self.rows:
            return {s: 0.0 for s in self.stages}
        return {s: 1e3 * sum(r.get(s, 0.0) for r in self.rows) / len(self.rows) for s in self.stages}
