"""Structured per-pass timing.

Every pipeline stage can report wall-clock + voxel throughput into an active
collector::

    with timing.collect() as t:
        table = analyze(image, device="cuda")
    print(t.report())          # per-stage wall-clock + Mvox/s

A stage given a CUDA ``device`` fences with ``torch.cuda.synchronize`` on
entry and exit, so its time covers the device work it enqueued, not only the
launch. Collection is zero-overhead when inactive: no fence, no clock.
``TA_STAGE_VERBOSE`` (``1``/``true``/``yes``/``on``) additionally prints a
timestamped line as each stage enters and leaves; it is read at call time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import List, Optional

import torch

__all__ = ["Timings", "collect", "stage"]

_tls = threading.local()

_VERBOSE_ON = ("1", "true", "yes", "on")


@dataclasses.dataclass
class Stage:
    name: str
    seconds: float
    voxels: Optional[int] = None

    @property
    def mvox_s(self) -> Optional[float]:
        if self.voxels is None or self.seconds <= 0:
            return None
        return self.voxels / self.seconds / 1e6


@dataclasses.dataclass
class Timings:
    stages: List[Stage] = dataclasses.field(default_factory=list)

    def add(self, name: str, seconds: float, voxels: Optional[int] = None):
        self.stages.append(Stage(name, seconds, voxels))

    def total(self) -> float:
        return sum(s.seconds for s in self.stages)

    def report(self) -> str:
        lines = []
        for s in self.stages:
            tp = f"  {s.mvox_s:10.1f} Mvox/s" if s.mvox_s is not None else ""
            lines.append(f"{s.name:<28s} {s.seconds * 1e3:9.2f} ms{tp}")
        lines.append(f"{'total':<28s} {self.total() * 1e3:9.2f} ms")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {
            s.name: {"seconds": s.seconds, "mvox_s": s.mvox_s}
            for s in self.stages
        }


@contextlib.contextmanager
def collect():
    """Activate a Timings collector for the enclosed scope (per thread)."""
    prev = getattr(_tls, "timings", None)
    t = Timings()
    _tls.timings = t
    try:
        yield t
    finally:
        _tls.timings = prev


def _fence(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def stage(name: str, voxels: Optional[int] = None, device=None):
    """Record one pipeline stage into the active collector (no-op if none)."""
    verbose = os.environ.get("TA_STAGE_VERBOSE", "").lower() in _VERBOSE_ON
    t: Optional[Timings] = getattr(_tls, "timings", None)
    if t is None and not verbose:
        yield
        return
    if verbose:
        print(time.strftime("[%H:%M:%S]"), "stage:", name, flush=True)
    _fence(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _fence(device)
        dt = time.perf_counter() - t0
        if verbose:
            print(
                time.strftime("[%H:%M:%S]"), f"stage done ({dt:.3f}s):",
                name, flush=True,
            )
        if t is not None:
            t.add(name, dt, voxels)
