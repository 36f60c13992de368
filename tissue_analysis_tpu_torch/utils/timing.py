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

:func:`profile_trace` records a ``torch.profiler`` trace of the enclosed
scope, for the device time of each launch (:func:`device_times`). Host
shares still come from the fenced stages above: the profiler slows the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import List, Optional

import torch

__all__ = ["Timings", "collect", "stage", "profile_trace", "device_times"]

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


def _next_trace_path(log_dir: str) -> str:
    """``<log_dir>/trace_NNNN.json`` for the first NNNN not taken."""
    k = 0
    while os.path.exists(os.path.join(log_dir, f"trace_{k:04d}.json")):
        k += 1
    return os.path.join(log_dir, f"trace_{k:04d}.json")


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` trace around the enclosed scope.

    Yields the profiler. On exit (after a fence, when CUDA is in use) it
    stops, and a Chrome trace is written to ``<log_dir>/trace_NNNN.json``
    (``log_dir`` is created if missing; NNNN is the first number not taken,
    so traces of one directory never overwrite each other). The path is
    ``prof.trace_path``; open the file in ``chrome://tracing`` or Perfetto,
    or read ``prof.key_averages()`` (:func:`device_times`) once the scope has
    ended. Host activity is always recorded, device activity when a CUDA
    device is available.

    It is an instrument for DEVICE time only. The profiler's hooks slow the
    host side badly where it makes many small calls (a 262,144-label
    ``analyze_stack`` took 2.5 s a call under it against 0.14 s without on
    an H100's host), so read host shares from fenced :func:`stage` times
    under :func:`collect`, never from a trace."""
    import torch.profiler as tp

    os.makedirs(log_dir, exist_ok=True)
    on_card = torch.cuda.is_available()
    activities = [tp.ProfilerActivity.CPU]
    if on_card:
        activities.append(tp.ProfilerActivity.CUDA)
    prof = tp.profile(activities=activities)
    prof.trace_path = None
    prof.start()
    try:
        yield prof
    finally:
        if on_card and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        path = _next_trace_path(log_dir)
        prof.export_chrome_trace(path)
        prof.trace_path = path


def device_times(prof, by_op: bool = False) -> List[tuple]:
    """(name, calls, total device µs) of a finished :func:`profile_trace`,
    largest total first: every device-side entry (kernel, memcpy, memset),
    or with ``by_op`` every PyTorch operator by the device time of the
    kernels it launched itself (a kernel launched outside any operator, as
    the block sweep is, has no row there). Empty for a trace of CPU work."""
    from torch.autograd import DeviceType

    want = DeviceType.CPU if by_op else DeviceType.CUDA
    rows = []
    for e in prof.key_averages():
        if e.device_type != want:
            continue
        # the attribute was renamed from cuda_ to device_ across versions
        total = getattr(e, "self_device_time_total", None)
        if total is None:
            total = e.self_cuda_time_total
        if total > 0 or not by_op:
            rows.append((e.key, int(e.count), float(total)))
    rows.sort(key=lambda r: -r[2])
    return rows
