"""Spans, counters and stages: the port's tracing.

Each layer of a pass opens a span where its work happens; a collector
records them::

    with timing.collect(fence=False) as t:
        table = analyze_stack(stack, device="cuda")
    t.spans       # every span, parents before children
    t.counts      # {pass id: {counter: value}}
    print(t.report())

A span (:func:`span`) records its name, its start and end
(``time.perf_counter_ns``), the span around it (``parent``), the pass id
of the pass it belongs to and a few attributes (``L``, ``B``, bytes). The
root span of a pass is given a new id (:func:`new_pass`); every span opened
inside it on the same thread inherits the id. A *wait* span (:func:`wait`)
encloses a call that makes the host wait for the device (a readback, an
output whose size the device decides): its ``site`` names the call and
``attrs["syncs"]`` the synchronising calls inside it, so the wait spans of
a pass add up to its syncs and to the time the host spent waiting.
:func:`count` adds to a counter of the pass of the innermost open span.

Three modes:

- off (the default): a span, a wait or a counter costs one test of a
  module flag; no clock, no fence;
- ``collect()``: stages alone (:func:`stage`). A stage given a CUDA
  ``device`` fences with ``torch.cuda.synchronize`` on entry and exit, so
  that its time covers the device work it enqueued, not only the launch;
  other spans and counters are not recorded, so the stages read what they
  always read;
- ``collect(fence=False)``: every span, stage and counter, unfenced, in
  memory; a stage is also a span (under its ``span`` name where one is
  given).

``TA_STAGE_VERBOSE`` (``1``/``true``/``yes``/``on``) additionally prints a
timestamped line as each stage enters and leaves; it is read at call time.

:func:`profile_trace` records a ``torch.profiler`` trace of the enclosed
scope, for the device time of each launch (:func:`device_times`). While it
is active every span and stage is also a ``record_function`` range named
``ta.<name>#<pass id>`` (:data:`PREFIX`; a wait is ``<name>:<site>``), so
that the Chrome trace puts each device operation and each idle gap under
the program spans around it, on one clock. Host times come from collected
spans, never from a trace: the profiler slows the host.

:func:`sync_check` holds the wait spans of a pass on a card against the
synchronising calls that CUDA's sync debug mode reports.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import os
import threading
import time
from typing import Dict, List, Optional

import torch

__all__ = [
    "Timings", "Span", "collect", "stage", "span", "wait", "count", "new_pass",
    "profile_trace", "device_times", "sync_check", "PREFIX",
]

#: the start of every range this module adds to a profiler trace
PREFIX = "ta."

_tls = threading.local()
_lock = threading.Lock()
# collectors and profile traces active in any thread: the one test a span
# makes when tracing is off
_on = 0
_profiling = 0
_pass_ids = itertools.count(1)

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


class Span:
    """One span of :func:`span` or :func:`wait`, and the context manager
    that opens it. ``set(**attrs)`` adds attributes while it is open."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "pass_id", "site", "attrs",
                 "child_ns", "_stack", "_rf")

    def __init__(self, name: str, pass_id: Optional[int], site: Optional[str], attrs: dict):
        self.name, self.pass_id, self.site, self.attrs = name, pass_id, site, attrs
        self.start_ns = self.end_ns = self.child_ns = 0
        self.parent: Optional[Span] = None
        self._stack = self._rf = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    @property
    def self_seconds(self) -> float:
        """The span's time less what its child spans cover."""
        return (self.end_ns - self.start_ns - self.child_ns) * 1e-9

    @property
    def wait(self) -> bool:
        return self.site is not None

    def inside(self, name: str) -> bool:
        """Whether a span named ``name`` encloses this one."""
        p = self.parent
        while p is not None:
            if p.name == name:
                return True
            p = p.parent
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def _open(self, t: Optional["Timings"]) -> None:
        """Take the place of the innermost open span of this thread, in
        ``t`` where it records spans, and in the profiler's trace."""
        stack = getattr(_tls, "open", None)
        if stack is None:
            stack = _tls.open = []
        if stack:
            self.parent = parent = stack[-1]
            if self.pass_id is None:
                self.pass_id = parent.pass_id
        stack.append(self)
        self._stack = stack
        if t is not None and not t.fence:
            t.spans.append(self)
        if _profiling:
            tag = self.name if self.site is None else f"{self.name}:{self.site}"
            if self.pass_id is not None:
                tag = f"{tag}#{self.pass_id}"
            self._rf = torch.profiler.record_function(PREFIX + tag)
            self._rf.__enter__()

    def __enter__(self) -> "Span":
        self._open(getattr(_tls, "timings", None))
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = end = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self._stack.pop()
        self._stack = None
        if self.parent is not None:
            self.parent.child_ns += end - self.start_ns


class _Stage(Span):
    """A :func:`stage`: fenced under ``collect()``, a span as well under
    ``collect(fence=False)`` and while a profile is taken."""

    __slots__ = ("_stage", "_t", "_fenced")

    def __init__(self, name: str, attrs: dict, stage: str, voxels, device, verbose: bool):
        super().__init__(name, None, None, attrs)
        self._stage = (stage, voxels, device, verbose)
        self._t = None
        self._fenced = False

    def __enter__(self) -> "Span":
        self._t = t = getattr(_tls, "timings", None)
        name, _, device, verbose = self._stage
        # fenced under collect(), and where a verbose stage is not collected
        self._fenced = t.fence if t is not None else verbose
        if verbose:
            print(time.strftime("[%H:%M:%S]"), "stage:", name, flush=True)
        if self._fenced:
            _fence(device)
        if (t is not None and not t.fence) or _profiling:
            self._open(t)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t, (name, voxels, device, verbose) = self._t, self._stage
        self._t = None
        if self._fenced:
            _fence(device)
        if self._stack is not None:
            super().__exit__(*exc)
        else:
            self.end_ns = time.perf_counter_ns()
        dt = self.seconds
        if verbose:
            print(time.strftime("[%H:%M:%S]"), f"stage done ({dt:.3f}s):",
                  name, flush=True)
        if t is not None:
            if isinstance(voxels, (tuple, list)):
                voxels = math.prod(int(s) for s in voxels)
            t.add(name, dt, voxels)


class _Off:
    """What a span is when nothing records it."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        return None


_OFF = _Off()


@dataclasses.dataclass
class Timings:
    """What a :func:`collect` scope recorded: ``stages`` in both modes;
    with ``fence=False`` also every span (``spans``, in the order they
    opened) and the counters of each pass (``counts``, keyed by pass id;
    None for counts made outside any pass)."""

    stages: List[Stage] = dataclasses.field(default_factory=list)
    spans: List[Span] = dataclasses.field(default_factory=list)
    counts: Dict[Optional[int], Dict[str, int]] = dataclasses.field(default_factory=dict)
    fence: bool = True

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


def _turn(on: int, profiling: int = 0) -> None:
    global _on, _profiling
    with _lock:
        _on += on
        _profiling += profiling


@contextlib.contextmanager
def collect(fence: bool = True):
    """Activate a Timings collector for the enclosed scope (per thread):
    fenced stages alone, or with ``fence=False`` every span, stage and
    counter, unfenced."""
    prev = getattr(_tls, "timings", None)
    t = Timings(fence=fence)
    _tls.timings = t
    _turn(1)
    try:
        yield t
    finally:
        _tls.timings = prev
        _turn(-1)


def new_pass() -> int:
    """A new pass id, for the root span of a pass."""
    return next(_pass_ids)


def _recording() -> bool:
    """Whether this thread records spans: an unfenced collector, or a
    profile."""
    t = getattr(_tls, "timings", None)
    return _profiling or (t is not None and not t.fence)


def span(name: str, pass_id: Optional[int] = None, **attrs):
    """A span of the current pass, or of pass ``pass_id`` (a root span)."""
    if not _on or not _recording():
        return _OFF
    return Span(name, pass_id, None, attrs)


def wait(site: str, syncs: int = 1, name: str = "wait", **attrs):
    """A span around ``syncs`` calls that wait for the device, at ``site``."""
    if not _on or not _recording():
        return _OFF
    attrs["syncs"] = syncs
    return Span(name, None, site, attrs)


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to counter ``name`` of the current pass."""
    if not _on:
        return
    t = getattr(_tls, "timings", None)
    if t is None or t.fence:
        return
    stack = getattr(_tls, "open", None)
    got = t.counts.setdefault(stack[-1].pass_id if stack else None, {})
    got[name] = got.get(name, 0) + k


def _fence(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def stage(name: str, voxels=None, device=None, span: Optional[str] = None, **attrs):
    """Record one pipeline stage into the active collector (no-op if none).

    ``voxels`` is a count or a shape, whose product is taken only when the
    stage is recorded. Under ``collect(fence=False)`` the stage is also a
    span, named ``span`` where given, with ``attrs``."""
    verbose = os.environ.get("TA_STAGE_VERBOSE", "").lower() in _VERBOSE_ON
    if not _on and not verbose:
        return _OFF
    return _Stage(span or name, attrs, name, voxels, device, verbose)


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
    device is available; every span and stage opened inside is a range
    named ``ta.<name>#<pass id>``.

    It is an instrument for DEVICE time only. The profiler's hooks slow the
    host side badly where it makes many small calls (a 262,144-label
    ``analyze_stack`` took 2.5 s a call under it against 0.14 s without on
    an H100's host), so read host times from spans under
    ``collect(fence=False)``, never from a trace."""
    import torch.profiler as tp

    os.makedirs(log_dir, exist_ok=True)
    on_card = torch.cuda.is_available()
    activities = [tp.ProfilerActivity.CPU]
    if on_card:
        activities.append(tp.ProfilerActivity.CUDA)
    prof = tp.profile(activities=activities)
    prof.trace_path = None
    prof.start()
    _turn(1, 1)
    try:
        yield prof
    finally:
        _turn(-1, -1)
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
    the block sweep is, has no row there). Empty for a trace of CPU work.
    Ranges (a span's, or any ``record_function``'s) are no entries: the
    profiler keeps one on the device's side too where it encloses device
    work, and its time is that of the entries inside it."""
    from torch.autograd import DeviceType

    want = DeviceType.CPU if by_op else DeviceType.CUDA
    rows = []
    for e in prof.key_averages():
        if (e.device_type != want or getattr(e, "is_user_annotation", False)
                or e.key.startswith(PREFIX)):
            continue
        # the attribute was renamed from cuda_ to device_ across versions
        total = getattr(e, "self_device_time_total", None)
        if total is None:
            total = e.self_cuda_time_total
        if total > 0 or not by_op:
            rows.append((e.key, int(e.count), float(total)))
    rows.sort(key=lambda r: -r[2])
    return rows


def sync_check(run) -> dict:
    """Run ``run()`` under ``collect(fence=False)`` with
    ``torch.cuda.set_sync_debug_mode("warn")``: ``warnings`` (the
    synchronising calls that the mode reports), ``wait_syncs`` (the syncs of
    the wait spans recorded) and ``outside_waits`` (the calls, as a few
    frames of their stack, made under no wait span). Every sync of ``run``
    sits in a wait span where the first two are equal and the last is
    empty."""
    import traceback
    import warnings

    seen, where = [], []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        stack = getattr(_tls, "open", None) or []
        seen.append(any(s.wait for s in stack))
        if not seen[-1]:
            where.append(" < ".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                                    for f in reversed(traceback.extract_stack()[-6:-1])))

    torch.cuda.set_sync_debug_mode("warn")  # the call itself synchronises once
    try:
        with collect(fence=False) as t, warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return {"warnings": len(seen),
            "wait_syncs": sum(s.attrs["syncs"] for s in t.spans if s.wait),
            "outside_waits": where}
