"""One run of one cell: set-up, the measured window, the traced passes and
the check of every table against the reference.

:func:`run_cell` does all of it on a given device and returns the result
line as a dict; ``run.py`` adds the command line, the look for a card and
the look for modules that no run may load.

The order of a run:

1. set-up (``setup_s``, from the process's start): the frames are made on
   the device from the seed (:mod:`perfbench.frames`), handed to the
   traffic's pass (``passes/<pass>.py``), which ingests them, and each
   frame is passed ``warmup`` times, so that every shape the window uses
   is built and warm;
2. the window: passes in turn over the frames, each timed on the host
   clock from the call to its table on the host, until ``seconds`` have
   passed, with the calling thread held on one core; the peak of device
   memory is read from the window's start on, so that it holds the
   program's frames and working memory and not the generator's;
3. with ``trace`` only: passes under the program's ``timing.collect()``,
   whose fenced stages give the host's share of a pass, then passes under
   the program's ``timing.profile_trace``, with the benchmark's host spans
   (``spans/<span>.json``) around the program's calls, for device time;
4. the program's stacks are let go, the reference works out each frame's
   table again from its raw labels (:mod:`perfbench.reference`), and every
   table of the passes checked is held against it (:mod:`perfbench.judge`):
   the first of each frame, the window's last, a share of the window's
   others drawn from the seed (the traffic's ``checked_share``), every
   window pass whose integer fields differ from its frame's first table's
   (compared in the window, as each pass ends), and every traced pass.

With ``trace`` 0 the metrics are the cell's end-to-end metrics, with 1 its
per-layer ones; each is read from the run's :class:`Evidence` by its reader,
``metrics/<name>.py``, which returns None where it finds nothing to read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import os
import shutil
import statistics
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench import frames, judge, reference, roofline, spec, trace

__all__ = ["Evidence", "run_cell", "span", "installed_spans"]

STAGE_PASSES = 3  # fenced passes of each frame under timing.collect()
TRACED_PASSES = 2  # profiled passes of each frame


@dataclasses.dataclass
class Evidence:
    """What a run measured, for the metric readers."""

    setup_s: float
    pass_s: List[float]  # every pass of the window, host clock
    window_s: float
    voxels: int  # voxels analysed in the window
    peak_window_bytes: int  # device memory at the window's peak, above its start
    stages: List[Dict[str, float]]  # fenced passes: stage seconds, and "pass"
    trace: Optional[trace.TraceSummary]
    traced_passes: int
    work_bytes: float  # least bytes of a pass (roofline.pass_bytes), mean
    peak_bytes_per_s: Optional[float]

    def stage_ms(self, *names: str) -> Optional[float]:
        """Median over the fenced passes of the summed ``names`` stages, in
        ms; None where no pass has any of them."""
        got = [sum(s[n] for n in names if n in s) for s in self.stages
               if any(n in s for n in names)]
        return statistics.median(got) * 1e3 if got else None

    def host_ms(self) -> Optional[float]:
        """Median over the fenced passes of the pass less its stages, ms."""
        got = [s["pass"] - sum(v for k, v in s.items() if k != "pass") for s in self.stages]
        return statistics.median(got) * 1e3 if got else None

    def device_ms(self) -> Optional[float]:
        """Device time a traced pass, ms."""
        if self.trace is None or not self.traced_passes or self.trace.device_s <= 0:
            return None
        return self.trace.device_s / self.traced_passes * 1e3

    def kernel_ms(self, pattern: str) -> Optional[float]:
        """Device time a traced pass of the operations named ``pattern``."""
        if self.trace is None or not self.traced_passes:
            return None
        s = self.trace.kernel_s(pattern)
        return s / self.traced_passes * 1e3 if s > 0 else None


def span(name: str):
    """A host span of the benchmark, seen by the profiler when it runs."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def installed_spans(targets: Dict[str, str]):
    """Wrap each ``"module:attribute"`` of ``targets`` in a span of its
    name for the enclosed scope; a target the program lacks raises, so
    that no span drops out of the breakdown unseen."""
    undo = []

    def wrapped(name, fn):
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call

    try:
        for name, target in targets.items():
            mod_name, attr = target.split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr, None)
            if not callable(fn):
                raise AttributeError(f"span {name!r}: the program has no {target}")
            setattr(mod, attr, wrapped(name, fn))
            undo.append((mod, attr, fn))
        yield [u[1] for u in undo]
    finally:
        for mod, attr, fn in reversed(undo):
            setattr(mod, attr, fn)


@contextlib.contextmanager
def pinned():
    """The calling thread held on one core of those it may use, and torch's
    CPU operations on one thread, for the enclosed scope. Threads that exist
    already, such as the CUDA runtime's and the native library's, keep theirs."""
    cores = sorted(os.sched_getaffinity(0)) if hasattr(os, "sched_setaffinity") else []
    threads = torch.get_num_threads()
    if cores:
        os.sched_setaffinity(0, {cores[-1]})
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if cores:
            os.sched_setaffinity(0, cores)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, wrap: Optional[Callable] = None,
             first_setup: Optional[bool] = None) -> dict:
    """Run ``cell`` once on ``device`` and return its result line.
    ``t_start`` is the process's start on ``time.perf_counter``'s clock;
    ``wrap``, where given, is called with the pass, the raw frames and the
    device, and returns what the window calls instead (the control and the
    tests' faults); ``first_setup`` says whether
    set-up had to build the program's kernels."""
    from tissue_analysis_tpu_torch.utils import timing

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, traffic = cell.config, cell.traffic
    n_frames = int(traffic["frames"])
    phases = {"start": time.perf_counter() - t_start}
    mark = time.perf_counter()

    def lap(name):
        nonlocal mark
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    with span("generate"):
        raw = [frames.make_frame(cfg, traffic, seed, i, dev, int(cfg["background"]))
               for i in range(n_frames)]
    if cuda:
        torch.cuda.empty_cache()  # the generator's scratch is no one's memory
    lap("generate")
    program = spec.load_module("passes", traffic["pass"], cell.root).make(
        raw, cfg, traffic, dev, span)
    lap("ingest")
    if wrap is not None:
        program = wrap(program, raw, dev)
    for k in range(int(traffic["warmup"]) * n_frames):
        program(k)
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    lap("warmup")

    # the window
    gc.collect()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) if cuda else 0
    # the tables the check reads: the first pass of each frame, the last
    # pass, a share of the others drawn from the seed, and any whose integer
    # fields differ from its frame's first; the rest are let go as a
    # pipeline would, so that the window's host memory stays flat
    draw = np.random.default_rng(frames.frame_seed(seed, n_frames))
    share = float(traffic["checked_share"])
    tables, firsts, pass_s, voxels, k = [], {}, [], 0, 0
    with pinned():
        start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            table = program(k)
            t1 = time.perf_counter()
            pass_s.append(t1 - t0)
            voxels += program.voxels(k)
            last = t1 - start >= seconds
            f = program.frame(k)
            first = f not in firsts
            if first:
                firsts[f] = table
            if (first or last or draw.random() < share
                    or not judge.same_integers(table, firsts[f])):
                tables.append((f, table))
            del table
            k += 1
            if last:
                break
    window_s = t1 - start
    peak_window = (torch.cuda.max_memory_allocated(dev) - base) if cuda else 0
    del firsts

    stages, summary, n_traced = [], None, 0
    if traced:
        for _ in range(STAGE_PASSES * n_frames):
            _sync(dev)
            t0 = time.perf_counter()
            with timing.collect() as tm:
                table = program(k)
            _sync(dev)
            got = {"pass": time.perf_counter() - t0}
            for s in tm.stages:
                got[s.name] = got.get(s.name, 0.0) + s.seconds
            stages.append(got)
            tables.append((program.frame(k), table))
            k += 1
        targets = spec.load_spans(cell.root)
        log_dir = tempfile.mkdtemp(prefix="perfbench-trace-")
        try:
            with installed_spans(targets), timing.profile_trace(log_dir) as prof:
                for _ in range(TRACED_PASSES * n_frames):
                    with span("pass"):
                        table = program(k)
                    tables.append((program.frame(k), table))
                    k += 1
                    n_traced += 1
            summary = trace.read_trace(
                prof.trace_path, ["pass", "generate", "ingest", *targets])
        finally:
            shutil.rmtree(log_dir, ignore_errors=True)
    lap("window")
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # the check, once the program's state is let go
    work = [roofline.pass_bytes(t.shape, t.n_labels, t.n_pairs) for _, t in tables]
    checked = len(tables)
    program.close()
    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    refs = [reference.reference_table(r, cfg["voxelsize"], int(cfg["background"]), dev)
            for r in raw]
    lap("reference")
    checks, failed = judge.judge(tables, refs, spec.load_limits(cell.root))
    lap("judge")
    correct = bool(tables) and all(v <= lim for v, lim in checks.values())

    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    ev = Evidence(
        setup_s=setup_s, pass_s=pass_s, window_s=window_s, voxels=voxels,
        peak_window_bytes=peak_window, stages=stages, trace=summary,
        traced_passes=n_traced, work_bytes=float(np.mean(work)),
        peak_bytes_per_s=roofline.peak_bytes_per_s(name),
    )
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.load_module("metrics", m["name"], cell.root).read(ev)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": len(pass_s) + len(stages) + n_traced,
        "failed": failed,
        "checked": checked,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else dev.type,
            "kind": name,
            "count": cell.chips,
            "memory_peak_bytes": int(memory_peak),
        },
        "first_setup": first_setup,
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in list(summary.ops.items())[:10]],
            "idle_gaps": [[n, s] for n, s in summary.gaps[:10]],
        }
    result["phases_s"] = phases
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result
