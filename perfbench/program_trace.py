#!/usr/bin/env python3
"""The program's own spans and counters, read per pass.

The program records spans, wait spans and counters where its work happens
(``tissue_analysis_tpu_torch.utils.timing``). Two readings of them:

- :func:`pass_summaries`: the spans of a ``timing.collect(fence=False)``
  scope, per pass, on the host clock and unfenced: the engine's own time
  (the self time of the ``dispatch`` and ``collect`` spans), the host
  assemble (``assemble`` less the waits inside it), the time in wait spans
  and their syncs, by site, the count's round trip, and the counters;
- :func:`read_program_trace`: a profiled run's Chrome trace, in which each
  program span is a ``ta.<name>#<pass id>`` range: the device operations
  inside the benchmark's ``pass`` spans, and the device's idle time inside
  them by the innermost program span around it (``unspanned`` where none
  is).

:func:`metrics` and :func:`breakdown` reduce both to per-layer numbers:
``engine_self_ms``, ``assemble_self_ms``, ``sync_wait_ms``,
``count_wait_ms``, ``syncs_per_pass`` (medians over the passes) and
``device_ops_per_pass``, and the ``program_breakdown`` of a result line.
A program without these spans gives no summaries and an empty breakdown.

Run as a script, it makes one traced run of a cell through the harness
(``harness.run_cell``), reads the harness's profiled passes with
:func:`read_program_trace` before their trace is removed, and runs on the
same program, before the harness lets it go: the on-cost of the unfenced
collector (passes with it off and on in turns), three unfenced passes a
frame, and one pass a frame under ``torch.cuda.set_sync_debug_mode("warn")``
(``timing.sync_check``), whose synchronising calls are held against the
pass's wait spans::

    python perfbench/program_trace.py --workload meristem-512.resident --seed 7

It prints one JSON line, with the harness's own per-layer metrics and
breakdown of the same run under ``harness``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import time
from typing import Dict, Iterable, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import harness, judge, spec, trace  # noqa: E402

COUNT_SITE = "count.largest"
ROOTS = ("dispatch", "collect")
TOP_SPANS = 10


def pass_summaries(spans: Iterable, counts: Dict) -> List[dict]:
    """One summary a pass id of ``spans`` (``timing.Span``), in ms, in the
    order the passes opened; ``counts`` is the collector's ``counts``."""
    out: Dict[int, dict] = {}
    for s in spans:
        if s.pass_id is None:
            continue
        p = out.setdefault(s.pass_id, {
            "engine_self_ms": 0.0, "assemble_self_ms": None, "sync_wait_ms": 0.0,
            "count_wait_ms": None, "syncs": 0, "waits": {}, "counters": {}})
        ms = s.seconds * 1e3
        if s.name in ROOTS and s.parent is None:
            p["engine_self_ms"] += s.self_seconds * 1e3
        if s.name == "assemble":
            p["assemble_self_ms"] = (p["assemble_self_ms"] or 0.0) + ms
        if s.name == "finish" and "L" in s.attrs:
            p["counters"]["L"] = s.attrs["L"]
        if not s.wait:
            continue
        syncs = int(s.attrs.get("syncs", 1))
        p["sync_wait_ms"] += ms
        p["syncs"] += syncs
        site = p["waits"].setdefault(s.site, [0.0, 0])
        site[0] += ms
        site[1] += syncs
        if s.site == COUNT_SITE:
            p["count_wait_ms"] = (p["count_wait_ms"] or 0.0) + ms
        if s.inside("assemble"):
            p["assemble_self_ms"] -= ms
    for pid, p in out.items():
        p["counters"].update(counts.get(pid, {}))
    return list(out.values())


def _median(values) -> Optional[float]:
    got = [v for v in values if v is not None]
    return statistics.median(got) if got else None


def _intervals_union(iv: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def read_program_trace(path: str, prefix: str = "ta.") -> dict:
    """Device operations and idle time inside the ``pass`` spans of the
    Chrome trace at ``path``, the idle time by innermost program span.

    Returns ``passes``, ``device_ops_per_pass``, ``idle_ms`` (a pass),
    ``idle_by_span`` ({span name: ms a pass}, ``unspanned`` for idle time
    under no program span) and ``idle_unspanned_pct``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    passes, spans, device = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat, name = e.get("cat"), e.get("name", "")
        if cat in trace.DEVICE_CATEGORIES:
            device.append((a, b))
        elif cat == "user_annotation":
            if name == "pass":
                passes.append((a, b))
            elif name.startswith(prefix):
                spans.append((name[len(prefix):].split("#")[0], a, b))
    if not passes:
        raise ValueError(f"the trace {path} holds no 'pass' span")
    device.sort()
    spans.sort(key=lambda s: s[1])
    ops, idle = 0, {}
    for p0, p1 in passes:
        mine = [(a, b) for a, b in device if p0 <= a < p1]
        ops += len(mine)
        busy = _intervals_union((a, min(b, p1)) for a, b in mine)
        gaps = [(a, b) for a, b in zip([p0] + [b for _, b in busy], [a for a, _ in busy] + [p1])
                if b > a]
        around = [s for s in spans if s[1] < p1 and s[2] > p0]
        for g0, g1 in gaps:
            cuts = sorted({g0, g1, *(x for _, a, b in around for x in (a, b) if g0 < x < g1)})
            for a, b in zip(cuts, cuts[1:]):
                mid = (a + b) / 2
                inner = [(s1 - s0, n) for n, s0, s1 in around if s0 <= mid <= s1]
                name = min(inner)[1] if inner else "unspanned"
                idle[name] = idle.get(name, 0.0) + (b - a) * 1e-3
    n = len(passes)
    total = sum(idle.values())
    return {
        "passes": n,
        "device_ops_per_pass": ops / n,
        "idle_ms": total / n,
        "idle_by_span": {k: v / n for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
        "idle_unspanned_pct": 100.0 * idle.get("unspanned", 0.0) / total if total > 0 else 0.0,
    }


def metrics(passes: List[dict], traced: Optional[dict] = None) -> Dict[str, float]:
    """The per-layer numbers of the unfenced passes (medians) and of the
    profiled ones; a number with nothing to read is left out."""
    out = {}
    if passes:
        for name in ("engine_self_ms", "assemble_self_ms", "sync_wait_ms", "count_wait_ms"):
            v = _median(p[name] for p in passes)
            if v is not None:
                out[name] = v
        out["syncs_per_pass"] = statistics.median(p["syncs"] for p in passes)
    if traced is not None:
        out["device_ops_per_pass"] = traced["device_ops_per_pass"]
    return out


def breakdown(passes: List[dict], traced: Optional[dict] = None) -> dict:
    """``idle_by_span`` (the 10 program spans with most idle device time a
    profiled pass, ms), ``idle_unspanned_pct``, ``waits_by_site`` (median ms
    and syncs a pass) and ``counters`` (median a pass)."""
    sites = sorted({s for p in passes for s in p["waits"]})
    names = sorted({c for p in passes for c in p["counters"]})

    def site(s, i):
        return statistics.median(p["waits"].get(s, (0.0, 0))[i] for p in passes)

    out = {
        "waits_by_site": {s: {"ms": site(s, 0), "count": site(s, 1)} for s in sites},
        "counters": {c: statistics.median(p["counters"].get(c, 0) for p in passes) for c in names},
    }
    if traced is not None:
        spanned = [[k, v] for k, v in traced["idle_by_span"].items() if k != "unspanned"]
        out["idle_by_span"] = spanned[:TOP_SPANS]
        out["idle_unspanned_pct"] = traced["idle_unspanned_pct"]
    return out


# ------------------------------------------------------------------ script
class _Phases:
    """The cell's pass as the harness's window calls it (``run_cell``'s
    ``wrap``): it keeps each frame's first table and, before the harness
    lets the program go, runs the script's phases on it: the on-cost, the
    unfenced passes and the sync check."""

    def __init__(self, args, cuda: bool):
        self.args, self.cuda = args, cuda
        self.program, self.firsts, self.k = None, {}, 0
        self.cost = {"off": [], "on": []}
        self.passes, self.checks, self.wrong, self.traced = [], [], 0, None

    def wrap(self, program, raw, dev):
        self.program = program
        return self

    def __call__(self, k):
        table = self.program(k)
        self.firsts.setdefault(self.program.frame(k), table)
        self.k = k + 1
        return table

    def voxels(self, k):
        return self.program.voxels(k)

    def frame(self, k):
        return self.program.frame(k)

    def close(self):
        try:
            self._run()
        finally:
            self.program.close()

    def _pass(self, record):
        k, self.k = self.k, self.k + 1
        t0 = time.perf_counter()
        with record:
            table = self.program(k)
        seconds = time.perf_counter() - t0
        self.wrong += not judge.same_integers(table, self.firsts[self.program.frame(k)])
        return seconds, self.program.voxels(k)

    def _run(self):
        from tissue_analysis_tpu_torch.utils import timing

        # the on-cost: passes with the unfenced collector off and on in
        # turns (off, on, on, off, ...), each on the host clock
        with harness.pinned():
            for i in range(self.args.cost_passes):
                side = ("off", "on", "on", "off")[i % 4]
                self.cost[side].append(self._pass(
                    timing.collect(fence=False) if side == "on" else contextlib.nullcontext()))
        frames = len(self.firsts)
        for _ in range(self.args.passes * frames):
            with timing.collect(fence=False) as t:
                self._pass(contextlib.nullcontext())
            self.passes += pass_summaries(t.spans, t.counts)
        if self.cuda:
            for _ in range(frames):
                self.checks.append(timing.sync_check(lambda: self._pass(contextlib.nullcontext())))


def main(argv=None, root: str = ROOT) -> None:
    """The script; ``root`` is the checkout whose ``BENCHMARK.json`` names
    the cell."""
    t_start = time.perf_counter()
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0, help="the harness's window")
    ap.add_argument("--cost-passes", type=int, default=400,
                    help="passes with the unfenced collector off and on, in turns")
    ap.add_argument("--passes", type=int, default=3, help="unfenced passes a frame")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a rehearsal")
    args = ap.parse_args(argv)
    os.environ.setdefault("TA_NATIVE_CACHE", os.path.join(ROOT, "build", "native"))

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("perfbench: no CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device(args.device, 0) if args.device == "cuda" else torch.device(args.device)
    phases = _Phases(args, dev.type == "cuda")
    read_trace = trace.read_trace

    def reading(path, names):
        # the harness's profiled passes, read before their directory goes
        phases.traced = read_program_trace(path)
        return read_trace(path, names)

    trace.read_trace = reading
    try:
        line = harness.run_cell(spec.load_cell(args.workload, root), args.seed, args.seconds,
                                True, dev, t_start, wrap=phases.wrap)
    finally:
        trace.read_trace = read_trace
    traced, busy = phases.traced, line["device"].get("busy_s")
    rate = {side: sum(v for _, v in got) / sum(s for s, _ in got) / 1e6
            for side, got in phases.cost.items() if got}
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "device": line["device"]["kind"],
        "correct": line["correct"], "tables_differing": phases.wrong,
        "metrics": metrics(phases.passes, traced),
        "program_breakdown": breakdown(phases.passes, traced),
        "harness": {"metrics": {k: v["value"] for k, v in line["metrics"].items()},
                    "breakdown": line.get("breakdown")},
        "on_cost": {"passes": {side: len(got) for side, got in phases.cost.items()},
                    "off_mvox_s": rate.get("off"), "on_mvox_s": rate.get("on"),
                    "on_less_off_pct": 100.0 * (rate["on"] - rate["off"]) / rate["off"]
                    if len(rate) == 2 else None,
                    "median_pass_ms": {side: statistics.median(s for s, _ in got) * 1e3
                                       for side, got in phases.cost.items() if got}},
        "sync_check": phases.checks,
        "device_busy_ms_a_pass": busy / traced["passes"] * 1e3 if busy and traced else None,
        "device_idle_ms_a_pass": traced["idle_ms"] if traced else None,
        "passes": phases.passes,
    }), flush=True)


if __name__ == "__main__":
    main()
