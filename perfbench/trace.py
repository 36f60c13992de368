"""Device time and idle gaps from a ``torch.profiler`` Chrome trace.

The traced passes run under the program's ``utils.timing.profile_trace``,
which writes a Chrome trace. Here it is reduced to:

- the device time of each device operation (kernel, copy, fill) by name,
  summed over the traced passes;
- the window: from the start of the first ``pass`` span to the end of the
  last, on the trace's clock;
- ``busy_s``: the time in that window in which some operation ran on the
  device (the union of their intervals);
- the idle gaps in that window, longest first, each named by the innermost
  host span of the benchmark around its midpoint (``host`` where none is).

The profiler slows the host, so the gaps of a traced window are longer than
those of an untraced one: they say where the host holds the device back,
not by how much.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Tuple

__all__ = ["TraceSummary", "read_trace"]

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class TraceSummary:
    ops: Dict[str, float]  # device seconds by operation name
    busy_s: float
    window_s: float
    gaps: List[Tuple[str, float]]  # (host span, seconds), longest first

    @property
    def device_s(self) -> float:
        return sum(self.ops.values())

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the operations whose name holds ``pattern``."""
        return sum(s for name, s in self.ops.items() if pattern in name)


def _union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def read_trace(path: str, span_names: Iterable[str]) -> TraceSummary:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = set(span_names)
    spans, device = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") in DEVICE_CATEGORIES:
            device.append((e["name"], a, b))
        elif e.get("cat") == "user_annotation" and e.get("name") in names:
            spans.append((e["name"], a, b))
    passes = [(a, b) for n, a, b in spans if n == "pass"]
    if not passes:
        raise ValueError(f"the trace {path} holds no 'pass' span")
    w0, w1 = min(a for a, _ in passes), max(b for _, b in passes)
    ops: Dict[str, float] = {}
    clipped = []
    for name, a, b in device:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            ops[name] = ops.get(name, 0.0) + (b - a) * 1e-6
            clipped.append((a, b))
    busy = _union(clipped)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            around = [(s1 - s0, n) for n, s0, s1 in spans if s0 <= mid <= s1]
            gaps.append((min(around)[1] if around else "host", (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return TraceSummary(
        ops=dict(sorted(ops.items(), key=lambda kv: -kv[1])),
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        window_s=(w1 - w0) * 1e-6,
        gaps=gaps,
    )
