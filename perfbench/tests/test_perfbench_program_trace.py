"""The reading of the program's own spans (``perfbench/program_trace.py``):
per-pass summaries of hand-made spans, a hand-made Chrome trace, the
numbers and the breakdown made of them, and a traced CPU run whose
existing metrics and breakdown keep their names beside the program's
ranges.

CPU tests at tiny shapes. Run with ``python -m pytest perfbench/tests``.
"""

import json
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from perfbench import harness, program_trace, spec  # noqa: E402
from test_perfbench_harness import _throwaway_root  # noqa: E402
from tissue_analysis_tpu_torch.utils import timing  # noqa: E402


def _Span(name, parent, pass_id, ms, self_ms=None, site=None, **attrs):
    """A span as the program's collector keeps it, ``ms`` long."""
    s = timing.Span(name, pass_id, site, dict(attrs, syncs=attrs.get("syncs", 1)) if site else attrs)
    s.parent = parent
    s.end_ns = round(ms * 1e6)
    s.child_ns = round((ms - (ms if self_ms is None else self_ms)) * 1e6)
    return s


def _pass(pid, count_ms=0.2, readback_ms=1.0):
    d = _Span("dispatch", None, pid, 3.0, self_ms=0.5)
    c = _Span("count", d, pid, 0.6)
    w = _Span("wait", c, pid, count_ms, site="count.largest")
    s = _Span("sweep", d, pid, 1.9, L=32, B=8192)
    col = _Span("collect", None, pid, 4.0, self_ms=0.25)
    f = _Span("finish", col, pid, 1.5, L=32)
    o = _Span("wait", f, pid, 1.2, site="finish.ovf")
    a = _Span("assemble", col, pid, 2.25)
    st = _Span("readback + host assemble", a, pid, 2.0)
    r = _Span("readback", st, pid, readback_ms, site="assemble.readback", syncs=5, bytes=100)
    return [d, c, w, s, col, f, o, a, st, r]


def test_pass_summaries_read_self_times_waits_and_counters():
    spans = _pass(1) + _pass(2, count_ms=0.4, readback_ms=0.5) + [_Span("stray", None, None, 9.0)]
    got = program_trace.pass_summaries(spans, {1: {"sweeps": 1}, 2: {"sweeps": 1}, None: {"x": 3}})
    assert len(got) == 2
    p = got[0]
    assert p["engine_self_ms"] == pytest.approx(0.75)
    assert p["assemble_self_ms"] == pytest.approx(1.25)  # 2.25 less the 1.0 readback
    assert p["sync_wait_ms"] == pytest.approx(0.2 + 1.2 + 1.0)
    assert p["count_wait_ms"] == pytest.approx(0.2) and p["syncs"] == 7
    assert p["waits"]["assemble.readback"] == [pytest.approx(1.0), 5]
    assert p["counters"] == {"L": 32, "sweeps": 1}
    assert got[1]["assemble_self_ms"] == pytest.approx(1.75)

    m = program_trace.metrics(got)
    assert m["syncs_per_pass"] == 7 and m["count_wait_ms"] == pytest.approx(0.3)
    assert "device_ops_per_pass" not in m
    b = program_trace.breakdown(got)
    assert b["waits_by_site"]["count.largest"] == {"ms": pytest.approx(0.3), "count": 1}
    assert b["counters"] == {"L": 32, "sweeps": 1} and "idle_by_span" not in b


def test_a_pass_without_a_count_reads_no_count_wait():
    spans = [s for s in _pass(1) if s.name not in ("count",) and s.site != "count.largest"]
    got = program_trace.pass_summaries(spans, {})
    assert got[0]["count_wait_ms"] is None
    assert "count_wait_ms" not in program_trace.metrics(got)
    assert program_trace.metrics([]) == {} and program_trace.pass_summaries([], {}) == []


def test_read_program_trace_counts_ops_and_names_idle_time(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "pass", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "count", "ts": 5, "dur": 20},
        {"ph": "X", "cat": "user_annotation", "name": "ta.dispatch#4", "ts": 2, "dur": 48},
        {"ph": "X", "cat": "user_annotation", "name": "ta.wait:count.largest#4", "ts": 10,
         "dur": 30},
        {"ph": "X", "cat": "user_annotation", "name": "ta.collect#4", "ts": 60, "dur": 38},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 20, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 70, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 150, "dur": 5},
        {"ph": "X", "cat": "user_annotation", "name": "pass", "ts": 200, "dur": 10},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    got = program_trace.read_program_trace(str(p))
    assert got["passes"] == 2 and got["device_ops_per_pass"] == 1.0
    # first pass: idle 0-20 and 30-70 and 75-100; second: 10
    idle = got["idle_by_span"]
    assert idle["dispatch"] == pytest.approx((8 + 10) * 1e-3 / 2)  # 2-10 and 40-50
    assert idle["wait:count.largest"] == pytest.approx((10 + 10) * 1e-3 / 2)  # 10-20, 30-40
    assert idle["collect"] == pytest.approx((10 + 23) * 1e-3 / 2)  # 60-70, 75-98
    assert idle["unspanned"] == pytest.approx((2 + 10 + 2 + 10) * 1e-3 / 2)
    assert got["idle_ms"] == pytest.approx((20 + 40 + 25 + 10) * 1e-3 / 2)
    assert got["idle_unspanned_pct"] == pytest.approx(100 * 24 / 95)
    b = program_trace.breakdown([], got)
    assert [n for n, _ in b["idle_by_span"]] == ["collect", "wait:count.largest", "dispatch"]
    assert program_trace.metrics([], got) == {"device_ops_per_pass": 1.0}


def test_a_trace_without_a_pass_raises(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": []}))
    with pytest.raises(ValueError, match="no 'pass' span"):
        program_trace.read_program_trace(str(p))


def test_a_traced_cpu_run_keeps_its_metrics_and_breakdown(tmp_path):
    root = _throwaway_root(str(tmp_path), shape=[32, 48, 128], ncells=300)
    cell = spec.load_cell("tiny.mix", root)
    res = harness.run_cell(cell, 2**31 + 5, 0.3, True, "cpu", time.perf_counter())
    assert res["correct"]
    assert {"combine_ms", "assemble_ms", "engine_host_ms", "pass_p95_ms"} <= set(res["metrics"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {name for name, _ in res["breakdown"]["idle_gaps"]} <= {
        "pass", "count", "sweep", "flat", "finish", "assemble", "host"}


def test_the_script_rehearses_on_the_cpu(tmp_path, capsys):
    root = _throwaway_root(str(tmp_path), shape=[32, 48, 128], ncells=300)
    program_trace.main(["--workload", "tiny.mix", "--seed", str(2**31 + 9), "--device", "cpu",
                        "--seconds", "0.3", "--cost-passes", "8", "--passes", "1"], root=root)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["correct"] and out["tables_differing"] == 0
    assert set(out["metrics"]) == {"engine_self_ms", "assemble_self_ms", "sync_wait_ms",
                                   "count_wait_ms", "syncs_per_pass", "device_ops_per_pass"}
    assert out["metrics"]["syncs_per_pass"] == 11
    assert {"idle_by_span", "idle_unspanned_pct", "waits_by_site", "counters"} == set(
        out["program_breakdown"])
    # the harness's own per-layer metrics of the same run
    assert {"combine_ms", "assemble_ms", "engine_host_ms", "pass_p95_ms"} <= set(
        out["harness"]["metrics"])
    assert set(out["harness"]["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["on_cost"]["passes"] == {"off": 4, "on": 4}
    assert out["on_cost"]["on_mvox_s"] > 0 and out["on_cost"]["on_less_off_pct"] is not None
    assert out["sync_check"] == []  # no card, no sync check
    assert program_trace.trace.read_trace.__module__ == "perfbench.trace"  # given back
