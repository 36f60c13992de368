"""The port's tracing (``utils/timing.py``): the span tree of a pass, its
wait spans and counters, the three modes and the profiler's ranges.

CPU tests at small shapes, with no JAX. The test marked ``cuda`` holds the
wait spans of a pass against the synchronising calls that
``torch.cuda.set_sync_debug_mode`` reports; run it on a card with::

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""

import json
import math
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tissue_analysis_tpu_torch import engine, series, streaming  # noqa: E402
from tissue_analysis_tpu_torch.core.stack import LabeledStack  # noqa: E402
from tissue_analysis_tpu_torch.core.synthetic import voronoi_stack  # noqa: E402
from tissue_analysis_tpu_torch.ops import block_sweep as bs  # noqa: E402
from tissue_analysis_tpu_torch.ops import stencil  # noqa: E402
from tissue_analysis_tpu_torch.parallel.sharded import analyze_sharded, make_mesh  # noqa: E402
from tissue_analysis_tpu_torch.utils import timing  # noqa: E402

SHAPE = (16, 32, 256)  # two blocks along x, two along y, two along z


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these stacks are small, and the suite's workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def img():
    return np.asarray(voronoi_stack(SHAPE, 150, seed=3, sphere=False))


def _stack(img, device="cpu"):
    return LabeledStack.from_array(img, background=1, device=device)


def _dense_block_image(shape):
    """Background 1, and in the block at the origin 5,462 labels of 3 voxels
    each: past every dictionary in that block, inside the capacity by the
    mean."""
    out = np.ones(shape, np.int32)
    out[:8, :16, :128] = 2 + np.arange(8 * 16 * 128).reshape(8, 16, 128) // 3
    return out


def _children(t, span):
    return [s for s in t.spans if s.parent is span]


def _names(spans):
    return [s.name for s in spans]


def _syncs(t, pass_id):
    return sum(s.attrs["syncs"] for s in t.spans if s.wait and s.pass_id == pass_id)


# ------------------------------------------------------------ a pass's tree
@pytest.mark.parametrize("name", ["auto", "torch"])
def test_the_span_tree_of_a_pass(img, name):
    st = _stack(img)
    engine.analyze_stack(st, engine=name)  # converge the dictionary size first
    with timing.collect(fence=False) as t:
        engine.analyze_stack(st, engine=name)
        engine.analyze_stack(st, engine=name)
    roots = [s for s in t.spans if s.parent is None]
    assert _names(roots) == ["dispatch", "collect"] * 2
    assert roots[0].pass_id == roots[1].pass_id != roots[2].pass_id == roots[3].pass_id
    assert all(s.pass_id in (roots[0].pass_id, roots[2].pass_id) for s in t.spans)

    dispatch, collect = roots[:2]
    assert dispatch.attrs == {"engine": name}
    launched = _children(t, dispatch)
    if name == "auto":
        count, check, sweep = launched
        assert check.name == "memory_check"
        assert count.name == "count" and count.attrs["B"] == 8
        assert count.attrs["largest"] > 32  # the count, not the mean, set L
        (w,) = _children(t, count)
        assert w.site == "count.largest" and w.name == "wait"
    else:
        (sweep,) = launched
    assert sweep.name == "sweep" and sweep.attrs["B"] == 8 and sweep.attrs["L"] >= 64

    finish, assemble = _children(t, collect)
    assert (finish.name, assemble.name) == ("finish", "assemble")
    assert finish.attrs["L"] == sweep.attrs["L"]
    ovf, combine = _children(t, finish)
    assert ovf.site == "finish.ovf" and combine.name == "combine"
    assert [s.site for s in _children(t, combine)] == [
        "combine.nonzero", "combine.mask", "sum_by_key.unique"]
    (readback,) = [s for s in t.spans if s.name == "readback" and s.pass_id == collect.pass_id]
    assert readback.wait and readback.inside("assemble") and readback.attrs["syncs"] == 5
    assert readback.attrs["bytes"] > 0

    # one readback of the count under auto, one of ovf, four in the pair
    # reduce, five copies to the host
    assert _syncs(t, dispatch.pass_id) == (11 if name == "auto" else 10)
    assert t.counts[dispatch.pass_id] == {"sweeps": 1}
    for s in t.spans:
        assert s.end_ns >= s.start_ns and 0 <= s.self_seconds <= s.seconds
        kids = _children(t, s)
        assert sum(k.seconds for k in kids) <= s.seconds
        assert s.self_seconds == pytest.approx(
            s.seconds - sum(k.seconds for k in kids), abs=1e-9)


def test_dispatch_and_collect_apart_share_their_pass(img):
    """A series dispatches frame k+1 before it collects frame k, and a
    stream dispatches each slab before it collects the one before: the
    dispatch and the collect of one stack carry one id, and every stack its
    own."""
    frames = [img, img[:, :, ::-1].copy(), img[::-1].copy()]
    with timing.collect(fence=False) as t:
        series.analyze_series(frames, devices=["cpu"])
        streaming.analyze_streamed(img, slab_z=8, device="cpu")
    roots = [s for s in t.spans if s.name in ("dispatch", "collect")]
    assert _names(roots)[:5] == ["dispatch", "dispatch", "collect", "dispatch", "collect"]
    ids = [s.pass_id for s in roots]
    assert len(set(ids)) == 3 + 2
    for pid in set(ids):
        assert sorted(_names(s for s in roots if s.pass_id == pid)) == ["collect", "dispatch"]


def test_an_overflow_rerun_counts_two_sweeps(img, monkeypatch):
    st = _stack(img)
    m = int(bs.count_block_labels(st.dense, st.n_labels, bs.DEFAULT_BLOCK, 4096).largest)
    L = 1 << (math.ceil(math.log2(m)) - 1)  # L < m <= 2L: one rerun
    monkeypatch.setattr(engine, "_GOOD_L", {})
    with timing.collect(fence=False) as t:
        d = engine.dispatch_stack(st, "torch", L=L)
        engine.collect_stack(d)
    assert t.counts == {d.pass_id: {"sweeps": 2}}
    sweeps = [s for s in t.spans if s.name == "sweep"]
    assert [s.attrs["L"] for s in sweeps] == [L, 2 * L]
    assert _names(s.parent for s in sweeps) == ["dispatch", "finish"]
    (finish,) = [s for s in t.spans if s.name == "finish"]
    assert finish.attrs["L"] == 2 * L
    assert [s.site or s.name for s in _children(t, finish)] == [
        "finish.ovf", "sweep", "finish.ovf", "combine"]


def test_a_dense_block_reroutes_and_counts_its_chunks():
    """A dense block beside nine empty ones goes alone to the flat engine:
    one split of one block, no reroute and no chunk, the routing in a span
    of its own under the dispatch and the flat stages after the sweep's
    launch. Beside one empty block, in chunks of 1,000 voxels, no split
    pays (routing the block takes more bytes than the flat engine over the
    stack): the count reroutes the whole stack, and the flat engine counts
    its chunks."""
    st = _stack(_dense_block_image((8, 16, 1280)))
    with timing.collect(fence=False) as t:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            d = engine.dispatch_stack(st, "auto")
            engine.collect_stack(d)
    assert t.counts[d.pass_id] == {"splits": 1, "split.blocks": 1, "sweeps": 1}
    dispatch = t.spans[0]
    assert _names(_children(t, dispatch)) == ["count", "route", "sweep", "flat.moments",
                                              "flat.pairs"]
    (route,) = [s for s in t.spans if s.name == "route"]
    assert (route.attrs["L"], route.attrs["k"]) == (32, 1)
    assert [s.site or s.name for s in _children(t, route)] == [
        "route.counts", "memory_check", "route.blocks"]
    (finish,) = [s for s in t.spans if s.name == "finish"]
    assert [s.site or s.name for s in _children(t, finish)] == ["finish.ovf", "combine"]
    # the count's largest, the counts, the routed blocks' copy, ovf, four
    # in the pair reduce, five copies to the host
    assert _syncs(t, d.pass_id) == 13

    img = _dense_block_image((8, 16, 256))
    st = _stack(img)
    chunk = 1000
    with timing.collect(fence=False) as t:
        with pytest.warns(UserWarning, match="flat engine"):
            d = engine.dispatch_stack(st, "auto", chunk=chunk)
        engine.collect_stack(d)
    assert t.counts[d.pass_id] == {"reroutes": 1, "flat.chunks": math.ceil(img.size / chunk)}
    dispatch = t.spans[0]
    assert _names(_children(t, dispatch)) == ["count", "route", "flat.moments", "flat.pairs"]
    (route,) = [s for s in t.spans if s.name == "route"]
    assert [s.site or s.name for s in _children(t, route)] == ["route.counts"]


def test_a_pass_with_no_block_past_its_count_is_as_it_was(img):
    """Where the count finds an L for every block, the pass reads no count
    of a block and routes nothing: its 11 syncs at the same six sites, and
    one sweep its only counter."""
    st = _stack(img)
    engine.analyze_stack(st)
    with timing.collect(fence=False) as t:
        d = engine.dispatch_stack(st)
        engine.collect_stack(d)
    assert [(s.site, s.attrs["syncs"]) for s in t.spans if s.wait] == [
        ("count.largest", 1), ("finish.ovf", 1), ("combine.nonzero", 1), ("combine.mask", 2),
        ("sum_by_key.unique", 1), ("assemble.readback", 5)]
    assert not {"route", "flat.moments", "flat.pairs"} & set(_names(t.spans))
    assert t.counts == {d.pass_id: {"sweeps": 1}}


def test_a_sharded_stack_rerouted_after_its_count_stays_one_pass():
    """The count of a slab says no block sweep can take it: the flat
    engine's spans and the count's belong to the one pass of the stack."""
    st = _stack(_dense_block_image((16, 16, 256)))
    chunk = 1000
    with timing.collect(fence=False) as t:
        with pytest.warns(UserWarning, match="flat engine"):
            analyze_sharded(st, make_mesh(2, device="cpu"), chunk=chunk)
    roots = [s for s in t.spans if s.parent is None]
    assert _names(roots) == ["dispatch", "dispatch", "collect"]
    (pid,) = {s.pass_id for s in t.spans}
    assert t.counts == {pid: {"reroutes": 1, "flat.chunks": 2 * math.ceil(8 * 16 * 256 / chunk)}}
    # the first slab's count reroutes the stack; each slab is swept flat
    assert [s.name for s in t.spans if s.name in ("count", "flat.moments")] == [
        "count", "flat.moments", "flat.moments"]


def test_a_flat_pass_records_its_waits(img):
    st = _stack(img)
    chunk = 3000
    with timing.collect(fence=False) as t:
        engine.analyze_stack(st, engine="chunked", chunk=chunk)
    chunks = math.ceil(img.size / chunk)
    rows = max(1, chunk // (SHAPE[1] * SHAPE[2]))
    slabs = math.ceil(SHAPE[0] / rows)
    waits = [s for s in t.spans if s.wait]
    sites = [s.site for s in waits]
    assert (sites.count("segred.run_start") == sites.count("segred.nonzero")
            == sites.count("segred.run_end") == chunks)
    assert sites.count("stencil.mask") == 3 * slabs
    assert sites.count("stencil.unique") >= slabs and sites.count("sum_by_key.unique") == 1
    for w in waits:
        assert w.inside("flat.moments") or w.inside("flat.pairs") or w.name == "readback"
    assert t.counts[waits[0].pass_id] == {"flat.chunks": chunks}


# --------------------------------------------------------------- the modes
def test_off_records_nothing_and_opens_no_range(img, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was opened with tracing off")

    class Clock:
        strftime = staticmethod(__import__("time").strftime)

        @staticmethod
        def perf_counter_ns():
            raise AssertionError("the clock was read with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(timing, "time", Clock)
    monkeypatch.delenv("TA_STAGE_VERBOSE", raising=False)
    st = _stack(img)
    for name in ("auto", "torch", "chunked"):
        engine.analyze_stack(st, engine=name)
    timing.count("sweeps")
    with timing.span("x") as a, timing.wait("y") as b:
        a.set(L=1)
    assert a is b  # one shared object: nothing is made


def test_fenced_collect_keeps_its_stages(img):
    st = _stack(img)
    engine.analyze_stack(st)
    with timing.collect() as t:
        engine.analyze_stack(st)
        engine.analyze_stack(st, engine="chunked")
    assert [s.name for s in t.stages] == [
        "device count (block labels)", "device sweep (block)", "combine + pair reduce",
        "readback + host assemble", "device sweep (flat moments)", "device sweep (flat pairs)",
        "readback + host assemble"]
    assert t.stages[0].voxels == img.size
    assert t.spans == [] and t.counts == {}
    # unfenced, the stages are there too, beside the spans
    with timing.collect(fence=False) as u:
        engine.analyze_stack(st)
    assert [s.name for s in u.stages] == [s.name for s in t.stages[:4]]


def test_a_stage_fences_where_it_did(monkeypatch, capsys):
    """Under ``collect()`` and, uncollected, under ``TA_STAGE_VERBOSE`` (the
    hang diagnosis) a stage fences on entry and exit; under
    ``collect(fence=False)`` it never does."""
    fenced = []
    monkeypatch.setattr(timing, "_fence", fenced.append)
    with timing.collect():
        with timing.stage("a", None, "dev"):
            pass
    monkeypatch.setenv("TA_STAGE_VERBOSE", "1")
    with timing.stage("b", None, "dev"):
        pass
    with timing.collect(fence=False) as t:
        with timing.stage("c", None, "dev"):
            pass
    assert fenced == ["dev"] * 4 and [s.name for s in t.stages] == ["c"]
    assert "stage: b" in capsys.readouterr().out


def test_profile_trace_holds_the_program_spans(img, tmp_path):
    st = _stack(img)
    with timing.profile_trace(str(tmp_path)) as prof:
        with torch.profiler.record_function("pass"):
            engine.analyze_stack(st)
    with open(prof.trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    (outer,) = [e for e in events if e["name"] == "pass"]
    ours = [e for e in events if e["name"].startswith(timing.PREFIX)]
    names = {e["name"].split("#")[0] for e in ours}
    assert {"ta.dispatch", "ta.count", "ta.sweep", "ta.collect", "ta.finish", "ta.combine",
            "ta.assemble", "ta.readback:assemble.readback", "ta.wait:count.largest",
            "ta.wait:finish.ovf", "ta.wait:combine.nonzero"} <= names
    assert len({e["name"].split("#")[1] for e in ours if "#" in e["name"]}) == 1
    t0, t1 = outer["ts"], outer["ts"] + outer["dur"]
    assert all(t0 <= e["ts"] and e["ts"] + e["dur"] <= t1 for e in ours)
    waits = [e for e in ours if e["name"].startswith(("ta.wait:", "ta.readback:"))]
    assert len(waits) == 5 + 1  # one range holds both masks, one the five copies
    assert timing._on == 0 and timing._profiling == 0


def test_device_times_leave_ranges_out():
    """The profiler keeps a range that encloses device work as a device row
    too; it is no entry of its own."""
    from torch.autograd import DeviceType

    class Row:
        def __init__(self, key, device, us, annotation):
            self.key, self.device_type, self.count = key, device, 1
            self.self_device_time_total, self.is_user_annotation = us, annotation

    class Prof:
        @staticmethod
        def key_averages():
            return [
                Row("block_sweep_kernel", DeviceType.CUDA, 5.0, False),
                Row("Memcpy DtoH", DeviceType.CUDA, 1.0, False),
                Row("ta.sweep#3", DeviceType.CUDA, 5.0, True),
                Row("pass", DeviceType.CUDA, 6.0, True),
                Row("aten::nonzero", DeviceType.CPU, 2.0, False),
                Row("ta.sweep#3", DeviceType.CPU, 5.0, True),
                Row("pass", DeviceType.CPU, 1.0, True),
            ]

    assert timing.device_times(Prof()) == [
        ("block_sweep_kernel", 1, 5.0), ("Memcpy DtoH", 1, 1.0)]
    assert timing.device_times(Prof(), by_op=True) == [("aten::nonzero", 1, 2.0)]


def test_sync_check_finds_a_sync_outside_every_wait(monkeypatch):
    """Its reading of the sync debug mode's warnings, without a card: the
    mode is stood in for by the warnings it would give."""
    modes = []
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)

    def run():
        with timing.span("pass", pass_id=timing.new_pass()):
            with timing.wait("here", syncs=2):
                warnings.warn("called a synchronizing CUDA operation")
                warnings.warn("called a synchronizing CUDA operation")
            warnings.warn("called a synchronizing CUDA operation")
            warnings.warn("something else")

    got = timing.sync_check(run)
    assert modes == ["warn", 0]
    assert (got["warnings"], got["wait_syncs"], len(got["outside_waits"])) == (3, 2, 1)
    assert "test_torch_tracing.py" in got["outside_waits"][0]
    assert timing._on == 0


def test_pair_sweep_waits_are_the_same_with_a_stream_of_one_chunk(img):
    """An empty key stream still makes its one (empty) reduction."""
    dense = torch.ones((2, 3, 4), dtype=torch.int32)
    with timing.collect(fence=False) as t:
        with timing.span("pass", pass_id=timing.new_pass()):
            key, total = stencil.pair_sweep(dense, 2, 1 << 20)
    assert key.numel() == 0
    assert [s.site for s in t.spans if s.wait] == ["stencil.mask"] * 3 + ["stencil.unique"]


# ------------------------------------------------------------------ the card
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
def test_every_sync_of_a_pass_is_in_a_wait_span(card, dense):
    """The kernel's pass; with a dense block, the pass that routes that
    block to the flat engine under ``auto`` and the flat engine's over the
    whole stack (``chunked``, in four chunks)."""
    img = (_dense_block_image((16, 32, 512)) if dense
           else np.asarray(voronoi_stack((64, 64, 256), 300, seed=5, sphere=False)))
    st = _stack(img, card)
    for name, chunk in (("auto", None), ("chunked", 1 << 16)) if dense else (("auto", None),):
        engine.analyze_stack(st, name, chunk=chunk)  # build and converge first
        torch.cuda.synchronize()
        got = timing.sync_check(lambda: engine.analyze_stack(st, name, chunk=chunk))
        assert got["outside_waits"] == [] and got["warnings"] == got["wait_syncs"] > 0


@pytest.mark.cuda
def test_device_times_hold_no_range_on_the_card(card, tmp_path):
    """Under a profile every span is a range around device work: none is
    counted as a device entry or an operator."""
    st = _stack(np.asarray(voronoi_stack((64, 64, 256), 300, seed=5, sphere=False)), card)
    engine.analyze_stack(st)
    with timing.profile_trace(str(tmp_path)) as prof:
        with torch.profiler.record_function("pass"):
            engine.analyze_stack(st)
    rows = timing.device_times(prof)
    ops = timing.device_times(prof, by_op=True)
    assert any("block_sweep_kernel" in k for k, _, _ in rows)
    assert not [k for k, _, _ in rows + ops if k.startswith(timing.PREFIX) or k == "pass"]
