"""Port's ``series.py`` and ``n_bucket`` vs the JAX package's, on the CPU.

The same frames (the JAX test's three anisotropic 24³ Voronoi frames) go
through ``tissue_analysis_tpu.series`` and ``tissue_analysis_tpu_torch.series``;
tables, per-frame graphs and the lineage-linked temporal graph must be equal
field by field (exact).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import assert_tables_equal  # noqa: E402
from test_torch_graph import assert_graphs_equal  # noqa: E402

from tissue_analysis_tpu import series as jseries  # noqa: E402
from tissue_analysis_tpu.core.stack import LabeledStack as JaxStack  # noqa: E402
from tissue_analysis_tpu.core.synthetic import voronoi_stack  # noqa: E402
from tissue_analysis_tpu.engine import analyze_stack_blocked  # noqa: E402
from tissue_analysis_tpu_torch import engine  # noqa: E402
from tissue_analysis_tpu_torch import series  # noqa: E402
from tissue_analysis_tpu_torch.core.stack import LabeledStack  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these stacks are small, and the suite's workers
    share the cores (several threads each oversubscribe them badly)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    return [
        voronoi_stack((24, 24, 24), nc, seed=s, voxelsize=(1.5, 0.5, 0.5))
        for nc, s in [(12, 0), (20, 1), (30, 2)]
    ]


@pytest.fixture(scope="module")
def lineages(frames):
    """Every label that is present in consecutive frames maps to itself,
    and label 3 also to label 4 (a division)."""
    out = []
    for a, b in zip(frames, frames[1:]):
        common = sorted(set(np.unique(a).tolist()) & set(np.unique(b).tolist()) - {1})
        m = {int(l): [int(l)] for l in common}
        if 3 in m and 4 in np.unique(b):
            m[3] = [3, 4]
        out.append(m)
    return out


def test_analyze_series_equals_reference(frames):
    ref = jseries.analyze_series(frames, background=1)
    got = series.analyze_series(frames, background=1, devices=["cpu"])
    assert len(got) == 3
    for r, g in zip(ref, got):
        assert_tables_equal(r, g)


def test_analyze_series_equals_analyze_stack_per_frame(frames):
    for img, t in zip(frames, series.analyze_series(frames, background=1, devices=["cpu"])):
        ref = engine.analyze_stack(LabeledStack.from_array(img, background=1, device="cpu"))
        assert_tables_equal(ref, t)


@pytest.mark.parametrize("n_bucket", [64, 256, 1000])
def test_bucketed_equals_exact_n(frames, n_bucket):
    img = frames[1]
    stack = LabeledStack.from_array(img, background=1, device="cpu")
    exact = engine.analyze_stack(stack)
    bucketed = engine.analyze_stack(stack, n_bucket=n_bucket)
    assert_tables_equal(exact, bucketed)
    ref = analyze_stack_blocked(JaxStack.from_array(img, background=1), n_bucket=n_bucket)
    assert_tables_equal(ref, bucketed)


def test_bucketed_2d_equals_exact_n():
    img = voronoi_stack((48, 40), 20, seed=1, voxelsize=(0.75, 1.25))
    stack = LabeledStack.from_array(img, background=1, device="cpu")
    assert_tables_equal(engine.analyze_stack(stack), engine.analyze_stack(stack, n_bucket=128))


def test_graph_series_equals_reference(frames):
    ref = jseries.graph_series(frames, background=1)
    got = series.graph_series(frames, background=1, devices=["cpu"])
    assert len(got) == len(ref) == 3
    for r, g in zip(ref, got):
        assert g.nb_vertices() > 0 and "volume" in g.vertex_property_names()
        assert_graphs_equal(r, g)


def test_graph_series_kwargs_equal_reference(frames):
    kw = dict(default_real_property=False, remove_stack_margins_cells=True)
    for r, g in zip(jseries.graph_series(frames, background=1, **kw),
                    series.graph_series(frames, background=1, **kw, devices=["cpu"])):
        assert_graphs_equal(r, g)


def test_temporal_graph_from_images_equals_reference(frames, lineages):
    ref = jseries.temporal_graph_from_images(frames, lineages, background=1)
    got = series.temporal_graph_from_images(frames, lineages, background=1, devices=["cpu"])
    assert got.graph_property("nb_time_points") == 3
    assert_graphs_equal(ref, got)
    et = got.edge_property("edge_type")
    n_temp = sum(1 for e in got.edges() if et[e] == "t")
    assert n_temp == sum(len(d) for m in lineages for d in m.values())
    for t in range(3):
        assert ref.vertex_at_time(t) == got.vertex_at_time(t)
        assert [ref.children(v) for v in ref.vertex_at_time(t)] == [
            got.children(v) for v in got.vertex_at_time(t)
        ]


def test_lineage_files_round_trip(tmp_path, lineages):
    lin = dict(lineages[0])
    lin[99] = 7  # a bare daughter, as the writer accepts
    want = {k: (v if isinstance(v, list) else [v]) for k, v in lin.items()}
    p_port, p_ref = str(tmp_path / "port.txt"), str(tmp_path / "ref.txt")
    series.write_lineage(p_port, lin)
    jseries.write_lineage(p_ref, lin)
    assert open(p_port).read() == open(p_ref).read()
    assert series.read_lineage(p_port) == want == jseries.read_lineage(p_port)
    assert series.read_lineage(p_ref) == want
    odd = tmp_path / "odd.txt"
    odd.write_text("# header\n5 6 7\n8: 9  # trailing\n\n5: 10\n11\n")
    assert series.read_lineage(str(odd)) == jseries.read_lineage(str(odd)) == {
        5: [6, 7, 10], 8: [9],
    }


def test_devices_round_robin(frames, monkeypatch):
    seen = []
    dispatch = series.dispatch_stack

    def record(stack, **kw):
        seen.append((stack.device, kw.get("n_bucket")))
        return dispatch(stack, **kw)

    monkeypatch.setattr(series, "dispatch_stack", record)
    cpu = torch.device("cpu")
    got = series.analyze_series(frames, background=1, devices=[cpu, "cpu"])
    assert [d for d, _ in seen] == [cpu] * 3
    # frames of one shape share the largest bucket seen so far
    assert [b for _, b in seen] == [64, 64, 64]
    for r, g in zip(series.analyze_series(frames, background=1, devices=["cpu"]), got):
        assert_tables_equal(r, g)


@pytest.mark.parametrize("n_devices, order", [
    (1, ["d0", "d1", "c0", "d2", "c1", "d3", "c2", "d4", "c3", "c4"]),
    (2, ["d0", "d1", "d2", "c0", "d3", "c1", "d4", "c2", "c3", "c4"]),
])
def test_frames_in_flight_are_bounded(frames, monkeypatch, n_devices, order):
    """A frame is collected once len(devices) later frames are dispatched,
    so at most len(devices) + 1 frames hold device memory, for a series
    longer than that window."""
    events = []
    dispatch, collect = series.dispatch_stack, series.collect_stack

    def record_dispatch(stack, **kw):
        h = dispatch(stack, **kw)
        events.append(("d", h))
        return h

    def record_collect(h):
        events.append(("c", h))
        return collect(h)

    monkeypatch.setattr(series, "dispatch_stack", record_dispatch)
    monkeypatch.setattr(series, "collect_stack", record_collect)
    five = frames + frames[:2]
    got = series.analyze_series(five, background=1, devices=["cpu"] * n_devices)
    index = {id(h): i for i, (k, h) in enumerate(e for e in events if e[0] == "d")}
    assert [f"{k}{index[id(h)]}" for k, h in events] == order
    for img, t in zip(five, got):
        ref = engine.analyze_stack(LabeledStack.from_array(img, background=1, device="cpu"))
        assert_tables_equal(ref, t)


def test_failing_frame_raises(frames):
    with pytest.raises(ValueError, match="ndim"):
        series.analyze_series(
            [frames[0], np.ones((2, 2, 2, 2), np.uint8)], background=1, devices=["cpu"]
        )
