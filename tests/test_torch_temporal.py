"""Port's ``graph/temporal.py`` vs the JAX package's, on the same lineages.

Each package builds its own TemporalPropertyGraph from its own per-frame
graphs of the JAX tests' fixtures (``test_temporal.py``: two frames where a
cell divides, three frames with two divisions); every temporal function must
give equal outputs in both (exact: the same host arithmetic on equal
property values and equal vertex ids).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_temporal import _three_frame_images, _timepoint_images  # noqa: E402
from test_torch_graph import _same, assert_graphs_equal  # noqa: E402

import tissue_analysis_tpu as J  # noqa: E402
import tissue_analysis_tpu.graph.temporal as jt  # noqa: E402
import tissue_analysis_tpu_torch as P  # noqa: E402
import tissue_analysis_tpu_torch.graph.temporal as pt  # noqa: E402

LINEAGES = {
    "two-frames": [{2: [2], 3: [3, 4]}],
    "three-frames": [{2: [2], 3: [3, 4]}, {2: [2], 3: [3], 4: [4, 5]}],
}
FRAMES = {"two-frames": _timepoint_images, "three-frames": _three_frame_images}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these stacks are small, and the suite's workers
    share the cores (several threads each oversubscribe them badly)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tpg(pkg, name):
    # the port's entry points default to the card: run them on the CPU here
    kw = {"device": "cpu"} if pkg is P else {}
    graphs = [pkg.graph_from_image(f, background=1, **kw) for f in FRAMES[name]()]
    return pkg.TemporalPropertyGraph().extend(graphs, LINEAGES[name])


@pytest.fixture(scope="module", params=list(FRAMES))
def pair(request):
    return _tpg(J, request.param), _tpg(P, request.param)


def _all(g):
    return list(g.vertices())


def _times(g):
    return range(g.graph_property("nb_time_points"))


RANKS = (-2, -1, 0, 1, 2)

# function name -> f(module, graph) giving that function's outputs over a
# sweep of its arguments
CASES = {
    "exist_relative_at_rank": lambda m, g: [
        m.exist_relative_at_rank(g, v, r) for v in _all(g) for r in RANKS
    ],
    "exist_all_relative_at_rank": lambda m, g: [
        m.exist_all_relative_at_rank(g, g.vertex_at_time(t), r)
        for t in _times(g) for r in RANKS
    ],
    "temporal_change": lambda m, g: [
        m.temporal_change(g, "volume", rank=r) for r in RANKS
    ] + [m.temporal_change(g, "volume", g.vertex_at_time(0), rank=1)],
    "relative_temporal_change": lambda m, g: [
        m.relative_temporal_change(g, "volume", rank=r) for r in RANKS
    ],
    "temporal_rate": lambda m, g: [
        m.temporal_rate(g, "volume", rank=r, delta_t=dt)
        for r in (-1, 1, 2) for dt in (1.0, 2.0)
    ],
    "lineage_volumes": lambda m, g: [m.lineage_volumes(g, v) for v in _all(g)],
    "lineage_vertices": lambda m, g: [m.lineage_vertices(g, v) for v in _all(g)],
    "per_lineage_aggregate": lambda m, g: [
        m.per_lineage_aggregate(g, "volume", np.sum),
        m.per_lineage_aggregate(g, "volume", np.max, roots=g.vertex_at_time(1)),
        m.per_lineage_aggregate(g, "epidermis_surface", np.mean),
    ],
    "dividing_cells": lambda m, g: [m.dividing_cells(g)] + [
        m.dividing_cells(g, t) for t in _times(g)
    ],
    "division_events": lambda m, g: [m.division_events(g)] + [
        m.division_events(g, t) for t in _times(g)
    ],
    "nb_descendants": lambda m, g: [
        m.nb_descendants(g, rank=r) for r in (1, 2)
    ] + [m.nb_descendants(g, g.vertex_at_time(0), rank=1)],
    "division_rate": lambda m, g: [m.division_rate(g, t) for t in _times(g)],
    "division_asymmetry": lambda m, g: [
        m.division_asymmetry(g, v) for v in _all(g)
    ] + [m.division_asymmetry(g, v, "epidermis_surface") for v in _all(g)],
    "time_point_property": lambda m, g: [
        m.time_point_property(g, "volume", t) for t in _times(g)
    ],
    "sibling_cells": lambda m, g: [m.sibling_cells(g, v) for v in _all(g)],
}


def test_every_function_is_covered():
    assert sorted(CASES) == sorted(jt.__all__) == sorted(pt.__all__)


@pytest.mark.parametrize("name", sorted(CASES))
def test_temporal_function_equals_reference(pair, name):
    ref, port = pair
    a, b = CASES[name](jt, ref), CASES[name](pt, port)
    assert _same(a, b), (name, a, b)


def test_temporal_graphs_equal(pair):
    ref, port = pair
    assert_graphs_equal(ref, port)
    for t in _times(ref):
        assert ref.vertex_at_time(t) == port.vertex_at_time(t)


def test_package_exports_temporal_functions():
    for name in jt.__all__:
        assert getattr(P, name) is getattr(pt, name)
        assert getattr(P.graph, name) is getattr(pt, name)
