"""Port's property-graph export vs the JAX package's, on the same stack.

Both graphs are built from each package's own FeatureTable of ``small3d``;
vertex, edge and graph property dicts must be equal (exact: the float
features run the same host finalization on equal integer moments).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tissue_analysis_tpu.core.stack import LabeledStack as JaxStack  # noqa: E402
from tissue_analysis_tpu.engine import analyze_stack_blocked  # noqa: E402
from tissue_analysis_tpu.graph.from_image import (  # noqa: E402
    graph_from_table as jax_graph_from_table,
)
from tissue_analysis_tpu_torch import engine  # noqa: E402
from tissue_analysis_tpu_torch.core.stack import LabeledStack  # noqa: E402
from tissue_analysis_tpu_torch.graph import graph_from_image, graph_from_table  # noqa: E402


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return (
            isinstance(b, dict) and a.keys() == b.keys()
            and all(_same(a[k], b[k]) for k in a)
        )
    if isinstance(a, (tuple, list)):
        return (
            isinstance(b, (tuple, list)) and len(a) == len(b)
            and all(_same(x, y) for x, y in zip(a, b))
        )
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def assert_graphs_equal(ref, port):
    assert ref.nb_vertices() == port.nb_vertices()
    assert ref.nb_edges() == port.nb_edges()
    assert sorted(ref.vertex_property_names()) == sorted(port.vertex_property_names())
    for name in ref.vertex_property_names():
        assert _same(ref.vertex_property(name), port.vertex_property(name)), name
    assert sorted(ref.edge_property_names()) == sorted(port.edge_property_names())
    for name in ref.edge_property_names():
        assert _same(ref.edge_property(name), port.edge_property(name)), name
    for eid in ref.edges():
        assert ref.edge_vertices(eid) == port.edge_vertices(eid)
    for name in ref.graph_property_names():
        assert _same(ref.graph_property(name), port.graph_property(name)), name


@pytest.fixture(scope="module")
def tables(small3d):
    ref = analyze_stack_blocked(JaxStack.from_array(small3d, background=1))
    port = engine.analyze_stack(LabeledStack.from_array(small3d, background=1, device="cpu"))
    return ref, port


@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        {"default_real_property": False},
        {"bbox_as_real": True, "min_contact_area": 2.0},
        {"remove_stack_margins_cells": True, "ignoredlabels": (3,)},
    ],
    ids=["default", "voxel-units", "real-bbox-min-area", "margins-ignored"],
)
def test_graph_from_table_matches_reference(tables, kwargs):
    ref, port = tables
    g_ref = jax_graph_from_table(ref, background=1, **kwargs)
    g_port = graph_from_table(port, background=1, **kwargs)
    assert g_port.nb_edges() > 0
    assert_graphs_equal(g_ref, g_port)


def test_graph_from_image_entry_point(small3d, tables):
    ref, _ = tables
    assert_graphs_equal(
        jax_graph_from_table(ref, background=1),
        graph_from_image(small3d, background=1, device="cpu"),
    )


def test_graph_from_image_2d(small2d):
    """graph_from_image on a 2D image (the [1, Y, X] lift) equals the JAX
    package's."""
    from tissue_analysis_tpu.graph.from_image import (
        graph_from_image as jax_graph_from_image,
    )

    g_ref = jax_graph_from_image(small2d, background=1)
    g_port = graph_from_image(small2d, background=1, device="cpu")
    assert g_port.nb_edges() > 0
    assert_graphs_equal(g_ref, g_port)
