"""Port's copy of the scipy oracle vs the JAX package's, and vs the port.

The oracle is host scipy in both packages; the copy must give equal
answers on the same stack (exact), and the port's facade must agree with it
where the JAX tests hold the JAX facade to it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_graph import _same  # noqa: E402

from tissue_analysis_tpu.oracle import ScipyOracle as JaxOracle  # noqa: E402
from tissue_analysis_tpu_torch import SpatialImageAnalysis  # noqa: E402
from tissue_analysis_tpu_torch.oracle import ScipyOracle  # noqa: E402


@pytest.fixture(scope="module")
def pair(small3d):
    return JaxOracle(small3d, background=1), ScipyOracle(small3d, background=1)


QUERIES = {
    "volume": lambda o: o.volume(),
    "volume-voxels": lambda o: o.volume(real=False),
    "barycenter": lambda o: o.barycenter(),
    "boundingbox": lambda o: o.boundingbox(),
    "neighbors": lambda o: o.neighbors(),
    "neighbors-26": lambda o: o.neighbors(connectivity=3),
    "neighbors-min-area": lambda o: o.neighbors(min_contact_area=2.0),
    "wall_pairs": lambda o: o.wall_pairs(),
    "wall_pairs-faces": lambda o: o.wall_pairs(real=False),
    "cell_wall_surface": lambda o: o.cell_wall_surface(1, int(o.labels[3])),
    "cells_in_image_margins": lambda o: o.cells_in_image_margins(),
    "l1": lambda o: o.l1(),
    "epidermis_surface": lambda o: o.epidermis_surface(),
    "integer_moments": lambda o: o.integer_moments(),
    "inertia_axes": lambda o: o.inertia_axes(),
}


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_oracle_equals_reference(pair, query):
    ref, port = pair
    assert _same(QUERIES[query](ref), QUERIES[query](port)), query


def test_port_table_matches_oracle(small3d, pair):
    """The port's table against the copied oracle, as ``test_adjacency_parity``
    holds the JAX table against the JAX oracle."""
    _, oracle = pair
    t = SpatialImageAnalysis(small3d, background=1, device="cpu").table()
    assert t.adjacency() == oracle.neighbors()
    assert t.l1_labels() == oracle.l1()
    order = np.argsort(t.ids)
    count, s1, s2, cmin, cmax = oracle.integer_moments()
    for got, want in ((t.count, count), (t.s1, s1), (t.s2, s2), (t.cmin, cmin), (t.cmax, cmax)):
        np.testing.assert_array_equal(got[order], want)
