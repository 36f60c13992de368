"""Port's analyze_stack (CPU, plain engine) vs the JAX package's engines.

The same images go through ``tissue_analysis_tpu.engine`` (the Pallas
engine in interpret mode and the XLA blocked engine) and through
``tissue_analysis_tpu_torch.engine``; every FeatureTable field must agree
exactly (atol 0: all fields are integers or booleans).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tissue_analysis_tpu.core.stack import LabeledStack as JaxStack  # noqa: E402
from tissue_analysis_tpu.core.synthetic import voronoi_stack  # noqa: E402
from tissue_analysis_tpu.engine import (  # noqa: E402
    analyze_stack_blocked,
    analyze_stack_pallas,
)
from tissue_analysis_tpu_torch import engine  # noqa: E402
from tissue_analysis_tpu_torch.core.stack import LabeledStack  # noqa: E402
from tissue_analysis_tpu_torch.ops.block_sweep import DEFAULT_BLOCK  # noqa: E402
from tissue_analysis_tpu_torch.utils import timing  # noqa: E402

FIELDS = (
    "count", "s1", "s2", "cmin", "cmax",
    "pair_lo", "pair_hi", "wall_face_counts", "margin",
)

# fixture name (tests/conftest.py, or "voronoi" below) -> background label
IMAGES = {
    "small3d": 1,
    "gapped": 1,
    "cube": 1,
    "slabs": None,
    "voronoi": 1,
}


@pytest.fixture(scope="session")
def voronoi():
    return voronoi_stack((32, 48, 130), 60, seed=2, voxelsize=(2.0, 0.5, 0.5))


def assert_tables_equal(ref, port):
    for f in FIELDS:
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(ref.ids, port.ids)
    assert ref.ids.dtype == port.ids.dtype
    assert ref.shape == port.shape
    assert ref.voxelsize == port.voxelsize
    assert ref.background_segment == port.background_segment


@pytest.fixture(scope="module")
def tables(request):
    cache = {}

    def get(name):
        if name not in cache:
            img = request.getfixturevalue(name)
            bg = IMAGES[name]
            js = JaxStack.from_array(img, background=bg)
            ps = LabeledStack.from_array(img, background=bg, device="cpu")
            cache[name] = (js, ps, engine.analyze_stack(ps))
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(IMAGES))
def test_port_equals_pallas_engine(tables, name):
    js, ps, port = tables(name)
    assert_tables_equal(analyze_stack_pallas(js), port)


@pytest.mark.parametrize("name", list(IMAGES))
def test_port_equals_blocked_engine(tables, name):
    js, ps, port = tables(name)
    assert_tables_equal(analyze_stack_blocked(js), port)


@pytest.mark.parametrize("name", list(IMAGES))
def test_stack_from_reference_fields(tables, name):
    """The port's relabel gives the reference's segment ids, and a stack
    built from the reference stack's numpy fields gives the same table."""
    js, ps, port = tables(name)
    np.testing.assert_array_equal(np.asarray(js.dense), ps.dense.to(torch.int32).numpy())
    assert ps.dense.dtype == (torch.uint16 if ps.n_labels <= 0xFFFF else torch.int32)
    st = LabeledStack.from_numpy(
        np.asarray(js.dense), js.ids, js.voxelsize, js.background_segment, device="cpu"
    )
    assert_tables_equal(port, engine.analyze_stack(st, engine="torch"))


def test_dict_overflow_retry_runs_and_converges(tables):
    _, ps, port = tables("voronoi")
    key = (ps.shape, ps.n_labels, DEFAULT_BLOCK, 4)
    engine._GOOD_L.pop(key, None)
    with timing.collect() as t:
        small = engine.analyze_stack(ps, L=4)
    sweeps = [s for s in t.stages if s.name == "device sweep (block)"]
    # the retry really ran: several sweeps, converged L above the request
    assert len(sweeps) >= 2
    assert engine._GOOD_L[key] == 4 * 2 ** (len(sweeps) - 1)
    assert_tables_equal(port, small)
    # a repeat call starts from the converged size: one sweep
    with timing.collect() as t:
        again = engine.analyze_stack(ps, L=4)
    assert sum(s.name == "device sweep (block)" for s in t.stages) == 1
    assert_tables_equal(port, again)


def test_engine_selection_never_falls_back(tables, monkeypatch):
    _, ps, port = tables("cube")
    with pytest.raises(ValueError, match="cuda"):
        engine.analyze_stack(ps, engine="cuda")
    with pytest.raises(ValueError, match="unknown engine"):
        engine.analyze_stack(ps, engine="pallas")
    assert_tables_equal(port, engine.analyze_stack(ps, engine="torch"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        LabeledStack.from_array(np.ones((4, 4, 4), np.uint8), device="cuda")


def test_2d_stack_not_ported_yet():
    """2D stacks used to raise NotImplementedError; they now run through
    the [1, Y, X] lift (held against the JAX engines in test_torch_2d.py).
    Here: the closed-form tables of a diagonal on an 8×8 image."""
    st = LabeledStack.from_array(
        np.ones((8, 8), np.uint8) + np.eye(8, dtype=np.uint8), device="cpu"
    )
    t = engine.analyze_stack(st)
    assert t.shape == (8, 8) and t.s1.shape == (2, 2) and t.s2.shape == (2, 3)
    np.testing.assert_array_equal(t.ids, [1, 2])
    np.testing.assert_array_equal(t.count, [56, 8])
    np.testing.assert_array_equal(t.s1[1], [28, 28])
    # the diagonal touches its 1-neighbours along y 7 times and along x 7 times
    # in each direction: 14 faces per axis
    np.testing.assert_array_equal(t.wall_face_counts, [[14, 14]])
    assert t.margin.tolist() == [True, True]
    with pytest.raises(ValueError, match="2D or 3D"):
        engine.analyze_stack(LabeledStack(st.dense[None, None], st.ids, (1.0,) * 4, None))


def test_more_than_65535_labels():
    """int32 stacks have no label ceiling: a grid of 65,536 box cells
    against closed-form moments and adjacency."""
    from tissue_analysis_tpu_torch.core.synthetic import grid_stack

    shape, cell = (64, 256, 256), (4, 4, 4)
    grid = tuple(s // c for s, c in zip(shape, cell))
    n = int(np.prod(grid))
    st = LabeledStack.from_array(grid_stack(shape, cell), background=None, device="cpu")
    assert n > 0xFFFF and st.dense.dtype == torch.int32
    # 256 cells per 8x16x128 block: start at a dictionary that holds them
    t = engine.analyze_stack(st, L=512)
    assert t.n_labels == n and np.all(t.count == 64)
    g = np.stack(np.unravel_index(np.arange(n), grid), axis=1).astype(np.int64)
    org = g * np.asarray(cell)
    np.testing.assert_array_equal(t.cmin, org)
    np.testing.assert_array_equal(t.cmax, org + 3)
    np.testing.assert_array_equal(t.s1, 64 * org + 16 * 6)
    gz, gy, gx = grid
    assert t.n_pairs == (gz - 1) * gy * gx + gz * (gy - 1) * gx + gz * gy * (gx - 1)
    assert np.all(t.wall_face_counts.sum(axis=1) == 16)


def test_analyze_entry_point(small3d, tables):
    _, _, port = tables("small3d")
    assert_tables_equal(port, engine.analyze(small3d, background=1, device="cpu"))


@pytest.mark.parametrize("name", list(IMAGES))
def test_flat_engine_equals_block_engine(tables, name):
    """``engine="chunked"`` (no per-block dictionary) gives the table the
    block engine gives (held against the Pallas and blocked engines above)."""
    _, ps, port = tables(name)
    with timing.collect() as t:
        assert_tables_equal(port, engine.analyze_stack(ps, engine="chunked"))
    assert [s.name for s in t.stages] == [
        "device sweep (flat moments)", "device sweep (flat pairs)", "readback + host assemble",
    ]
    assert_tables_equal(port, engine.analyze_stack_chunked(ps, chunk=4096))


def test_engine_names():
    assert engine.ENGINES == ("auto", "cuda", "torch", "chunked")
    want = {"auto": "auto", "cuda": "cuda", "torch": "torch", "chunked": "chunked",
            "pallas": "cuda", "blocked": "torch"}
    assert {k: engine.resolve_engine(k) for k in want} == want
    with pytest.raises(ValueError, match="unknown engine"):
        engine.resolve_engine("xla")


def test_dispatched_flat_sweep_has_no_overflow_loop(tables):
    """A dispatch of the flat engine is finished already: ``finish_stack``
    hands its tables on, whatever L or bucket was asked for."""
    _, ps, port = tables("voronoi")
    d = engine.dispatch_stack(ps, "chunked", L=1, n_bucket=4096)
    assert d.sweep is engine.flat_sweep
    fin = d.out
    assert isinstance(fin, engine.Finished) and fin.mom.shape == (ps.n_labels, 10)
    # the handle gives its tables up: it is collected once
    assert engine.finish_stack(d) is fin and d.out is None
    with pytest.raises(ValueError, match="collected already"):
        engine.collect_stack(d)
    assert_tables_equal(port, engine.collect_stack(engine.dispatch_stack(ps, "chunked")))


def test_explicit_engines_never_reroute(tables):
    """A converging stack reroutes under no engine name, and one whose
    labels a block are past the capacity only under ``auto``
    (test_torch_chunked.py)."""
    _, ps, port = tables("small3d")
    engine.reroutes = 0
    for name in engine.ENGINES:
        if name != "cuda":
            assert_tables_equal(port, engine.analyze_stack(ps, engine=name))
    assert engine.reroutes == 0
    dense = LabeledStack.from_array(
        np.arange(8 * 16 * 40, dtype=np.int32).reshape(8, 16, 40), device="cpu")
    with pytest.raises(RuntimeError, match='L=4096.*engine="chunked"'):
        engine.analyze_stack(dense, engine="torch")
    assert engine.reroutes == 0
