"""Dictionary sizes past the kernel's shared-memory face matrix (L > ~135).

A grid of 4³-voxel cells puts ~456 dictionary labels in each default
8×16×128 block, so the engine's overflow retry must double L from 32 to 512.
The port's plain engine converges there in five sweeps and equals the closed
form and the JAX blocked engine (with the 16³ blocks that engine needs at
this density, as ``test_high_label_counts.py`` runs it). The kernel's global
face path is held against the plain version on the card
(``test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tissue_analysis_tpu.core.stack import LabeledStack as JaxStack  # noqa: E402
from tissue_analysis_tpu.engine import analyze_stack_blocked  # noqa: E402
from tissue_analysis_tpu.ops import blocked  # noqa: E402
from tissue_analysis_tpu_torch import engine  # noqa: E402
from tissue_analysis_tpu_torch.core.stack import LabeledStack  # noqa: E402
from tissue_analysis_tpu_torch.core.synthetic import grid_stack  # noqa: E402
from tissue_analysis_tpu_torch.ops import block_sweep as bs  # noqa: E402
from tissue_analysis_tpu_torch.utils import timing  # noqa: E402

SHAPE, CELL = (32, 64, 256), (4, 4, 4)
GRID = tuple(s // c for s, c in zip(SHAPE, CELL))
N = int(np.prod(GRID))  # 8,192 labels
FIELDS = ("count", "s1", "s2", "cmin", "cmax", "pair_lo", "pair_hi",
          "wall_face_counts", "margin")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these stacks are small, and the suite's workers
    share the cores (several threads each oversubscribe them badly)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def img():
    return grid_stack(SHAPE, CELL)


@pytest.fixture(scope="module")
def converged(img):
    """(stack, table, number of sweeps) of the port's plain engine from L = 32,
    by name: it reruns with L doubled."""
    st = LabeledStack.from_array(img, background=None, device="cpu")
    engine._GOOD_L.pop((st.shape, st.n_labels, bs.DEFAULT_BLOCK, 32), None)
    with timing.collect() as t:
        table = engine.analyze_stack(st, "torch")
    sweeps = sum(s.name == "device sweep (block)" for s in t.stages)
    return st, table, sweeps


def test_converges_at_L512_in_five_sweeps(converged, monkeypatch):
    st, table, sweeps = converged
    key = (st.shape, N, bs.DEFAULT_BLOCK, 32)
    assert sweeps == 5  # 32 → 64 → 128 → 256 → 512
    assert engine._GOOD_L[key] == 512
    # the widest block holds 256 cells + 200 past its far faces
    out = bs.block_sweep_reference(st.dense, N, bs.DEFAULT_BLOCK, 512)
    assert not bool(out.ovf.any())
    assert int((out.ids < bs.IMAX).sum(dim=1).max()) == 456
    assert int(bs.block_label_counts(st.dense, N, bs.DEFAULT_BLOCK, 4096).max()) == 456
    # "auto" counts first and sweeps once, at the L the reruns reached
    engine._GOOD_L.pop(key)
    calls = []
    real = engine.block_sweep_reference
    monkeypatch.setattr(engine, "block_sweep_reference",
                        lambda *a: calls.append(a[3]) or real(*a))
    got = engine.analyze_stack(st)
    assert calls == [512] and engine._GOOD_L[key] == 512
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(table, f), getattr(got, f), err_msg=f)


def test_equals_closed_form(converged):
    _, t, _ = converged
    assert t.n_labels == N and np.all(t.count == 64)
    g = np.stack(np.unravel_index(np.arange(N), GRID), axis=1).astype(np.int64)
    org = g * np.asarray(CELL)
    np.testing.assert_array_equal(t.cmin, org)
    np.testing.assert_array_equal(t.cmax, org + 3)
    np.testing.assert_array_equal(t.s1, 64 * org + 16 * 6)
    gz, gy, gx = GRID
    assert t.n_pairs == (gz - 1) * gy * gx + gz * (gy - 1) * gx + gz * gy * (gx - 1)
    assert np.all(t.wall_face_counts.sum(axis=1) == 16)


def test_equals_jax_blocked_engine(img, converged):
    _, t, _ = converged
    cfg = blocked.BlockConfig(block=(16, 16, 16), max_labels_per_block=96)
    ref = analyze_stack_blocked(JaxStack.from_array(np.asarray(img), background=None), cfg=cfg)
    for f in FIELDS:
        a, b = getattr(ref, f), getattr(t, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(ref.ids, t.ids)


def test_overflow_past_the_bound_raises(img, monkeypatch):
    st = LabeledStack.from_array(img, background=None, device="cpu")
    monkeypatch.setattr(engine, "PLAIN_MAX_DICT", 128)
    key = (st.shape, st.n_labels, bs.DEFAULT_BLOCK, 32)
    engine._GOOD_L.pop(key, None)
    with timing.collect() as t:
        with pytest.raises(RuntimeError, match='L=128.*engine="chunked"'):
            engine.analyze_stack(st, engine="torch")
    assert sum(s.name == "device sweep (block)" for s in t.stages) == 3
    assert key not in engine._GOOD_L
    # 256 labels a block over the whole image: "auto" knows before any
    # sweep, says so and gives the stack to the flat engine
    engine.reroutes = 0
    with timing.collect() as t:
        with pytest.warns(UserWarning, match='256 labels or more.*L=128.*engine="chunked"'):
            got = engine.analyze_stack(st)
    assert not any(s.name == "device sweep (block)" for s in t.stages)
    assert engine.reroutes == 1 and key not in engine._GOOD_L
    monkeypatch.undo()
    want = engine.analyze_stack(st, engine="torch")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f), err_msg=f)


def test_face_buffer_larger_than_free_device_memory_raises(monkeypatch):
    """A face buffer the device cannot hold raises ValueError naming the
    bytes and the block, not the allocator's bare out-of-memory error (here
    a pretend CUDA device with 1 MB free)."""

    def oom(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(torch, "zeros", oom)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (1 << 20, 1 << 30))
    with pytest.raises(ValueError, match=r"2048 blocks of \(8, 16, 128\) at L=512 need "
                                         r"6,442,450,944 bytes; cuda has 1,048,576 free"):
        bs._faces_buffer(2048, 512, (8, 16, 128), torch.device("cuda"))
    monkeypatch.undo()
    # the CPU allocates as asked
    assert bs._faces_buffer(2, 8, (8, 16, 128), torch.device("cpu")).shape == (2, 8, 24)
