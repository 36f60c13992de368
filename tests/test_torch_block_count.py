"""Each block's dictionary size before the sweep, and ``auto``'s use of it.

``block_label_counts_reference`` (the plain version of the count kernel) is
held against an independent numpy count: per block, the distinct labels
< n of its voxels and of the +1 z/y/x neighbours just past its far faces.
Every value is an integer: equality is exact. ``count[b] > L`` must be
exactly ``block_sweep_reference(..., L).ovf[b]``. Under ``engine="auto"``
an ordinary stack is swept once, at the L that the named block engine's
overflow reruns converge to, and its table equals the JAX package's.
The kernel itself is held against this plain version on the card
(``test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import assert_tables_equal  # noqa: E402

import tissue_analysis_tpu.engine as jax_engine  # noqa: E402
from tissue_analysis_tpu.core.stack import LabeledStack as JaxStack  # noqa: E402
from tissue_analysis_tpu_torch import engine  # noqa: E402
from tissue_analysis_tpu_torch.core.stack import LabeledStack  # noqa: E402
from tissue_analysis_tpu_torch.core.synthetic import grid_stack, voronoi_stack  # noqa: E402
from tissue_analysis_tpu_torch.ops import block_sweep as bs  # noqa: E402
from tissue_analysis_tpu_torch.ops.sweep_cases import CASES  # noqa: E402
from tissue_analysis_tpu_torch.utils import timing  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these stacks are small, and the suite's workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_counts(dense: np.ndarray, n: int, block) -> np.ndarray:
    """The dictionary size of every block (z-major order), block by block."""
    Z, Y, X = dense.shape
    bz, by, bx = block
    out = []
    for oz in range(0, Z, bz):
        for oy in range(0, Y, by):
            for ox in range(0, X, bx):
                ez, ey, ex = min(bz, Z - oz), min(by, Y - oy), min(bx, X - ox)
                parts = [dense[oz:oz + ez, oy:oy + ey, ox:ox + ex]]
                if oz + bz < Z:
                    parts.append(dense[oz + bz, oy:oy + ey, ox:ox + ex])
                if oy + by < Y:
                    parts.append(dense[oz:oz + ez, oy + by, ox:ox + ex])
                if ox + bx < X:
                    parts.append(dense[oz:oz + ez, oy:oy + ey, ox + bx])
                v = np.concatenate([p.reshape(-1) for p in parts]).astype(np.int64)
                out.append(np.unique(v[(v >= 0) & (v < n)]).size)
    return np.asarray(out, dtype=np.int32)


def _random(shape, k, n, dtype, seed, low=0):
    """Labels drawn from ``low..k-1`` in runs of 1-5 voxels along x; ``n``
    below ``k`` leaves some of them out of the dictionary."""
    rng = np.random.default_rng(seed)
    size = int(np.prod(shape))
    lab = rng.integers(low, k, size)
    reps = rng.integers(1, 6, size)
    return np.ascontiguousarray(np.repeat(lab, reps)[:size].reshape(shape), dtype=dtype), n


# name -> (dense, n, block)
RANDOM = {
    "3d-ragged-u16": lambda: (*_random((19, 37, 150), 300, 300, np.uint16, 1), (8, 16, 128)),
    "3d-ragged-i32-n-below-max": lambda: (*_random((11, 20, 140), 90, 70, np.int32, 2),
                                         (8, 16, 128)),
    "3d-i32-negative": lambda: (*_random((9, 17, 70), 50, 50, np.int32, 3, low=-5), (4, 8, 32)),
    "3d-u16-few": lambda: (*_random((16, 32, 256), 3, 3, np.uint16, 4), (8, 16, 128)),
    "2d-lifted-u16": lambda: (*_random((1, 200, 300), 2000, 2000, np.uint16, 5), (1, 128, 128)),
    "2d-lifted-i32": lambda: (*_random((1, 130, 140), 70000, 70000, np.int32, 6), (1, 128, 128)),
}


def _cases():
    out = {name: lambda make=make: make()[:3] for name, make in CASES.items()}
    out.update(RANDOM)
    return out


ALL = _cases()


@pytest.mark.parametrize("name", list(ALL))
def test_reference_equals_numpy_count(name):
    dense, n, block = ALL[name]()
    want = numpy_counts(dense, n, block)
    got = bs.block_label_counts_reference(torch.from_numpy(dense), n, block, 1 << 20)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())
    # on the CPU the wrapper is the plain version, and launches nothing
    before = bs.block_label_counts.launches
    assert torch.equal(bs.block_label_counts(torch.from_numpy(dense), n, block, 1 << 20), got)
    assert bs.block_label_counts.launches == before


@pytest.mark.parametrize("name", list(ALL))
def test_count_past_L_is_the_sweeps_overflow(name):
    dense, n, block = ALL[name]()
    t = torch.from_numpy(dense)
    count = bs.block_label_counts_reference(t, n, block, 1 << 20)
    for L in sorted({1, 4, 16, 32, 64, max(1, int(count.max())), max(1, int(count.max()) - 1)}):
        ovf = bs.block_sweep_reference(t, n, block, L).ovf
        assert torch.equal(ovf.bool(), count > L), L


def test_count_saturates_at_cap_plus_one():
    dense, n, block = RANDOM["2d-lifted-u16"]()
    t = torch.from_numpy(dense)
    exact = numpy_counts(dense, n, block)
    assert exact.max() > 100
    for cap in (1, 50, int(exact.max()) - 1, int(exact.max()), 4096):
        got = bs.block_label_counts_reference(t, n, block, cap).numpy()
        np.testing.assert_array_equal(np.minimum(exact, cap + 1), got)
    with pytest.raises(TypeError, match="uint16 or int32"):
        bs.block_label_counts(t.to(torch.int64), n, block, 32)
    with pytest.raises(ValueError, match="positive"):
        bs.block_label_counts(t, n, block, 0)


@pytest.mark.parametrize("shape,ncells,seed,L", [
    ((24, 40, 150), 90, 1, 32),  # 3D
    ((24, 40, 150), 90, 1, 4),  # 3D from L = 4: the named engine reruns
    ((200, 300), 120, 2, 8),  # 2D, lifted to [1, Y, X]
])
def test_auto_sweeps_once_at_the_counted_L(monkeypatch, shape, ncells, seed, L):
    """``auto`` on an ordinary stack: one count, one sweep at the L the
    named engine's reruns reach, a table equal to that engine's and to the
    JAX package's ``analyze_stack``."""
    img = voronoi_stack(shape, ncells, seed=seed, sphere=False)
    st = LabeledStack.from_array(img, background=1, device="cpu")
    assert st.n_labels > L
    calls = []
    real = engine.block_sweep_reference
    monkeypatch.setattr(engine, "block_sweep_reference",
                        lambda *a: calls.append(a[3]) or real(*a))
    for k in [k for k in engine._GOOD_L if k[3] == L]:
        del engine._GOOD_L[k]
    ladder = engine.analyze_stack(st, "torch", L=L)
    converged = calls[-1]
    assert calls == [L * 2 ** i for i in range(len(calls))]
    for k in [k for k in engine._GOOD_L if k[3] == L]:
        del engine._GOOD_L[k]
    calls.clear()
    engine.reroutes = 0
    with timing.collect() as t:
        got = engine.analyze_stack(st, L=L)
    assert calls == [converged] and engine.reroutes == 0
    assert [s.name for s in t.stages if s.name.startswith("device")] == [
        "device count (block labels)", "device sweep (block)"]
    assert_tables_equal(ladder, got)
    assert_tables_equal(jax_engine.analyze_stack(JaxStack.from_array(img, background=1)), got)


def test_no_count_where_the_label_space_fits_L(monkeypatch):
    """A stack of no more labels than the starting L cannot overflow it:
    ``auto`` sweeps with no count."""
    img = voronoi_stack((16, 20, 140), 20, seed=3)
    st = LabeledStack.from_array(img, background=1, device="cpu")
    assert st.n_labels <= 32
    calls = []
    real = bs.block_label_counts_reference
    monkeypatch.setattr(bs, "block_label_counts_reference",
                        lambda *a: calls.append(a) or real(*a))
    with timing.collect() as t:
        engine.analyze_stack(st)
    assert calls == [] and [s.name for s in t.stages if s.name.startswith("device")] == [
        "device sweep (block)"]


def test_grid_counts_in_closed_form():
    """A grid of 4x4x4 cells: a default block holds 2x4x32 cells and the
    200 past its far faces, 456 labels, except the blocks at the far edges
    of the stack."""
    img = grid_stack((32, 64, 256), (4, 4, 4))
    st = LabeledStack.from_array(img, background=None, device="cpu")
    got = bs.block_label_counts(st.dense, st.n_labels, bs.DEFAULT_BLOCK, 4096).numpy()
    gz, gy, gx = 4, 4, 2
    z, y, x = np.unravel_index(np.arange(gz * gy * gx), (gz, gy, gx))
    want = (256 + 128 * (z < gz - 1) + 64 * (y < gy - 1) + 8 * (x < gx - 1))
    np.testing.assert_array_equal(want, got)
    assert got.max() == 456


@pytest.mark.parametrize("name", list(ALL))
def test_plain_largest_is_the_counts_max(name):
    """``count_block_labels`` on the CPU: the plain counts and their
    maximum, saturated as the counts are."""
    dense, n, block = ALL[name]()
    t = torch.from_numpy(dense)
    exact = numpy_counts(dense, n, block)
    for cap in (1, 4, 1 << 20):
        got = bs.count_block_labels(t, n, block, cap)
        assert got.largest.dtype == torch.int32 and got.largest.dim() == 0
        assert torch.equal(got.counts, bs.block_label_counts_reference(t, n, block, cap))
        assert int(got.largest) == min(int(exact.max()), cap + 1) == int(got.counts.max())


def test_fit_dictionary_reads_the_largest_count(monkeypatch):
    """``fit_dictionary`` takes L from the largest count the count returns
    beside the counts, not from a reduction of its own over them."""
    img = voronoi_stack((24, 40, 150), 90, seed=1, sphere=False)
    st = LabeledStack.from_array(img, background=1, device="cpu")
    real = bs.count_block_labels
    m = int(real(st.dense, st.n_labels, bs.DEFAULT_BLOCK, 4096).largest)
    assert 32 < m <= 64

    def told(dense, n, block, cap):
        got = real(dense, n, block, cap)
        return bs.LabelCounts(got.counts, torch.tensor(200, dtype=torch.int32))

    monkeypatch.setattr(engine, "count_block_labels", told)
    d = engine._block_plan(st, "torch")
    assert engine.fit_dictionary(d) is None and d.L == 256
    monkeypatch.setattr(engine, "count_block_labels", real)
    d = engine._block_plan(st, "torch")
    assert engine.fit_dictionary(d) is None and d.L == 64


def _view(shape, dtype, offset=0):
    """A contiguous [Z, Y, X] tensor starting ``offset`` elements into its
    storage."""
    flat = torch.zeros(offset + int(np.prod(shape)), dtype=dtype)
    return flat[offset:].view(shape)


@pytest.mark.parametrize("shape,dtype,block,offset,path,box", [
    ((512, 512, 512), torch.uint16, (8, 16, 128), 0, "bulk", (9, 17, 136)),
    ((512, 512, 512), torch.int32, (8, 16, 128), 0, "bulk", (9, 17, 132)),
    ((1, 4096, 4096), torch.uint16, (1, 128, 128), 0, "bulk", (1, 129, 136)),
    ((13, 37, 300), torch.int32, (8, 16, 128), 0, "bulk", (9, 17, 132)),
    ((13, 37, 296), torch.uint16, (8, 16, 128), 0, "bulk", (9, 17, 136)),
    ((5, 37, 300), torch.int32, (8, 16, 128), 0, "bulk", (5, 17, 132)),
    ((13, 37, 301), torch.uint16, (8, 16, 128), 0, "direct", (9, 17, 136)),
    ((13, 37, 300), torch.int32, (8, 16, 128), 1, "direct", (9, 17, 132)),
    ((13, 37, 296), torch.uint16, (8, 16, 128), 4, "direct", (9, 17, 136)),
    ((13, 37, 296), torch.uint16, (8, 16, 128), 8, "bulk", (9, 17, 136)),
    ((20, 36, 70), torch.int32, (4, 8, 32), 0, "direct", (5, 9, 36)),
    ((20, 36, 512), torch.uint16, (4, 8, 300), 0, "direct", (5, 9, 304)),
])
def test_count_plan_follows_the_stated_rule(shape, dtype, block, offset, path, box):
    """The load path from shape, label width and pointer alone: TMA tiles
    where the first byte and the row pitch are multiples of 16 bytes and a
    tile's sides are at most 256, direct loads elsewhere; the shared memory
    a CTA is the hash, the listed slots and one tile."""
    t = _view(shape, dtype, offset)
    plan = bs.count_plan(t, block, 2607)
    assert (plan.path, plan.stages, plan.box) == (path, int(path == "bulk"), box)
    assert plan.hbits == 12 and plan.nlist == 1024
    fixed = 128 + 4 * (4096 + 1024 + 32)
    assert plan.stage_bytes % 128 == 0
    assert plan.smem == fixed + plan.stages * (plan.stage_bytes + 8) <= bs._MAX_SMEM
    if path == "bulk":
        assert plan.stage_bytes >= np.prod(box) * t.element_size()


def test_count_plan_hash_follows_the_cap():
    """At least 1.25 (cap + 1) slots, 64 at the least: the largest cap whose
    hash fits shared memory is 26,213 (32,768 slots)."""
    t = _view((8, 16, 256), torch.int32)
    caps = (1, 50, 51, 2607, 3275, 3276, 26213)
    assert [bs.count_plan(t, bs.DEFAULT_BLOCK, c).hbits for c in caps] == [6, 6, 7, 12, 12, 13, 15]
    assert bs.count_plan(t, bs.DEFAULT_BLOCK, 26213).smem <= bs._MAX_SMEM
    with pytest.raises(ValueError, match="shared-memory bound"):
        bs.count_plan(t, bs.DEFAULT_BLOCK, 26214)
