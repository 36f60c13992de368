"""CUDA kernel vs its plain PyTorch version, and the card vs the CPU.

Marked ``cuda``: every test skips without a CUDA device. On a machine with
one (and nvcc), run them without the JAX test configuration::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The plain version is held against the JAX package's kernel on the CPU by
``test_torch_block_sweep.py``; here the kernel must equal the plain version
exactly (``torch.equal``), on every block that did not overflow.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tissue_analysis_tpu_torch import engine  # noqa: E402
from tissue_analysis_tpu_torch.core.stack import LabeledStack  # noqa: E402
from tissue_analysis_tpu_torch.core.synthetic import voronoi_stack  # noqa: E402
from tissue_analysis_tpu_torch.ops import block_sweep as bs  # noqa: E402
from tissue_analysis_tpu_torch.ops.block_sweep import (  # noqa: E402
    block_sweep,
    block_sweep_reference,
    max_dict_size,
)
from tissue_analysis_tpu_torch.ops.sweep_cases import CASES as SWEEP_CASES  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _stack(shape, ncells, seed, device):
    img = voronoi_stack(shape, ncells, seed=seed)
    return LabeledStack.from_array(img, background=1, device=device)


def _assert_sweeps_equal(k, r):
    assert torch.equal(k.ovf, r.ovf)
    ok = ~r.ovf.bool()
    for name in ("ids", "mom", "gmin", "gmax", "faces"):
        a, b = getattr(k, name), getattr(r, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a[ok], b[ok]), name


@pytest.mark.parametrize(
    "shape,ncells,dtype,block,L",
    [
        ((64, 64, 64), 150, torch.uint16, (8, 16, 128), 32),
        ((24, 40, 130), 45, torch.uint16, (8, 16, 128), 32),
        ((16, 32, 256), 60, torch.int32, (8, 16, 128), 32),
        ((20, 36, 70), 80, torch.uint16, (4, 8, 32), 16),
        ((3, 130, 140), 40, torch.int32, (1, 128, 128), 32),
        ((32, 48, 130), 200, torch.uint16, (8, 16, 128), 8),  # overflows
    ],
)
def test_kernel_equals_plain_version(dev, shape, ncells, dtype, block, L):
    st = _stack(shape, ncells, 0, dev)
    dense = st.dense.to(dtype)
    before = block_sweep.launches
    k = block_sweep(dense, st.n_labels, block, L)
    torch.cuda.synchronize()
    assert block_sweep.launches == before + 1
    r = block_sweep_reference(dense, st.n_labels, block, L)
    _assert_sweeps_equal(k, r)
    if L == 8:
        assert bool(k.ovf.any())


def test_engine_cuda_equals_cpu(dev):
    img = voronoi_stack((40, 48, 136), 90, seed=4, voxelsize=(2.0, 0.5, 0.5))
    cpu = engine.analyze_stack(LabeledStack.from_array(img, background=1, device="cpu"))
    before = block_sweep.launches
    gpu = engine.analyze_stack(LabeledStack.from_array(img, background=1, device=dev))
    assert block_sweep.launches > before
    for f in ("ids", "count", "s1", "s2", "cmin", "cmax", "pair_lo", "pair_hi",
              "wall_face_counts", "margin"):
        np.testing.assert_array_equal(getattr(cpu, f), getattr(gpu, f), err_msg=f)


def test_engine_cuda_beyond_uint16_labels(dev):
    """65,536 labels (int32 stack) through the kernel, with the dictionary
    retry (82 labels per block: L 32 → 64 → 128), equal to the plain engine."""
    from tissue_analysis_tpu_torch.core.synthetic import grid_stack

    img = grid_stack((256, 256, 512), (8, 8, 8))
    st = LabeledStack.from_array(img, background=None, device=dev)
    assert st.n_labels == 65536 and st.dense.dtype == torch.int32
    before = block_sweep.launches
    gpu = engine.analyze_stack(st)
    assert block_sweep.launches - before == 3
    plain = engine.analyze_stack(st, engine="torch")
    for f in ("count", "s1", "s2", "cmin", "cmax", "pair_lo", "pair_hi",
              "wall_face_counts", "margin"):
        np.testing.assert_array_equal(getattr(plain, f), getattr(gpu, f), err_msg=f)
    assert np.all(gpu.count == 512)


def test_dict_size_beyond_shared_memory_raises(dev):
    st = _stack((8, 16, 128), 10, 0, dev)
    with pytest.raises(ValueError, match="shared-memory"):
        block_sweep(st.dense, st.n_labels, L=max_dict_size() + 1)


def _sparse_ids(dense, n, seed):
    """Segment ids 0..k-1 → distinct ids spread over 0..n-1 (int32)."""
    k = int(dense.to(torch.int32).max()) + 1
    lut = np.sort(np.random.default_rng(seed).choice(n, size=k, replace=False))
    lut[-1] = n - 1
    return torch.from_numpy(lut.astype(np.int32)).to(dense.device)[dense.to(torch.int64)]


@pytest.mark.parametrize(
    "shape,ncells,block",
    [((16, 32, 256), 60, (8, 16, 128)), ((1, 300, 520), 50, (1, 128, 128))],
)
def test_kernel_equals_plain_version_label_space_past_uint16(dev, shape, ncells, block):
    """K2's label range: ids spread over n = 70,000 (int32)."""
    st = _stack(shape, ncells, 0, dev)
    dense = _sparse_ids(st.dense, 70000, 3).contiguous()
    k = block_sweep(dense, 70000, block, 32)
    torch.cuda.synchronize()
    r = block_sweep_reference(dense, 70000, block, 32)
    _assert_sweeps_equal(k, r)
    assert not bool(k.ovf.any())


def test_kernel_equals_plain_version_at_L128(dev):
    """A dense grid (8³ cells: 82 labels per default block) at L = 128,
    the largest dictionary the kernel's shared memory holds."""
    from tissue_analysis_tpu_torch.core.synthetic import grid_stack

    st = LabeledStack.from_array(grid_stack((64, 128, 256), (8, 8, 8)), device=dev)
    dense = st.dense.to(torch.int32)
    assert max_dict_size() >= 128
    k = block_sweep(dense, st.n_labels, (8, 16, 128), 128)
    torch.cuda.synchronize()
    r = block_sweep_reference(dense, st.n_labels, (8, 16, 128), 128)
    _assert_sweeps_equal(k, r)
    assert not bool(k.ovf.any())
    assert int((r.ids < 2**31 - 1).sum(dim=1).max()) == 82


FIELDS = ("ids", "count", "s1", "s2", "cmin", "cmax", "pair_lo", "pair_hi",
          "wall_face_counts", "margin")


def test_2d_cuda_equals_cpu(dev):
    img = voronoi_stack((600, 700), 120, seed=2, voxelsize=(0.5, 2.0))
    cpu = engine.analyze(img, background=1, device="cpu")
    before = block_sweep.launches
    gpu = engine.analyze(img, background=1, device=dev)
    assert block_sweep.launches > before
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(cpu, f), getattr(gpu, f), err_msg=f)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int64])
def test_analyze_raw_cuda_equals_cpu(dev, dtype):
    img = np.asarray(voronoi_stack((40, 48, 136), 90, seed=4)).astype(dtype)
    cpu = engine.analyze(img, background=1, device="cpu")
    before = block_sweep.launches
    gpu = engine.analyze_raw(img, background=1, device=dev)
    assert block_sweep.launches > before
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(cpu, f), getattr(gpu, f), err_msg=f)


@pytest.mark.parametrize("shape,ncells", [((40, 48, 72), 60), ((300, 340), 60)])
def test_facade_cuda_equals_cpu(dev, shape, ncells):
    from tissue_analysis_tpu_torch.analysis import SpatialImageAnalysis, hollow_out_cells

    img = voronoi_stack(shape, ncells, seed=5)
    cpu = SpatialImageAnalysis(img, background=1, device="cpu")
    gpu = SpatialImageAnalysis(img, background=1, device=dev)
    assert gpu.stack().device.type == "cuda"
    before = block_sweep.launches
    for q, kw in (("volume", {}), ("neighbors", {}), ("L1", {}),
                  ("border_cells", {}), ("wall_surfaces", {}),
                  ("neighbors", {"connectivity": len(shape)})):
        assert getattr(cpu, q)(**kw) == getattr(gpu, q)(**kw), q
    assert block_sweep.launches > before
    for l, (vecs, vals) in cpu.inertia_axis().items():
        g_vecs, g_vals = gpu.inertia_axis()[l]
        np.testing.assert_array_equal(vecs, g_vecs)
        np.testing.assert_array_equal(vals, g_vals)
    np.testing.assert_array_equal(
        np.asarray(hollow_out_cells(img, 1, device="cpu")),
        np.asarray(hollow_out_cells(img, 1, device=dev)),
    )


def _grid4(dev):
    """4³-voxel cells: ~456 dictionary labels per default block (L = 512)."""
    from tissue_analysis_tpu_torch.core.synthetic import grid_stack

    return LabeledStack.from_array(grid_stack((32, 64, 256), (4, 4, 4)), device=dev)


@pytest.mark.parametrize("L", [256, 512])
def test_kernel_global_face_path_equals_plain_version(dev, L):
    """Past ~135 an [L, 3L] face matrix would not fit shared memory; the
    kernel adds faces into a zeroed device buffer (at every L). At L = 256
    the densest blocks overflow, and the rest must still match."""
    st = _grid4(dev)
    assert 3 * L * L * 4 > bs._MAX_SMEM
    assert bs.build_kernel().ta_block_sweep_smem_bytes(L) <= bs._MAX_SMEM
    k = block_sweep(st.dense, st.n_labels, (8, 16, 128), L)
    torch.cuda.synchronize()
    r = block_sweep_reference(st.dense, st.n_labels, (8, 16, 128), L)
    _assert_sweeps_equal(k, r)
    assert bool(k.ovf.any()) == (L == 256)


@pytest.mark.parametrize("shape,ncells,dtype", [
    ((64, 64, 64), 150, torch.uint16), ((24, 40, 130), 45, torch.int32),
])
def test_kernel_global_face_path_at_small_L(dev, shape, ncells, dtype):
    """The same face path at a small L, where the face matrix would fit
    shared memory, through the launch the wrapper makes."""
    st = _stack(shape, ncells, 0, dev)
    dense = st.dense.to(dtype)
    k = bs._launch(bs.build_kernel(), dense, st.n_labels, (8, 16, 128), 32)
    torch.cuda.synchronize()
    _assert_sweeps_equal(k, block_sweep_reference(dense, st.n_labels, (8, 16, 128), 32))


def test_engine_cuda_past_the_shared_memory_bound(dev):
    """This call raised ValueError ("shared-memory bound") while the face
    matrix had to fit shared memory; it now converges at L = 512."""
    st = _grid4(dev)
    engine._GOOD_L.pop((st.shape, st.n_labels, (8, 16, 128), 32), None)
    before = block_sweep.launches
    gpu = engine.analyze_stack(st, engine="cuda")
    assert block_sweep.launches - before == 5
    assert engine._GOOD_L[(st.shape, st.n_labels, (8, 16, 128), 32)] == 512
    plain = engine.analyze_stack(st, engine="torch")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(plain, f), getattr(gpu, f), err_msg=f)
    assert np.all(gpu.count == 64) and np.all(gpu.wall_face_counts.sum(axis=1) == 16)


def test_face_buffer_past_device_memory_raises_value_error(dev):
    """A 300 GB face buffer: the allocator's out-of-memory error comes out
    as a ValueError naming the bytes and the block, and the card is usable
    after it."""
    with pytest.raises(ValueError, match=r"100000 blocks of \(8, 16, 128\) at L=512 need "
                                         r"314,572,800,000 bytes"):
        bs._faces_buffer(100000, 512, (8, 16, 128), dev)
    st = _grid4(dev)
    k = block_sweep(st.dense, st.n_labels, (8, 16, 128), 512)
    torch.cuda.synchronize()
    assert not bool(k.ovf.any())


def test_series_cuda_equals_cpu(dev):
    from tissue_analysis_tpu_torch.series import analyze_series

    frames = [voronoi_stack((64, 64, 64), nc, seed=s) for nc, s in ((90, 4), (120, 5))]
    cpu = analyze_series(frames, background=1, devices=["cpu"])
    before = block_sweep.launches
    gpu = analyze_series(frames, background=1, devices=[dev])
    assert block_sweep.launches - before >= 2
    for c, g in zip(cpu, gpu):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(c, f), getattr(g, f), err_msg=f)


def test_series_longer_than_its_window_cuda_equals_cpu(dev):
    """Five frames on one card: more than the two it keeps in flight."""
    from tissue_analysis_tpu_torch.series import analyze_series

    frames = [voronoi_stack((64, 64, 64), 60 + 20 * s, seed=s) for s in range(5)]
    cpu = analyze_series(frames, background=1, devices=["cpu"])
    before = block_sweep.launches
    gpu = analyze_series(frames, background=1, devices=[dev])
    assert block_sweep.launches - before >= 5
    assert len(gpu) == 5
    for c, g in zip(cpu, gpu):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(c, f), getattr(g, f), err_msg=f)


@pytest.mark.parametrize("slab_z", [16, 40])
def test_streamed_cuda_equals_cpu(dev, slab_z):
    from tissue_analysis_tpu_torch.streaming import analyze_streamed

    img = np.asarray(voronoi_stack((64, 64, 64), 90, seed=4))
    cpu = analyze_streamed(img, background=1, slab_z=slab_z, device="cpu")
    before = block_sweep.launches
    gpu = analyze_streamed(img, background=1, slab_z=slab_z, device=dev)
    assert block_sweep.launches - before == -(-64 // slab_z)
    resident = engine.analyze_stack(LabeledStack.from_array(img, background=1, device=dev))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(cpu, f), getattr(gpu, f), err_msg=f)
        np.testing.assert_array_equal(getattr(resident, f), getattr(gpu, f), err_msg=f)


@pytest.mark.parametrize("name", list(SWEEP_CASES))
def test_kernel_equals_plain_version_adversarial(dev, name):
    """The adversarial inputs of ``ops/sweep_cases.py``. Where a block
    overflows, its flag and its L smallest ids are still defined."""
    dense, n, block, L = SWEEP_CASES[name]()
    t = torch.from_numpy(dense).to(dev)
    before = block_sweep.launches
    k = block_sweep(t, n, block, L)
    torch.cuda.synchronize()
    assert block_sweep.launches == before + 1
    r = block_sweep_reference(t, n, block, L)
    _assert_sweeps_equal(k, r)
    assert torch.equal(k.ids, r.ids)
    assert bool(r.ovf.all()) == (name == "alternate-x-over-L")


def _sharded_equals_resident(img, mesh, background=1):
    """The sharded table of ``img`` on ``mesh``, from a stack on the card and
    from one on the CPU, against the resident table; returns the launches."""
    from tissue_analysis_tpu_torch.parallel import analyze_sharded

    st = LabeledStack.from_array(img, background=background, device="cuda:0")
    resident = engine.analyze_stack(st)
    before = block_sweep.launches
    got = analyze_sharded(st, mesh)
    launches = block_sweep.launches - before
    host = analyze_sharded(LabeledStack.from_array(img, background=background, device="cpu"),
                           mesh)
    plain = analyze_sharded(st, mesh, engine="torch")
    for t in (got, host, plain):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(resident, f), getattr(t, f), err_msg=f)
    return launches


@pytest.mark.parametrize("shape,ncells", [((64, 64, 64), 90), ((300, 340), 60)])
def test_sharded_four_slabs_on_one_card(dev, shape, ncells):
    from tissue_analysis_tpu_torch.parallel import Mesh

    img = voronoi_stack(shape, ncells, seed=4)
    assert _sharded_equals_resident(img, Mesh((torch.device("cuda:0"),) * 4)) >= 3


def test_sharded_grid_past_uint16_on_one_card(dev):
    """65,536 labels (int32); every slab reruns its dictionary to L = 128."""
    from tissue_analysis_tpu_torch.core.synthetic import grid_stack
    from tissue_analysis_tpu_torch.parallel import Mesh

    img = grid_stack((256, 256, 512), (8, 8, 8))
    engine._GOOD_L.pop(((64, 256, 512), 65536, (8, 16, 128), 32), None)
    launches = _sharded_equals_resident(img, Mesh((torch.device("cuda:0"),) * 4), None)
    assert launches == 4 * 3


def test_sharded_across_cards(dev):
    from tissue_analysis_tpu_torch.parallel import make_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    img = voronoi_stack((96, 64, 136), 120, seed=6)
    mesh = make_mesh()
    assert len(mesh.devices) == torch.cuda.device_count()
    assert _sharded_equals_resident(img, mesh) >= 2


def test_profile_trace_holds_the_sweep_kernel(dev, tmp_path):
    """The profiler hook on the card: the trace file exists, and the sweep
    kernel is among the device entries, once per launch."""
    import json

    from tissue_analysis_tpu_torch.utils import timing

    st = _stack((64, 64, 64), 150, 0, dev)
    engine.analyze_stack(st)  # build the kernel and converge L outside the trace
    before = block_sweep.launches
    with timing.profile_trace(str(tmp_path / "traces")) as prof:
        engine.analyze_stack(st)
    launched = block_sweep.launches - before
    assert launched >= 1
    with open(prof.trace_path) as f:
        assert len(json.load(f)["traceEvents"]) >= 1
    rows = timing.device_times(prof)
    sweep = [r for r in rows if "block_sweep_kernel" in r[0]]
    assert len(sweep) == 1, [r[0] for r in rows]
    assert sweep[0][1] == launched and sweep[0][2] > 0
    assert [r[2] for r in rows] == sorted((r[2] for r in rows), reverse=True)
    # the same device time by operator: the combine's scatter is there, and
    # the sweep kernel, launched outside any operator, is not
    ops = timing.device_times(prof, by_op=True)
    assert any(r[0] == "aten::index_add_" and r[2] > 0 for r in ops), [r[0] for r in ops]
    assert not any("block_sweep" in r[0] for r in ops)


@pytest.mark.parametrize("dtype", [">u2", ">i4"])
def test_raw_non_native_byte_order_on_the_card(dev, dtype):
    img = np.asarray(voronoi_stack((40, 48, 136), 90, seed=4)).astype(dtype)
    assert not img.dtype.isnative
    before = block_sweep.launches
    raw = engine.analyze_raw(img, background=1, device=dev)
    assert block_sweep.launches > before
    ref = engine.analyze(img, background=1, device=dev)
    for f in ("ids", "count", "s1", "s2", "cmin", "cmax", "pair_lo", "pair_hi",
              "wall_face_counts", "margin"):
        x, y = getattr(ref, f), getattr(raw, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


# ---------------------------------------------------------- the flat engine
def _assert_tables_equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("shape,ncells", [
    ((64, 64, 64), 90),
    ((37, 50, 131), 120),  # ragged against every block and chunk edge
    ((300, 340), 60),  # 2D, native
])
def test_flat_engine_equals_the_kernel_engine(dev, shape, ncells):
    from tissue_analysis_tpu_torch.parallel import Mesh, analyze_sharded

    st = _stack(shape, ncells, 2, dev)
    before, engine.reroutes = block_sweep.launches, 0
    want = engine.analyze_stack(st, engine="cuda")
    assert block_sweep.launches > before and engine.reroutes == 0
    before = block_sweep.launches
    for chunk in (None, 5000):
        _assert_tables_equal(want, engine.analyze_stack_chunked(st, chunk=chunk))
    _assert_tables_equal(want, engine.analyze_stack(st, engine="chunked"))
    mesh = Mesh((dev,) * 3)
    _assert_tables_equal(want, analyze_sharded(st, mesh, engine="chunked"))
    assert block_sweep.launches == before  # the flat engine launches no kernel
    _assert_tables_equal(want, engine.analyze_stack_pallas(st))
    assert block_sweep.launches > before


def test_flat_moments_equal_the_kernel_engines_on_the_card(dev):
    """``segred.moment_sweep`` at two chunk sizes against the moments that
    kernel + combine give (``finish_stack``), on the card."""
    from tissue_analysis_tpu_torch.ops import segred

    st = _stack((37, 50, 131), 120, 2, dev)
    want = engine.finish_stack(engine.dispatch_stack(st, "cuda"))[:3]
    for chunk in (None, 4097):
        got = segred.moment_sweep(st.dense, st.n_labels, chunk)
        assert all(torch.equal(a, b) for a, b in zip(want, got))


def test_dense_grid_route_on_the_card(dev, monkeypatch):
    """4096 labels a block (cells of 2x2x1) at a size that takes seconds:
    past the kernel's dictionary bound, so an explicit engine raises, and
    ``auto`` knows from the sizes alone: it launches no kernel and reroutes
    once to the flat engine. 2048 a block (cells of 2x2x2) are inside the
    bound by that count while a block's dictionary holds 2848 with its
    far-face neighbours: ``auto`` sweeps and raises as ``cuda`` does. A
    face buffer the card cannot hold raises under ``auto`` too: nothing
    reroutes after a launch."""
    from tissue_analysis_tpu_torch.core.synthetic import grid_stack

    shape = (32, 64, 256)
    st = LabeledStack.from_array(grid_stack(shape, (2, 2, 1)), background=None, device=dev)
    n = 16 * 32 * 256
    assert st.n_labels == n
    assert engine.block_capacity(32, dev, "cuda") == bs.max_dict_size() < 2848
    with pytest.raises(RuntimeError, match='engine="chunked"'):
        engine.analyze_stack(st, engine="cuda")
    before, engine.reroutes = block_sweep.launches, 0
    with pytest.warns(UserWarning, match='holds 4096 labels or more.*engine="chunked"'):
        got = engine.analyze_stack(st)
    assert engine.reroutes == 1 and block_sweep.launches == before
    _assert_tables_equal(engine.analyze_stack(st, engine="chunked"), got)
    assert got.n_labels == n and np.all(got.count == 4)
    assert got.n_pairs == 15 * 32 * 256 + 16 * 31 * 256 + 16 * 32 * 255
    faces = got.wall_face_counts
    assert np.all((faces > 0).sum(axis=1) == 1) and set(faces.max(axis=1)) == {2, 4}

    st2 = LabeledStack.from_array(grid_stack(shape, (2, 2, 2)), background=None, device=dev)
    assert st2.n_labels == 32 * 2048
    for name in ("cuda", "auto"):
        with pytest.raises(RuntimeError, match='largest this engine takes.*engine="chunked"'):
            engine.analyze_stack(st2, engine=name)
    assert engine.reroutes == 1
    assert np.all(engine.analyze_stack(st2, engine="chunked").count == 8)

    # 512 labels a block: inside the capacity, so "auto" is the kernel engine
    st4 = LabeledStack.from_array(grid_stack(shape, (2, 4, 4)), background=None, device=dev)
    engine._GOOD_L.clear()
    real = bs._faces_buffer

    def small_device(B, L, block, d):
        if L >= 256:
            raise ValueError(f"the face counts at L={L} need {B * L * 3 * L * 4:,} bytes")
        return real(B, L, block, d)

    monkeypatch.setattr(bs, "_faces_buffer", small_device)
    for name in ("cuda", "auto"):
        with pytest.raises(ValueError, match="L=256 need"):
            engine.analyze_stack(st4, engine=name)
    assert engine.reroutes == 1
