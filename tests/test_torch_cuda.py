"""CUDA kernel vs its plain PyTorch version, and the card vs the CPU.

Marked ``cuda``: every test skips without a CUDA device. On a machine with
one (and nvcc), run them without the JAX test configuration::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The plain version is held against the JAX package's kernel on the CPU by
``test_torch_block_sweep.py``; here the kernel must equal the plain version
exactly (``torch.equal``), on every block that did not overflow.
"""

import dataclasses
import warnings

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
    """65,536 labels (int32 stack) through the kernel: 82 labels per block,
    so the named engine's dictionary retries go L 32 → 64 → 128, and
    ``auto`` counts them first and sweeps once at 128. Equal to the plain
    engine."""
    from tissue_analysis_tpu_torch.core.synthetic import grid_stack

    img = grid_stack((256, 256, 512), (8, 8, 8))
    st = LabeledStack.from_array(img, background=None, device=dev)
    assert st.n_labels == 65536 and st.dense.dtype == torch.int32
    key = (st.shape, st.n_labels, (8, 16, 128), 32)
    engine._GOOD_L.pop(key, None)
    before = block_sweep.launches
    engine.analyze_stack(st, engine="cuda")
    assert block_sweep.launches - before == 3 and engine._GOOD_L[key] == 128
    engine._GOOD_L.pop(key)
    before, counts = block_sweep.launches, bs.block_label_counts.launches
    gpu = engine.analyze_stack(st)
    assert block_sweep.launches - before == 1 and engine._GOOD_L[key] == 128
    assert bs.block_label_counts.launches - counts == 1
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
    """65,536 labels (int32); every slab is counted first and swept once,
    at L = 128."""
    from tissue_analysis_tpu_torch.core.synthetic import grid_stack
    from tissue_analysis_tpu_torch.parallel import Mesh

    img = grid_stack((256, 256, 512), (8, 8, 8))
    key = ((64, 256, 512), 65536, (8, 16, 128), 32)
    engine._GOOD_L.pop(key, None)
    launches = _sharded_equals_resident(img, Mesh((torch.device("cuda:0"),) * 4), None)
    assert launches == 4 and engine._GOOD_L[key] == 128


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
    ``auto`` knows from the sizes alone: it launches neither kernel and
    reroutes once to the flat engine. 2048 a block (cells of 2x2x2) are
    inside the bound by that mean while a block's dictionary holds 2848
    with its far-face neighbours: ``cuda`` sweeps and raises, ``auto``
    counts and reroutes with no sweep. A face buffer the card cannot hold
    raises under ``auto`` too: nothing reroutes after a launch."""
    from tissue_analysis_tpu_torch.core.synthetic import grid_stack

    shape = (32, 64, 256)
    st = LabeledStack.from_array(grid_stack(shape, (2, 2, 1)), background=None, device=dev)
    n = 16 * 32 * 256
    assert st.n_labels == n
    assert engine.block_capacity(32, dev, "cuda") == bs.max_dict_size() < 2848
    with pytest.raises(RuntimeError, match='engine="chunked"'):
        engine.analyze_stack(st, engine="cuda")
    before, engine.reroutes = block_sweep.launches, 0
    counts = bs.block_label_counts.launches
    with pytest.warns(UserWarning, match='holds 4096 labels or more.*engine="chunked"'):
        got = engine.analyze_stack(st)
    assert engine.reroutes == 1 and block_sweep.launches == before
    assert bs.block_label_counts.launches == counts
    _assert_tables_equal(engine.analyze_stack(st, engine="chunked"), got)
    assert got.n_labels == n and np.all(got.count == 4)
    assert got.n_pairs == 15 * 32 * 256 + 16 * 31 * 256 + 16 * 32 * 255
    faces = got.wall_face_counts
    assert np.all((faces > 0).sum(axis=1) == 1) and set(faces.max(axis=1)) == {2, 4}

    # 2048 a block (cells of 2x2x2) are inside the bound by the mean while a
    # block's dictionary holds 2848 with its far-face neighbours: the named
    # engine sweeps and raises, "auto" counts and reroutes with no sweep
    st2 = LabeledStack.from_array(grid_stack(shape, (2, 2, 2)), background=None, device=dev)
    assert st2.n_labels == 32 * 2048
    with pytest.raises(RuntimeError, match='largest this engine takes.*engine="chunked"'):
        engine.analyze_stack(st2, engine="cuda")
    before, counts = block_sweep.launches, bs.block_label_counts.launches
    with pytest.warns(UserWarning, match="more than .* dictionary labels.*engine=\"chunked\""):
        got2 = engine.analyze_stack(st2)
    assert engine.reroutes == 2 and block_sweep.launches == before
    assert bs.block_label_counts.launches - counts == 1
    assert np.all(got2.count == 8)

    # 784 dictionary labels a block (cells of 2x4x4): "auto" sweeps once at
    # L = 1024; a face buffer the card cannot hold then raises under "auto"
    # too: nothing reroutes after a launch
    st4 = LabeledStack.from_array(grid_stack(shape, (2, 4, 4)), background=None, device=dev)
    assert int(bs.block_label_counts(st4.dense, st4.n_labels, (8, 16, 128), 4096).max()) == 784
    engine._GOOD_L.clear()
    real = bs._faces_buffer

    def small_device(B, L, block, d):
        if L >= 256:
            raise ValueError(f"the face counts at L={L} need {B * L * 3 * L * 4:,} bytes")
        return real(B, L, block, d)

    monkeypatch.setattr(bs, "_faces_buffer", small_device)
    for name, L in (("cuda", 256), ("auto", 1024)):
        with pytest.raises(ValueError, match=f"L={L} need"):
            engine.analyze_stack(st4, engine=name)
    assert engine.reroutes == 2


# ------------------------------------------------------------ the count kernel
def _count_cases():
    """(dense, n, block) at small shapes: the sweep's adversarial cases,
    Voronoi stacks in both label widths and a 2D lift, ragged edges."""
    out = {name: (lambda make=make: make()[:3]) for name, make in SWEEP_CASES.items()}
    for shape, ncells, dtype, block in (
        ((64, 64, 64), 150, torch.uint16, (8, 16, 128)),
        ((37, 50, 131), 300, torch.int32, (8, 16, 128)),
        ((1, 300, 340), 400, torch.uint16, (1, 128, 128)),
        ((20, 36, 70), 80, torch.int32, (4, 8, 32)),
    ):
        def make(shape=shape, ncells=ncells, dtype=dtype, block=block):
            st = _stack(shape, ncells, 3, "cpu")
            return st.dense.to(dtype).numpy(), st.n_labels, block
        out[f"voronoi-{'x'.join(map(str, shape))}-{dtype}"] = make
    return out


COUNT_CASES = _count_cases()


@pytest.mark.parametrize("name", list(COUNT_CASES))
def test_count_kernel_equals_plain_version(dev, name):
    dense, n, block = COUNT_CASES[name]()
    t = torch.from_numpy(dense).to(dev)
    for cap in (4, 32, max_dict_size()):
        before = bs.block_label_counts.launches
        k = bs.count_block_labels(t, n, block, cap)
        torch.cuda.synchronize()
        assert bs.block_label_counts.launches == before + 1
        r = bs.block_label_counts_reference(t, n, block, cap)
        assert torch.equal(k.counts, r), cap
        assert int(k.largest) == int(r.max()), cap


def test_count_kernel_saturates_past_its_cap(dev):
    """16,384 distinct labels in one block, beside an empty block: the
    dense block's count stops at cap + 1 (it stops inserting past cap)."""
    img = np.zeros((8, 16, 256), np.int32)
    img[:, :, :128] = 1 + np.arange(8 * 16 * 128).reshape(8, 16, 128)
    t = torch.from_numpy(img).to(dev)
    for cap in (1, 100, max_dict_size()):
        k = bs.block_label_counts(t, 16385, (8, 16, 128), cap)
        assert k.tolist() == [cap + 1, 1]
        assert torch.equal(k, bs.block_label_counts_reference(t, 16385, (8, 16, 128), cap))
    with pytest.raises(ValueError, match="shared-memory"):
        bs.block_label_counts(t, 16385, (8, 16, 128), 1 << 20)


def test_dense_block_routes_with_no_sweep_on_the_card(dev):
    """One block of 5,462 labels beside three empty ones (1,366 a block by
    the mean, inside the kernel's bound): ``auto`` counts on the card and
    reroutes the whole stack before any sweep, since routing the one block
    takes more bytes than the flat engine over these 65,536 voxels; with
    the dense block beside 36 empty ones, it routes that block alone, with
    one sweep and no warning. Both equal the flat engine."""
    img = np.ones((8, 16, 512), np.int32)
    img[:, :, :128] = 2 + np.arange(8 * 16 * 128).reshape(8, 16, 128) // 3
    st = LabeledStack.from_array(img, background=1, device=dev)
    engine.reroutes = 0
    before, counts = block_sweep.launches, bs.block_label_counts.launches
    with pytest.warns(UserWarning, match="more than .* dictionary labels"):
        got = engine.analyze_stack(st)
    assert (engine.reroutes, block_sweep.launches - before,
            bs.block_label_counts.launches - counts) == (1, 0, 1)
    _assert_tables_equal(engine.analyze_stack(st, engine="chunked"), got)

    wide = np.ones((8, 16, 128 * 37), np.int32)
    wide[:, :, :128] = img[:, :, :128]
    st = LabeledStack.from_array(wide, background=1, device=dev)
    engine.reroutes = 0
    before, counts = block_sweep.launches, bs.block_label_counts.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        d = engine.dispatch_stack(st)
        got = engine.collect_stack(d)
    assert (engine.reroutes, block_sweep.launches - before,
            bs.block_label_counts.launches - counts) == (0, 1, 1)
    assert d.L == 32 and d.split.tolist() == [[0], [0], [0], [0]]
    _assert_tables_equal(engine.analyze_stack(st, engine="chunked"), got)


@pytest.mark.parametrize("dtype", [torch.uint16, torch.int32])
def test_a_split_with_the_kernel_equals_the_flat_engine(dev, dtype):
    """An overseg-like stack: Voronoi cells with one interior block of
    16,384 labels of one voxel. ``auto`` launches one count and one sweep
    at L=32, routes that block and its z-, y- and x-predecessors to the
    flat engine, and equals it, in both label widths."""
    from tissue_analysis_tpu_torch.utils import timing

    shape = (40, 48, 384)
    img = np.asarray(voronoi_stack(shape, 60, seed=7, sphere=False)).astype(np.int32)
    img[8:16, 16:32, 128:256] = img.max() + 1 + np.arange(8 * 16 * 128).reshape(8, 16, 128)
    st = LabeledStack.from_array(img, background=1, device=dev)
    st = dataclasses.replace(st, dense=st.dense.to(dtype))
    want = engine.analyze_stack(st, engine="chunked")
    engine.reroutes = 0
    before, counts = block_sweep.launches, bs.block_label_counts.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with timing.collect(fence=False) as t:
            d = engine.dispatch_stack(st)
            got = engine.collect_stack(d)
    assert (engine.reroutes, block_sweep.launches - before,
            bs.block_label_counts.launches - counts) == (0, 1, 1)
    # blocks (1, 1, 1), (0, 1, 1), (1, 0, 1) and (1, 1, 0) of a 5 x 3 x 3 grid
    assert d.L == 32 and d.split[0].tolist() == [4, 10, 12, 13]
    assert t.counts[d.pass_id] == {"splits": 1, "split.blocks": 4, "sweeps": 1,
                                   "launches.block_label_count": 1, "launches.block_sweep": 1}
    _assert_tables_equal(want, got)


def _sizes_stack(dtype, kmax, shape=(8, 128, 16384)):
    """One block of every dictionary size 1 .. kmax in turn (runs of equal
    length along each block's flat order), including exactly the listed
    slots (1,024) and one past them: more blocks than the count has CTAs,
    so each CTA's hash is cleared and reused."""
    arr = np.empty(shape, np.int64)
    loc = np.arange(8 * 16 * 128).reshape(8, 16, 128)
    gy, gx = shape[1] // 16, shape[2] // 128
    base = 0
    for b in range(gy * gx):
        k = (1024, 1025)[b - 5] if b in (5, 6) else (b * 389) % kmax + 1
        y, x = divmod(b, gx)
        arr[:, y * 16:(y + 1) * 16, x * 128:(x + 1) * 128] = base + loc * k // (8 * 16 * 128)
        base += k
    return arr.astype(dtype), base


def _count_edge_cases():
    """name -> (dense on the CPU, n, block, the load path it must take)."""
    def voronoi(shape, ncells, dtype):
        st = _stack(shape, ncells, 5, "cpu")
        return st.dense.to(dtype), st.n_labels

    def ragged(dtype):
        return voronoi((13, 37, 300), 60, dtype)

    def zero_live(dtype, x):
        """Labels 1.. and label 0 live but only on the far x face: a
        zero-filled tile voxel read past the ragged edge would add one."""
        d, n = voronoi((13, 37, x), 60, torch.int32)
        d = d + 1
        d[:, :, -1] = 0
        return d.to(dtype), n + 1

    def sizes(dtype, kmax):
        arr, n = _sizes_stack(np.int32, kmax)
        return torch.from_numpy(arr).to(dtype), n

    return {
        "ragged-int32": lambda: (*ragged(torch.int32), (8, 16, 128), "bulk"),
        "ragged-uint16-x296": lambda: (*voronoi((13, 37, 296), 60, torch.uint16), (8, 16, 128), "bulk"),
        "unaligned-x301-uint16": lambda: (*voronoi((13, 37, 301), 60, torch.uint16), (8, 16, 128),
                                          "direct"),
        "zero-live-ragged-int32": lambda: (*zero_live(torch.int32, 300), (8, 16, 128), "bulk"),
        "zero-live-ragged-uint16": lambda: (*zero_live(torch.uint16, 296), (8, 16, 128), "bulk"),
        "zero-live-unaligned-uint16": lambda: (*zero_live(torch.uint16, 301), (8, 16, 128), "direct"),
        "2d-block-1x128x128": lambda: (*voronoi((1, 300, 336), 400, torch.uint16), (1, 128, 128),
                                       "bulk"),
        "sizes-1-2700-int32": lambda: (*sizes(torch.int32, 2700), (8, 16, 128), "bulk"),
        "sizes-1-60-uint16": lambda: (*sizes(torch.uint16, 60), (8, 16, 128), "bulk"),
    }


COUNT_EDGES = _count_edge_cases()


def _assert_count(t, n, block, cap, path):
    before = bs.block_label_counts.launches
    got = bs.count_block_labels(t, n, block, cap)
    torch.cuda.synchronize()
    assert bs.block_label_counts.launches == before + 1
    assert bs.block_label_counts.path == path == bs.count_plan(t, block, cap).path
    want = bs.block_label_counts_reference(t, n, block, cap)
    assert torch.equal(got.counts, want)
    assert int(got.largest) == int(want.max())


@pytest.mark.parametrize("name", list(COUNT_EDGES))
def test_count_kernel_edges(dev, name):
    """The redesign's edges on both load paths: ragged far edges, label 0
    live beside them, a row pitch TMA cannot take, the 2D block, every
    dictionary size from 1 past the cap with hashes reused across blocks.
    Each against the plain count, its largest count and one launch."""
    dense, n, block, path = COUNT_EDGES[name]()
    t = dense.to(dev)
    for cap in (4, max_dict_size()):
        _assert_count(t, n, block, cap, path)


def test_count_kernel_on_slab_views(dev):
    """Slabs of one stack as the streamed and sharded paths cut them: at a
    z offset that is no multiple of the block (bulk: the pointer stays
    16-byte aligned), and a view 4 bytes into the storage (direct)."""
    arr, n = _sizes_stack(np.int32, 700)
    t = torch.from_numpy(arr).to(dev)
    cap = max_dict_size()
    _assert_count(t[3:], n, (8, 16, 128), cap, "bulk")
    _assert_count(t[5:7], n, (8, 16, 128), cap, "bulk")
    flat = t.view(-1)
    view = flat[1:1 + 5 * t.shape[1] * t.shape[2]].view(5, t.shape[1], t.shape[2])
    _assert_count(view, n, (8, 16, 128), cap, "direct")


def test_count_kernel_saturates_on_both_paths(dev):
    """16,384 distinct labels in one block: cap + 1 on the bulk path and on
    the direct path (a row pitch of 257 int32), and the largest count says
    so; repeated launches leave the largest count's workspace at zero."""
    for x in (256, 257):
        img = np.zeros((8, 16, x), np.int32)
        img[:, :, :128] = 1 + np.arange(8 * 16 * 128).reshape(8, 16, 128)
        t = torch.from_numpy(img).to(dev)
        for cap in (1, 100, max_dict_size()):
            want = bs.block_label_counts_reference(t, 16385, (8, 16, 128), cap)
            assert want.tolist() == [cap + 1] + [1] * (want.numel() - 1)
            for _ in range(2):
                got = bs.count_block_labels(t, 16385, (8, 16, 128), cap)
                assert torch.equal(got.counts, want) and int(got.largest) == cap + 1
            assert bs.block_label_counts.path == ("bulk" if x == 256 else "direct")
