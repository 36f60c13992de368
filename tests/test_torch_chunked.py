"""The port's flat engine vs the JAX package's chunked engine, on the CPU.

The same seeded numpy images go through ``tissue_analysis_tpu`` (``ops/segred``,
``ops/stencil::pair_sweep``, ``engine.analyze_stack_chunked``,
``parallel.analyze_sharded_chunked`` on conftest's CPU mesh) and through
their counterparts in ``tissue_analysis_tpu_torch`` with ``device="cpu"``.
Every value is an integer or a boolean: equality is exact (atol 0), dtype
included. The capacity route (``engine="auto"`` giving a stack to the flat
engine, before any sweep, when its labels a block are past what the block
engine takes) is held against the JAX chunked table too.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import assert_tables_equal  # noqa: E402

import tissue_analysis_tpu.engine as jax_engine  # noqa: E402
from tissue_analysis_tpu.core.stack import LabeledStack as JaxStack  # noqa: E402
from tissue_analysis_tpu.core.synthetic import voronoi_stack  # noqa: E402
from tissue_analysis_tpu.ops import segred as jax_segred  # noqa: E402
from tissue_analysis_tpu.ops import stencil as jax_stencil  # noqa: E402
from tissue_analysis_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from tissue_analysis_tpu.parallel import sharded as jax_sharded  # noqa: E402
import tissue_analysis_tpu_torch as P  # noqa: E402
from tissue_analysis_tpu_torch import engine, streaming  # noqa: E402
from tissue_analysis_tpu_torch.core.stack import LabeledStack  # noqa: E402
from tissue_analysis_tpu_torch.features.finalize import tri_pairs  # noqa: E402
from tissue_analysis_tpu_torch.ops import block_sweep as bs  # noqa: E402
from tissue_analysis_tpu_torch.ops import combine, segred, stencil  # noqa: E402
from tissue_analysis_tpu_torch.parallel import (  # noqa: E402
    analyze_sharded,
    analyze_sharded_chunked,
    make_mesh,
    sharded_pipeline,
)
from tissue_analysis_tpu_torch.parallel import sharded as port_sharded  # noqa: E402
from tissue_analysis_tpu_torch.utils import timing  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these stacks are small, and the suite's workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# name -> (shape, cells, seed, voxelsize)
IMAGES = {
    "3d": ((20, 33, 70), 40, 1, (2.0, 0.5, 0.5)),
    "2d": ((150, 80), 30, 6, (0.5, 2.0)),
}
# background label: present, none, absent from the image
BACKGROUNDS = {"bg1": 1, "bgNone": None, "bgAbsent": 99999}
DISTINCT = {"2d-128x128": (128, 128), "3d-8x16x128": (8, 16, 128)}


@pytest.fixture(scope="module")
def images():
    return {k: voronoi_stack(s, c, seed=seed, voxelsize=vs)
            for k, (s, c, seed, vs) in IMAGES.items()}


@pytest.fixture(scope="module")
def stacks(images):
    """(JAX stack, port stack) of every image and background."""
    cache = {}

    def get(name, bg):
        if (name, bg) not in cache:
            img = images[name]
            cache[name, bg] = (
                JaxStack.from_array(img, voxelsize=img.voxelsize, background=BACKGROUNDS[bg]),
                LabeledStack.from_array(img, voxelsize=img.voxelsize,
                                        background=BACKGROUNDS[bg], device="cpu"),
            )
        return cache[name, bg]

    return get


@pytest.fixture(scope="module")
def jax_tables(stacks):
    cache = {}

    def get(name, bg):
        if (name, bg) not in cache:
            cache[name, bg] = jax_engine.analyze_stack_chunked(stacks(name, bg)[0])
        return cache[name, bg]

    return get


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ modules
@pytest.mark.parametrize("chunk", [1000, 37])
@pytest.mark.parametrize("name", list(IMAGES))
def test_moment_sweep_equals_jax(stacks, name, chunk):
    """``moment_sweep`` + ``combine_moment_partials`` of the reference
    against the port's one int64 table (whole stack, and two slabs swept at
    their flat offsets and merged)."""
    js, ps = stacks(name, "bg1")
    n, d = js.n_labels, js.ndim
    ref = jax_segred.combine_moment_partials(
        *(np.asarray(t) for t in jax_segred.moment_sweep(js.dense, n, 1000)), js.shape
    )
    whole = segred.moment_sweep(ps.dense, n, chunk)
    cut = ps.shape[0] // 3
    plane = int(np.prod(ps.shape[1:]))
    slabs = segred.combine_moment_partials([
        segred.moment_sweep(ps.dense[:cut], n, 777, 0, ps.shape),
        segred.moment_sweep(ps.dense[cut:], n, None, cut * plane, ps.shape),
    ])
    for mom, cmin, cmax in (whole, slabs):
        assert (mom.dtype, cmin.dtype, cmax.dtype) == (torch.int64, torch.int32, torch.int32)
        assert mom.shape == (n, segred.feature_count(d))
        mom = mom.numpy()
        _same(ref["count"], mom[:, 0])
        _same(ref["s1"], mom[:, 1:1 + d])
        _same(ref["s2"], mom[:, 1 + d:])
        empty = mom[:, 0] == 0
        # absent labels: IMAX / -1 on the device, the 0 / 0 of the table later
        assert (cmin.numpy()[empty] == bs.IMAX).all() and (cmax.numpy()[empty] == -1).all()
        _same(ref["cmin"], np.where(empty[:, None], 0, cmin.numpy()).astype(np.int64))
        _same(ref["cmax"], np.where(empty[:, None], 0, cmax.numpy()).astype(np.int64))


def test_moment_runs_agree_with_numpy_on_every_chunk_cut():
    """The closed-form sums a run against one numpy row a voxel, wherever a
    chunk cuts an x-row or a run; pad labels (n) and labels outside the
    table are dropped."""
    rng = np.random.default_rng(0)
    lab = rng.integers(0, 6, (5, 7, 11)).repeat(3, axis=2).astype(np.int32)
    lab[0, 0, :5] = 6  # the pad segment of n = 6
    lab[1, 2, 3] = -1
    c = np.stack(np.indices(lab.shape), axis=-1).reshape(-1, 3).astype(np.int64)
    feats = np.concatenate(
        [np.ones((lab.size, 1), np.int64), c]
        + [c[:, i:i + 1] * c[:, j:j + 1] for i, j in tri_pairs(3)], axis=1)
    keep = (lab.reshape(-1) >= 0) & (lab.reshape(-1) < 6)
    seg = lab.reshape(-1)[keep]
    mom = np.zeros((6, 10), np.int64)
    np.add.at(mom, seg, feats[keep])
    cmin, cmax = np.full((6, 3), bs.IMAX, np.int32), np.full((6, 3), -1, np.int32)
    np.minimum.at(cmin, seg, c[keep].astype(np.int32))
    np.maximum.at(cmax, seg, c[keep].astype(np.int32))
    assert int(mom[:, 0].sum()) == lab.size - 6
    for chunk in (1, 2, 33, 34, 100, lab.size):
        got = segred.moment_sweep(torch.from_numpy(lab), 6, chunk)
        for x, y in zip((mom, cmin, cmax), got):
            _same(x, y.numpy())


def test_segred_helpers():
    assert [segred.feature_count(d) for d in (2, 3)] == [6, 10]
    assert segred.pick_chunk((512, 512, 512)) == segred.DEFAULT_CHUNK == 1 << 24
    assert segred.pick_chunk((10, 10)) == 100
    dense = torch.arange(10, dtype=torch.int32).reshape(2, 5).to(torch.uint16)
    got = segred.pad_flat(dense, 10, 4)
    _same(np.asarray(jax_segred.pad_flat(np.arange(10, dtype=np.int32).reshape(2, 5), 10, 4)),
          got.numpy())
    assert segred.pad_flat(dense, 10, 5).shape == (10,)
    with pytest.raises(ValueError, match="chunk"):
        segred.moment_sweep(dense, 10, 0)
    with pytest.raises(ValueError, match="shape"):
        segred.moment_sweep(dense, 10, shape=(2, 5, 1))
    with pytest.raises(ValueError, match="x extents"):
        segred.moment_chunks(dense.reshape(-1), 0, (1, (1 << 20) + 1), 10, 4)


@pytest.mark.parametrize("name", list(IMAGES))
def test_pair_sweep_equals_jax(stacks, name):
    """The reference's compacted COO and margin against the port's decoded
    ``pkey`` / ``ptotal`` (host and device decode) and ``margin_presence``."""
    js, ps = stacks(name, "bg1")
    n, d = js.n_labels, js.ndim
    lo, hi, counts, n_pairs, margin = jax_stencil.pair_sweep(
        js.dense, n, jax_stencil.default_max_pairs(n), 1000
    )
    e = int(n_pairs)
    lo, hi = np.asarray(lo)[:e], np.asarray(hi)[:e]
    counts = np.asarray(counts)[:e].astype(np.int64)
    for chunk in (1000, None):
        pkey, ptotal = stencil.pair_sweep(ps.dense, n, chunk)
        assert pkey.dtype == ptotal.dtype == torch.int64
        assert bool((pkey[1:] > pkey[:-1]).all())
        got = combine.decode_pairs(pkey.numpy(), ptotal.numpy(), n, d)
        dev = stencil.compact_runs_to_coo(pkey, ptotal, n, d)
        for x, y, z in zip((lo, hi, counts), got, dev):
            _same(x, y)
            _same(x, z.numpy())
    _same(np.asarray(margin), stencil.margin_presence(ps.dense, n).numpy())
    assert stencil.default_max_pairs(n) == jax_stencil.default_max_pairs(n)


def test_key_streams_and_reduce():
    lab = torch.tensor([[0, 0, 1], [2, 5, 1], [2, 2, -1]], dtype=torch.int32)
    # n = 5: label 5 is the pad segment, -1 is outside the table
    keys = stencil.pair_key_streams(lab, 5, ((1, 0), (0, 1)), (0, 1))
    assert keys.dtype == torch.int64
    want = sorted([0 * 20 + 2 * 4 + 0, 0 * 20 + 1 * 4 + 1])  # 0|2 along y, 0|1 along x
    assert sorted(keys.tolist()) == want
    stream = torch.tensor([7, 3, 7, 7, 9, 3, 1], dtype=torch.int64)
    for keys_in in (stream, [stream[:2], stream[2:2], stream[2:]]):
        for chunk in (1, 3, 100):
            k, c = stencil.chunked_key_reduce(keys_in, chunk)
            assert k.tolist() == [1, 3, 7, 9] and c.tolist() == [1, 2, 3, 1]
    k, c = stencil.chunked_key_reduce(stream[:0], 4)
    assert k.numel() == 0 and c.numel() == 0
    with pytest.raises(ValueError, match="chunk"):
        stencil.chunked_key_reduce(stream, 0)
    with pytest.raises(ValueError, match="at least one"):
        stencil.chunked_key_reduce([], 4)
    with pytest.raises(ValueError, match="2D or 3D"):
        stencil.pair_sweep(lab[None, None], 5)


# ------------------------------------------------------------------ engine
@pytest.mark.parametrize("bg", list(BACKGROUNDS))
@pytest.mark.parametrize("name", list(IMAGES))
def test_chunked_engine_equals_jax(stacks, jax_tables, name, bg):
    js, ps = stacks(name, bg)
    ref = jax_tables(name, bg)
    assert_tables_equal(ref, engine.analyze_stack_chunked(ps))
    assert_tables_equal(ref, engine.analyze_stack_chunked(ps, max_pairs=3, chunk=999))
    assert_tables_equal(ref, engine.analyze_stack(ps, engine="chunked"))
    assert_tables_equal(ref, engine.collect_stack(engine.dispatch_stack(ps, "chunked", n_bucket=64)))
    # the block engine's table is the same one, the bbox margin included
    assert_tables_equal(ref, engine.analyze_stack(ps, engine="torch"))


@pytest.mark.parametrize("dtype", ["uint8", "int16", "uint16", "int32", "uint32", "int64"])
@pytest.mark.parametrize("name", list(IMAGES))
def test_chunked_entry_point_dtypes(images, jax_tables, name, dtype):
    """``analyze(engine="chunked")`` from raw labels of every integer width
    (the images hold fewer than 256 labels)."""
    img = np.asarray(images[name])
    assert img.max() < 256
    ref = jax_tables(name, "bg1")
    got = engine.analyze(img.astype(dtype), voxelsize=images[name].voxelsize,
                         background=1, device="cpu", engine="chunked")
    assert_tables_equal(ref, got)


def test_chunked_through_the_other_entry_points(images, jax_tables):
    img = images["3d"]
    ref = jax_tables("3d", "bg1")
    assert_tables_equal(ref, engine.analyze_raw(img, background=1, engine="chunked", device="cpu"))
    a = P.SpatialImageAnalysis(img, background=1, device="cpu",
                               config=P.AnalysisConfig(background=1, engine="chunked"))
    with timing.collect() as t:
        assert_tables_equal(ref, a.table())
    assert {s.name for s in t.stages} >= {"device sweep (flat moments)", "device sweep (flat pairs)"}
    assert not any(s.name == "device sweep (block)" for s in t.stages)
    # streamed: every slab through the flat engine
    with timing.collect() as t:
        got = streaming.analyze_streamed(np.asarray(img), background=1, slab_z=7,
                                         voxelsize=img.voxelsize, engine="chunked", device="cpu")
    assert_tables_equal(ref, got)
    assert sum(s.name == "device sweep (flat pairs)" for s in t.stages) == 3
    assert not any(s.name == "device sweep (block)" for s in t.stages)


def test_reference_engine_names(stacks, jax_tables):
    _, ps = stacks("3d", "bg1")
    ref = jax_tables("3d", "bg1")
    assert_tables_equal(ref, engine.analyze_stack_blocked(ps, n_bucket=128))
    # the kernel engine needs a CUDA stack and never falls back
    for fn in (engine.analyze_stack_pallas, engine.dispatch_stack_pallas):
        with pytest.raises(ValueError, match="cuda"):
            fn(ps)
    assert engine.collect_stack_pallas(engine.dispatch_stack(ps, "torch")).n_pairs == ref.n_pairs
    for fn in (engine.analyze_stack_pallas, engine.dispatch_stack_pallas,
               engine.analyze_stack_blocked):
        with pytest.raises(ValueError, match="cfg=None"):
            fn(ps, cfg=object())
    assert set(jax_engine.__all__) <= set(engine.__all__)
    assert len(jax_engine.__all__) == 8
    assert "chunked" in engine.ENGINES and engine.resolve_engine("chunked") == "chunked"
    for name in jax_engine.__all__:
        assert getattr(P, name) is getattr(engine, name)


@pytest.mark.parametrize("module,port", [
    (jax_segred, segred), (jax_stencil, stencil), (jax_sharded, port_sharded),
])
def test_public_names_have_counterparts(module, port):
    missing = [n for n in module.__all__ if not hasattr(port, n)]
    assert not missing, missing
    assert hasattr(stencil, "margin_presence")


# ------------------------------------------------------------------ sharded
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", list(IMAGES))
def test_sharded_chunked_equals_jax(stacks, jax_tables, name, k):
    js, ps = stacks(name, "bg1")
    ref = jax_sharded.analyze_sharded_chunked(js, mesh=jax_make_mesh(k))
    assert_tables_equal(ref, jax_tables(name, "bg1"))
    mesh = make_mesh(k, device="cpu")
    with timing.collect() as t:
        got = analyze_sharded_chunked(ps, mesh, max_pairs=5, chunk=1234)
    assert_tables_equal(ref, got)
    assert not any(s.name == "device sweep (block)" for s in t.stages)
    assert_tables_equal(ref, analyze_sharded(ps, mesh, engine="chunked"))


def test_sharded_pipeline_partials(stacks):
    """Per-slab partial tables in global coordinates: three slabs of 8, 8
    and 4 planes; a caller's own merge gives the resident tables."""
    _, ps = stacks("3d", "bg1")
    n = ps.n_labels
    parts = sharded_pipeline(ps.dense, n, mesh=make_mesh(3, device="cpu"))
    assert len(parts) == 3 and all(len(p) == 5 for p in parts)
    fin = engine.flat_sweep(ps)
    mom, cmin, cmax = segred.combine_moment_partials([p[:3] for p in parts])
    assert torch.equal(mom, fin.mom) and torch.equal(cmin, fin.cmin) and torch.equal(cmax, fin.cmax)
    # the second slab's bbox starts at its global z
    present = parts[1][0][:, 0] > 0
    assert int(parts[1][1][present, 0].min()) == 8
    pkey, ptotal = combine.sum_by_key(torch.cat([p[3] for p in parts]),
                                      torch.cat([p[4] for p in parts]))
    assert torch.equal(pkey, fin.pkey) and torch.equal(ptotal, fin.ptotal)
    # planes at or past orig_z are not swept (a caller that padded for the reference)
    padded = torch.cat([ps.dense, torch.full((4,) + ps.shape[1:], n, dtype=ps.dense.dtype)])
    again = sharded_pipeline(padded, n, None, None, make_mesh(3, device="cpu"), ps.shape[0])
    assert all(torch.equal(a, b) for p, q in zip(parts, again) for a, b in zip(p, q))
    with pytest.raises(ValueError, match="2D or 3D"):
        sharded_pipeline(ps.dense[None], n, mesh=make_mesh(1, device="cpu"))


# ------------------------------------------------------- the capacity route
def _distinct(shape):
    return np.arange(2, 2 + int(np.prod(shape)), dtype=np.int32).reshape(shape)


@pytest.mark.parametrize("name", list(DISTINCT))
def test_distinct_labels_reroute_to_the_flat_engine(name):
    """16,384 labels in one block: past every dictionary. An explicit block
    engine raises and names the flat engine; ``auto`` warns, counts one
    reroute and returns the JAX chunked table, with no block sweep."""
    img = _distinct(DISTINCT[name])
    ref = jax_engine.analyze_stack_chunked(JaxStack.from_array(img, background=1))
    assert ref.n_labels == 16384
    assert ref.n_pairs == {"2d-128x128": 32512, "3d-8x16x128": 45952}[name]
    with pytest.raises(RuntimeError, match='L=4096.*engine="chunked"'):
        engine.analyze(img, device="cpu", engine="torch")
    engine.reroutes = 0
    with timing.collect() as t:
        with pytest.warns(UserWarning,
                          match=r'holds 16384 labels or more \(16,384 over its 1 blocks\).*L=4096.*bytes.*engine="chunked"'):
            got = engine.analyze(img, device="cpu")
    assert engine.reroutes == 1
    assert not any(s.name == "device sweep (block)" for s in t.stages)
    assert_tables_equal(ref, got)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert_tables_equal(ref, engine.analyze(img, device="cpu", engine="chunked"))
        a = P.SpatialImageAnalysis(img, background=1, device="cpu",
                                   config=P.AnalysisConfig(background=1, engine="chunked"))
        assert a.nb_labels() == 16384
    assert engine.reroutes == 1


def test_ordinary_image_does_not_reroute(stacks, jax_tables):
    engine.reroutes = 0
    for name in IMAGES:
        _, ps = stacks(name, "bg1")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert_tables_equal(jax_tables(name, "bg1"), engine.analyze_stack(ps))
            analyze_sharded(ps, make_mesh(2, device="cpu"))
    assert engine.reroutes == 0


def test_capacity_is_decided_from_sizes_alone(monkeypatch):
    """``block_capacity``: the engine's bound, and on a card the L whose
    face counts fill its memory (here a stand-in card of 80 GiB).
    ``past_capacity`` holds the labels a block against it."""
    assert engine.block_capacity(8192, "cpu", "torch") == bs.PLAIN_MAX_DICT == 4096
    props = type("Props", (), {"total_memory": 80 << 30})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: props)
    assert engine.block_capacity(8, "cuda:0", "torch") == 4096
    for B, cap in ((8192, 934), (2048, 1869)):
        assert engine.block_capacity(B, "cuda:0", "torch") == cap
        assert B * cap * 3 * cap * 4 <= 80 << 30 < B * (cap + 1) * 3 * (cap + 1) * 4
    # dense-grid2 (2048 labels a block) is past it, a 512-cube of 934 a block is not
    why = engine.past_capacity(4_194_304, (256, 256, 512), "cuda:0", "torch")
    assert "(8, 16, 128) block" in why and "holds 2048 labels or more" in why and "L=1869" in why and "103,079,215,104 bytes" in why
    assert engine.past_capacity(8192 * 934, (512, 512, 512), "cuda:0", "torch") is None
    assert engine.past_capacity(8192 * 934 + 1, (512, 512, 512), "cuda:0", "torch") is not None
    # four slabs of 2048 blocks each take L=1869, the whole stack at once 934
    assert engine.past_capacity(8192 * 1000, (512, 512, 512), "cuda:0", "torch",
                                (128, 512, 512)) is None
    assert engine.block_engine("auto", "cpu") == "torch"
    assert engine.block_engine("auto", "cuda:1") == "cuda"
    assert engine.block_engine("chunked", "cuda:1") == "chunked"


def test_label_space_without_voxels_does_not_reroute():
    """A raw id range or a bucketed label space: 20,000 segment ids over one
    block, 10 of them with voxels. Past the capacity by the label space, so
    the labels with voxels are counted, and the block engine takes it."""
    rng = np.random.default_rng(5)
    lut = np.sort(rng.choice(20000, 10, replace=False)).astype(np.int32)
    dense = lut[rng.integers(0, 10, (8, 16, 128))]
    st = LabeledStack.from_numpy(dense, np.arange(20000), (1.0,) * 3, None, device="cpu")
    assert engine.past_capacity(20000, st.shape, "cpu", "torch") is not None
    engine.reroutes = 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with timing.collect() as t:
            got = engine.analyze_stack(st)
    assert engine.reroutes == 0
    assert any(s.name == "device sweep (block)" for s in t.stages)
    assert_tables_equal(engine.analyze_stack_chunked(st), got)


def test_nothing_reroutes_after_a_launch(monkeypatch):
    """One block of 5,462 labels beside an empty one: 2,732 a block, inside
    the capacity, so ``auto`` sweeps by blocks and raises at L=4096 as an
    explicit engine does. A face buffer the device cannot hold, or any other
    failure of a sweep, raises under every engine name too."""
    img = np.ones((8, 16, 256), np.int32)
    img[:, :, :128] = 2 + np.arange(8 * 16 * 128).reshape(8, 16, 128) // 3
    st = LabeledStack.from_array(img, background=1, device="cpu")
    assert st.n_labels == 5463
    engine.reroutes = 0
    with pytest.raises(RuntimeError, match='L=4096.*engine="chunked"'):
        engine.analyze_stack(st)
    assert engine.analyze_stack(st, engine="chunked").n_labels == 5463

    real = bs._faces_buffer

    def small_device(B, L, block, dev):
        if L >= 128:
            raise ValueError(f"the face counts at L={L} need {B * L * 3 * L * 4:,} bytes")
        return real(B, L, block, dev)

    def broken(*a):
        raise RuntimeError("block_sweep kernel launch failed: CUDA error 700")

    for stand_in, exc, match in ((small_device, ValueError, "L=128 need 393,216 bytes"),
                                 (broken, RuntimeError, "launch failed")):
        monkeypatch.setattr(bs, "_faces_buffer", stand_in)
        for name in ("auto", "torch"):
            with pytest.raises(exc, match=match):
                engine.analyze_stack(st, engine=name)
    assert engine.reroutes == 0


def test_sharded_auto_reroutes_whole_and_streamed_sweeps_as_named():
    """Two slabs of one block each, the second of 16,384 labels: 8,192 a
    block. ``analyze_sharded`` under ``auto`` goes to the sharded flat
    engine before any sweep; a streamed slab does not hold every label, so
    ``auto`` sweeps it by blocks and raises, and ``chunked`` answers."""
    img = np.ones((16, 16, 128), np.int32)
    img[8:] = _distinct((8, 16, 128))
    st = LabeledStack.from_array(img, background=1, device="cpu")
    ref = jax_engine.analyze_stack_chunked(JaxStack.from_array(img, background=1))
    engine.reroutes = 0
    with timing.collect() as t:
        with pytest.warns(UserWarning, match='holds 8193 labels or more.*engine="chunked"'):
            got = analyze_sharded(st, make_mesh(2, device="cpu"))
    assert engine.reroutes == 1
    assert not any(s.name == "device sweep (block)" for s in t.stages)
    assert_tables_equal(ref, got)
    with pytest.raises(RuntimeError, match='engine="chunked"'):
        analyze_sharded(st, make_mesh(2, device="cpu"), engine="torch")
    with pytest.raises(RuntimeError, match='L=4096.*engine="chunked"'):
        streaming.analyze_streamed(img, background=1, slab_z=8, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert_tables_equal(ref, streaming.analyze_streamed(
            img, background=1, slab_z=8, device="cpu", engine="chunked"))
    assert engine.reroutes == 1
