"""Port's ``streaming.py`` vs its resident engine and the JAX package's.

A streamed table must equal the resident ``analyze_stack`` table bit for bit
at any ``slab_z`` (dividing the depth or not), for any source. The JAX
``analyze_streamed`` is run on two of the cases only, for time; it is held
against its own resident engines by ``test_streaming.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import assert_tables_equal  # noqa: E402

from tissue_analysis_tpu import streaming as jstreaming  # noqa: E402
from tissue_analysis_tpu_torch import engine  # noqa: E402
from tissue_analysis_tpu_torch import streaming  # noqa: E402
from tissue_analysis_tpu_torch.core.stack import LabeledStack  # noqa: E402
from tissue_analysis_tpu_torch.core.synthetic import voronoi_stack  # noqa: E402
from tissue_analysis_tpu_torch.ops.combine import decode_pairs  # noqa: E402
from tissue_analysis_tpu_torch.ops.seam import seam_pairs  # noqa: E402
from tissue_analysis_tpu_torch.streaming import (  # noqa: E402
    ArraySource,
    TiledSource,
    analyze_streamed,
)
from tissue_analysis_tpu_torch.utils import timing  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these stacks are small, and the suite's workers
    share the cores (several threads each oversubscribe them badly)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stack64():
    return np.asarray(voronoi_stack((64, 64, 64), 90, seed=4))


def _resident(img, **kw):
    return engine.analyze_stack(LabeledStack.from_array(img, background=1, **kw, device="cpu"))


@pytest.fixture(scope="module")
def resident64(stack64):
    return _resident(stack64)


@pytest.mark.parametrize("slab_z", [16, 32, 40, 64, 96])
def test_streamed_equals_resident(stack64, resident64, slab_z):
    # 40 leaves a short last slab; 96 is one slab deeper than the stack
    with timing.collect() as t:
        got = analyze_streamed(stack64, background=1, slab_z=slab_z, device="cpu")
    assert_tables_equal(resident64, got)
    slabs = -(-64 // slab_z)
    assert sum(s.name == "stream: slab read+relabel" for s in t.stages) == slabs
    assert sum(s.name == "stream: z-seam" for s in t.stages) == slabs - 1


@pytest.mark.parametrize("slab_z", [40, 96])
def test_streamed_equals_jax_streamed(stack64, slab_z):
    ref = jstreaming.analyze_streamed(stack64, background=1, slab_z=slab_z, engine="blocked")
    got = analyze_streamed(stack64, background=1, slab_z=slab_z, engine="blocked", device="cpu")
    assert_tables_equal(ref, got)


def test_streamed_memmap(tmp_path, stack64, resident64):
    path = tmp_path / "stack.dat"
    mm = np.memmap(path, dtype=stack64.dtype, mode="w+", shape=stack64.shape)
    mm[:] = stack64
    mm.flush()
    ro = np.memmap(path, dtype=stack64.dtype, mode="r", shape=stack64.shape)
    got = analyze_streamed(ArraySource(ro), background=1, slab_z=32, device="cpu")
    assert_tables_equal(resident64, got)


def test_streamed_anisotropic_voxelsize(stack64):
    vs = (2.0, 0.5, 0.25)
    got = analyze_streamed(stack64, background=1, slab_z=32, voxelsize=vs, device="cpu")
    ref = _resident(stack64, voxelsize=vs)
    assert_tables_equal(ref, got)
    np.testing.assert_array_equal(got.wall_areas(), ref.wall_areas())


@pytest.mark.parametrize("dtype,scale", [(np.int32, 1000), (np.int64, 100000)])
def test_streamed_wide_dtype(stack64, dtype, scale):
    # > 16-bit label values take the searchsorted relabel path
    wide = stack64.astype(dtype) * scale
    wide[stack64 == 1] = 1
    got = analyze_streamed(wide, background=1, slab_z=24, device="cpu")
    assert_tables_equal(_resident(wide), got)


def test_tiled_source_matches_materialized(stack64):
    src = TiledSource(stack64[:32, :32, :32], (2, 1, 2), background=1)
    ref_src = jstreaming.TiledSource(stack64[:32, :32, :32], (2, 1, 2), background=1)
    full = src.read(0, src.shape[0])
    assert full.shape == src.shape and full.dtype == src.dtype
    np.testing.assert_array_equal(full, ref_src.read(0, ref_src.shape[0]))
    np.testing.assert_array_equal(src.read(20, 45), full[20:45])
    got = analyze_streamed(src, background=1, slab_z=16, device="cpu")
    assert_tables_equal(_resident(full), got)


def test_tiled_cell_features_match_base(stack64):
    """Every tile's copy of a base cell that touches no image face has the
    base cell's voxel count and shape (BASELINE.md's scale-up recipe)."""
    base = np.ascontiguousarray(stack64[16:48])
    src = TiledSource(base, (1, 1, 2), background=1)
    t_base = _resident(base)
    t_tiled = analyze_streamed(src, background=1, slab_z=16, device="cpu")
    checked = 0
    for s, l in enumerate(t_base.ids):
        if t_base.margin[s] or l == 1:
            continue
        s2 = t_tiled.segment_of(int(l) + src.stride)
        assert s2 is not None
        assert t_tiled.count[s2] == t_base.count[s]
        np.testing.assert_array_equal(t_tiled.cmin[s2] - t_base.cmin[s], [0, 0, 64])
        np.testing.assert_array_equal(t_tiled.cmax[s2] - t_base.cmax[s], [0, 0, 64])
        checked += 1
    assert checked > 5


def test_label_only_at_the_seam():
    """A label living only in the last plane of one slab and the first of
    the next counts its seam faces once, on axis 0."""
    img = np.full((32, 16, 16), 1, np.uint16)
    img[:, :, 8:] = 2
    img[15:17, 4:8, 4:8] = 3  # z = 15 | 16 straddles the slab_z = 16 seam
    got = analyze_streamed(img, background=1, slab_z=16, device="cpu")
    assert_tables_equal(_resident(img), got)
    s3 = int(np.nonzero(got.ids == 3)[0][0])
    assert got.count[s3] == 32
    # 3's faces with 1: 16 below + 16 above along z, 2·4 on each y side,
    # 2·4 on the low x side (the high x side is label 2)
    pair = (got.pair_lo == 0) & (got.pair_hi == s3)
    np.testing.assert_array_equal(got.wall_face_counts[pair], [[32, 16, 8]])


def test_seam_pairs_closed_form():
    a = torch.tensor([[0, 1, 2, 0], [2, 2, 5, 1]], dtype=torch.int32)
    b = torch.tensor([[1, 1, 0, 1], [3, 2, 4, 0]], dtype=torch.int32)
    key, total = seam_pairs(a, b, 5)  # label 5 is the dropped pad label
    lo, hi, c3 = decode_pairs(key.numpy(), total.numpy(), 5)
    np.testing.assert_array_equal(lo, [0, 0, 2])
    np.testing.assert_array_equal(hi, [1, 2, 3])
    np.testing.assert_array_equal(c3, [[3, 0, 0], [1, 0, 0], [1, 0, 0]])
    lo, hi, _ = decode_pairs(*(t.numpy() for t in seam_pairs(a, b, 6)), 6)
    np.testing.assert_array_equal(hi, [1, 2, 3, 5])  # (4, 5) counts at n = 6
    with pytest.raises(ValueError, match="planes"):
        seam_pairs(a, b[:1], 5)


def test_engine_names(stack64, resident64):
    assert_tables_equal(resident64, analyze_streamed(stack64, background=1, slab_z=32,
                                                     engine="blocked", device="cpu"))
    assert_tables_equal(resident64, analyze_streamed(stack64, background=1, slab_z=32,
                                                     engine="torch", device="cpu"))
    # no fallback: the kernel needs a CUDA device
    for name in ("pallas", "cuda"):
        with pytest.raises(ValueError, match="cuda"):
            analyze_streamed(stack64, background=1, slab_z=32, engine=name, device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        analyze_streamed(stack64, background=1, engine="tpu", device="cpu")


def test_shift_moments_z_uses_local_s1():
    m = {
        "count": np.array([2, 0], np.int64),
        "s1": np.array([[1, 0, 0], [0, 0, 0]], np.int64),  # z = 0, 1
        "s2": np.array([[1, 0, 0, 0, 0, 0], [0] * 6], np.int64),
        "cmin": np.array([[0, 0, 0], [0, 0, 0]], np.int64),
        "cmax": np.array([[1, 0, 0], [0, 0, 0]], np.int64),
    }
    out = streaming._shift_moments_z(m, 10)  # z = 10, 11
    np.testing.assert_array_equal(out["s1"][0], [21, 0, 0])
    assert out["s2"][0, 0] == 10 * 10 + 11 * 11
    np.testing.assert_array_equal(out["cmin"], [[10, 0, 0], [0, 0, 0]])
    np.testing.assert_array_equal(out["cmax"], [[11, 0, 0], [0, 0, 0]])
