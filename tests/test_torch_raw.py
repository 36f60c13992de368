"""On-device ingest without the host relabel: the port's ``analyze_raw``.

Held against the JAX package's ``analyze_raw`` and against the port's own
relabel path ``analyze`` on the cases of ``tests/test_raw_ingest.py``, plus
raw uint8 / uint16 / int32 / int64 inputs, a raw id space past 2¹⁶ (int32
sweep), and every route to the relabel path. Tolerance: exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tissue_analysis_tpu.core.synthetic import voronoi_stack  # noqa: E402
from tissue_analysis_tpu.engine import analyze_raw as jax_analyze_raw  # noqa: E402
from tissue_analysis_tpu_torch import engine  # noqa: E402
from tissue_analysis_tpu_torch.utils import timing  # noqa: E402

FIELDS = (
    "ids", "count", "s1", "s2", "cmin", "cmax",
    "pair_lo", "pair_hi", "wall_face_counts", "margin",
)


def assert_tables_equal(a, b):
    assert a.shape == b.shape
    assert a.voxelsize == b.voxelsize
    assert a.background_segment == b.background_segment
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _voronoi(dtype):
    return np.asarray(voronoi_stack((32, 40, 48), 60, seed=3)).astype(dtype)


def _sparse_absent_background():
    img = np.zeros((8, 8, 8), dtype=np.int32)
    img[:4] = 3
    img[4:, :4] = 700
    img[4:, 4:] = 65
    return img


def _background_not_smallest():
    img = np.full((8, 8, 8), 5, dtype=np.uint16)
    img[2:6, 2:6, 2:6] = 2
    img[3:5, 3:5, 3:5] = 9
    return img


def _uint8():
    return np.random.default_rng(0).integers(1, 7, size=(10, 12, 14), dtype=np.uint8)


def _past_uint16():
    img = _voronoi(np.int32)
    img[img > 1] += 69000  # raw ids up to ~69060: an int32 sweep
    return img


def _negative():
    img = np.full((6, 6, 6), -1, dtype=np.int32)
    img[:3] = 4
    return img


def _huge_id():
    img = np.full((6, 6, 6), 1, dtype=np.int32)
    img[:3] = 1 << 21  # >= max_raw_id default
    return img


def _two_d():
    return np.random.default_rng(1).integers(1, 9, size=(24, 32), dtype=np.int32)


# name -> (image factory, background, True if the raw sweep runs)
CASES = {
    "voronoi-uint16": (lambda: _voronoi(np.uint16), 1, True),
    "voronoi-int32": (lambda: _voronoi(np.int32), 1, True),
    "voronoi-int64": (lambda: _voronoi(np.int64), 1, True),
    "sparse-absent-background": (_sparse_absent_background, 1, True),
    "background-not-smallest": (_background_not_smallest, 5, True),
    "uint8": (_uint8, 1, True),
    "ids-past-uint16": (_past_uint16, 1, True),
    "negative-labels": (_negative, None, False),
    "huge-id": (_huge_id, 1, False),
    "2d": (_two_d, 1, False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_raw_equals_jax_raw_and_relabel(name):
    make, bg, raw_route = CASES[name]
    img = make()
    with timing.collect() as t:
        port = engine.analyze_raw(img, background=bg, device="cpu")
    names = [s.name for s in t.stages]
    # the route taken: the raw sweep never relabels on the host
    assert ("raw-mode host compaction" in names) == raw_route
    assert ("ingest: dense relabel" in names) != raw_route
    assert_tables_equal(jax_analyze_raw(img, background=bg), port)
    assert_tables_equal(engine.analyze(img, background=bg, device="cpu"), port)


def test_raw_sweep_dtype_follows_id_range(monkeypatch):
    seen = []
    real = engine.analyze_stack

    def recording(stack, **kw):
        seen.append(stack.dense.dtype)
        return real(stack, **kw)

    monkeypatch.setattr(engine, "analyze_stack", recording)
    engine.analyze_raw(_voronoi(np.int64), background=1, device="cpu")
    engine.analyze_raw(_past_uint16(), background=1, device="cpu")
    assert seen == [torch.uint16, torch.int32]


def test_raw_float_dtype_rejected():
    with pytest.raises(TypeError):
        engine.analyze_raw(np.zeros((4, 4, 4), dtype=np.float32), device="cpu")


@pytest.mark.parametrize("dtype", [">u2", ">i4"])
def test_raw_non_native_byte_order(dtype):
    """A byte-swapped array (a big-endian file read as it is): ``analyze_raw``
    takes it through the raw sweep and returns the table ``analyze`` returns,
    in the port and in the JAX package."""
    from tissue_analysis_tpu.engine import analyze as jax_analyze

    img = _voronoi(dtype)
    assert not img.dtype.isnative
    with timing.collect() as t:
        port = engine.analyze_raw(img, background=1, device="cpu")
    assert "raw-mode host compaction" in [s.name for s in t.stages]
    assert_tables_equal(engine.analyze(img, background=1, device="cpu"), port)
    assert_tables_equal(jax_analyze(img, background=1), port)
    assert_tables_equal(
        engine.analyze_raw(img.astype(img.dtype.newbyteorder("=")), background=1,
                           device="cpu"),
        port,
    )


def test_raw_upload_of_a_native_array_is_zero_copy():
    """The byte-order repair costs the common path nothing: a native,
    C-contiguous, writable array is uploaded as the object it is."""
    img = _voronoi(np.uint16)
    assert engine._uploadable(img) is img
    swapped = engine._uploadable(img.astype(">u2"))
    assert swapped.dtype == np.uint16 and swapped.dtype.isnative
    np.testing.assert_array_equal(swapped, img)
    # a strided view still becomes contiguous, as before
    view = img[:, ::2]
    fixed = engine._uploadable(view)
    assert fixed.flags.c_contiguous
    np.testing.assert_array_equal(fixed, view)
