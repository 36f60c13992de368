"""The benchmark's plain reference against tables worked out by hand.

CPU only, tiny shapes. Run with ``python -m pytest perfbench/tests``.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from perfbench import frames, reference  # noqa: E402


def _table(img, voxelsize=(1.0, 1.0, 1.0), background=1, slab=3):
    return reference.reference_table(np.asarray(img), voxelsize, background, "cpu", slab=slab)


def _pairs(t):
    return {(int(a), int(b)): tuple(int(c) for c in f)
            for a, b, f in zip(t.pair_lo, t.pair_hi, t.wall_face_counts)}


def test_cube_in_background():
    img = np.ones((6, 7, 8), dtype=np.uint16)
    img[1:4, 2:5, 3:7] = 9  # 3 x 3 x 4 voxels
    t = _table(img, voxelsize=(2.0, 0.5, 0.5))
    assert t.ids.tolist() == [1, 9] and t.background_segment == 0
    zs, ys, xs = np.arange(1, 4), np.arange(2, 5), np.arange(3, 7)
    assert t.count.tolist() == [6 * 7 * 8 - 36, 36]
    assert t.s1[1].tolist() == [12 * zs.sum(), 12 * ys.sum(), 9 * xs.sum()]
    assert t.s2[1].tolist() == [
        12 * (zs**2).sum(), 4 * zs.sum() * ys.sum(), 3 * zs.sum() * xs.sum(),
        12 * (ys**2).sum(), 3 * ys.sum() * xs.sum(), 9 * (xs**2).sum(),
    ]
    assert t.cmin[1].tolist() == [1, 2, 3] and t.cmax[1].tolist() == [3, 4, 6]
    assert t.cmin[0].tolist() == [0, 0, 0] and t.cmax[0].tolist() == [5, 6, 7]
    # each axis: two faces of the box against the background
    assert _pairs(t) == {(0, 1): (2 * 12, 2 * 12, 2 * 9)}
    assert t.margin.tolist() == [True, False]
    f = reference.features(t)
    assert f["volume"][1] == 36 * 0.5
    assert f["barycenter"][1].tolist() == [2 * 2.0, 3 * 0.5, 4.5 * 0.5]
    assert f["l1_labels"].tolist() == [9] and f["margin_labels"].tolist() == [1]
    np.testing.assert_allclose(f["wall_areas"], [24 * 0.25 + 24 * 1.0 + 18 * 1.0])
    # covariance of a box: (n² − 1)/12 along each axis, in physical units
    np.testing.assert_allclose(np.sort(f["eigenvalues"][1]),
                               np.sort([(9 - 1) / 12 * 4.0, (9 - 1) / 12 * 0.25,
                                        (16 - 1) / 12 * 0.25]))


def test_two_slabs():
    img = np.full((4, 3, 5), 2, dtype=np.int32)
    img[2:] = 3
    t = _table(img, background=None, slab=1)
    assert t.ids.tolist() == [2, 3] and t.background_segment is None
    assert t.count.tolist() == [30, 30]
    assert _pairs(t) == {(0, 1): (15, 0, 0)}
    assert t.margin.tolist() == [True, True]
    assert reference.features(t)["l1_labels"].size == 0


def test_grid_3x3x3():
    cell = 2
    lab = np.arange(27).reshape(3, 3, 3) + 10
    img = lab.repeat(cell, 0).repeat(cell, 1).repeat(cell, 2)
    t = _table(img, background=None, slab=4)
    assert t.ids.tolist() == list(range(10, 37))
    assert (t.count == 8).all()
    want = {}
    for z in range(3):
        for y in range(3):
            for x in range(3):
                a = (z * 3 + y) * 3 + x
                for axis, (dz, dy, dx) in enumerate(((1, 0, 0), (0, 1, 0), (0, 0, 1))):
                    if z + dz < 3 and y + dy < 3 and x + dx < 3:
                        b = ((z + dz) * 3 + y + dy) * 3 + x + dx
                        f = [0, 0, 0]
                        f[axis] = cell * cell
                        want[(a, b)] = tuple(f)
    assert _pairs(t) == want
    assert list(_pairs(t)) == sorted(want)  # ascending (lo, hi)
    # only the centre cell touches no face of the array
    assert t.margin.sum() == 26 and not t.margin[13]


def test_background_swapped_into_segment_zero():
    img = np.array([[[0, 3, 5, 3]]], dtype=np.uint16)
    t = _table(img, background=3, slab=1)
    assert t.ids.tolist() == [3, 0, 5] and t.background_segment == 0
    assert t.count.tolist() == [2, 1, 1]
    assert _pairs(t) == {(0, 1): (0, 0, 1), (0, 2): (0, 0, 2)}
    assert _table(img, background=7, slab=1).background_segment is None


def test_slab_size_does_not_change_the_table():
    raw = frames.make_frame({"shape": [20, 24, 28], "ncells": 30, "dtype": "uint16"}, {}, 3, 0, "cpu")
    a, b = _table(raw, slab=1), _table(raw, slab=64)
    for f in ("ids", "count", "s1", "s2", "cmin", "cmax", "pair_lo", "pair_hi",
              "wall_face_counts", "margin"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_float32_sums_lose_exactness():
    img = np.ones((64, 64, 64), dtype=np.uint16)
    img[8:56, 8:56, 8:56] = 2
    exact = _table(img, slab=64)
    low = reference.reference_table(img, (1.0,) * 3, 1, "cpu", slab=64, acc=torch.float32)
    assert not np.array_equal(exact.s2, low.s2)


def test_negative_labels_raise():
    with pytest.raises(ValueError):
        _table(np.full((2, 2, 2), -1, dtype=np.int32))
