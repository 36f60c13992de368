"""The comparison that decides ``correct``.

Each table a pass returned is held against the reference's table of its
frame (:mod:`perfbench.reference`). The integer fields are exact and
compared exactly; the features users read in float64 are compared by their
largest relative gap. Each number compared has a limit
(``limits.json``):

- ``passes_wrong``: passes whose table differs from the reference in any
  integer field, its shape or its background segment;
- ``label_rows_wrong``: over all passes, labels whose id, count, Σ, Σ of
  products, bounding box or margin flag differ;
- ``pair_rows_wrong``: over all passes, wall pairs missing on one side, or
  with another face count along some axis;
- ``l1_margin_wrong``: labels in one side's L1 layer or margin only, as the
  table's own ``l1_labels()`` and ``margin_labels()`` give them;
- ``feature_gap``: the largest gap of volume, barycenter and wall area,
  each over the larger of the reference's magnitude there and its median
  magnitude;
- ``inertia_gap``: the largest gap of the table's ``inertia_axes()``: its
  eigenvalues against the reference's, the covariance its axes and
  eigenvalues rebuild against the reference's covariance, and its axes'
  departure from orthonormal, each over the largest eigenvalue of the label.

The features are read from the first and the last table of each frame; the
integer fields of every table are compared.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from perfbench import reference

__all__ = ["judge", "same_integers", "INT_FIELDS"]

INT_FIELDS = ("ids", "count", "s1", "s2", "cmin", "cmax", "margin")
PAIR_FIELDS = ("pair_lo", "pair_hi", "wall_face_counts")


def same_integers(a, b) -> bool:
    """Whether tables ``a`` and ``b`` agree in shape, background segment and
    every integer field: cheap enough to run after each pass of a window."""
    return (tuple(a.shape) == tuple(b.shape)
            and a.background_segment == b.background_segment
            and all(np.array_equal(getattr(a, k), getattr(b, k))
                    for k in INT_FIELDS + PAIR_FIELDS))


def _label_rows_wrong(t, r) -> int:
    n_t, n_r = int(np.asarray(t.ids).shape[0]), int(r.ids.shape[0])
    if n_t != n_r:
        return max(n_t, n_r)
    bad = np.zeros(n_r, dtype=bool)
    for f in INT_FIELDS:
        a, b = np.asarray(getattr(t, f)), getattr(r, f)
        if a.shape != b.shape:
            return n_r
        d = a != b
        bad |= d.reshape(n_r, -1).any(axis=1)
    return int(bad.sum())


def _pair_rows_wrong(t, r, n: int) -> int:
    kt = np.asarray(t.pair_lo, dtype=np.int64) * n + np.asarray(t.pair_hi, dtype=np.int64)
    kr = r.pair_lo * n + r.pair_hi
    ct = np.asarray(t.wall_face_counts)
    if ct.ndim != 2 or ct.shape[0] != kt.shape[0] or ct.shape[1] != 3:
        return max(kt.shape[0], kr.shape[0])
    common, it, ir = np.intersect1d(kt, kr, assume_unique=False, return_indices=True)
    only = (kt.shape[0] - common.shape[0]) + (kr.shape[0] - common.shape[0])
    differ = int((ct[it] != r.wall_face_counts[ir]).any(axis=1).sum())
    return int(only + differ)


def _rel_gap(p, r) -> float:
    p, r = np.asarray(p, dtype=np.float64), np.asarray(r, dtype=np.float64)
    if p.shape != r.shape:
        return float("inf")
    if r.size == 0:
        return 0.0
    mag = np.abs(r)
    floor = max(float(np.median(mag)), np.finfo(np.float64).tiny)
    gap = np.abs(p - r) / np.maximum(mag, floor)
    return float(np.nan_to_num(gap, nan=np.inf).max())


def _inertia_gap(t, ref_feat, ok) -> float:
    evals, evecs = t.inertia_axes()
    evals, evecs = np.asarray(evals)[ok], np.asarray(evecs)[ok]
    w_r, cov_r = ref_feat["eigenvalues"][ok], ref_feat["covariance"][ok]
    if evals.shape != w_r.shape or evecs.shape != cov_r.shape:
        return float("inf")
    scale = np.maximum(np.abs(w_r).max(axis=1), np.finfo(np.float64).tiny)
    # rows of evecs are the axes: cov = Σ_a w_a v_a v_aᵀ; a table far off
    # may hold inf or NaN here, which reads as an infinite gap
    with np.errstate(invalid="ignore", over="ignore"):
        rebuilt = np.einsum("na,nai,naj->nij", evals, evecs, evecs)
        gaps = [
            np.abs(evals - w_r).max(axis=1),
            np.abs(rebuilt - cov_r).max(axis=(1, 2)),
            np.abs(np.einsum("nai,nbi->nab", evecs, evecs) - np.eye(3)[None]).max(axis=(1, 2))
            * scale,
        ]
        gap = np.max(np.stack(gaps, 1), axis=1) / scale
    return float(np.nan_to_num(gap, nan=np.inf).max()) if gap.size else 0.0


def _feature_gaps(t, r, ref_feat) -> Tuple[float, float, int]:
    if np.asarray(t.ids).shape != r.ids.shape or not np.array_equal(t.ids, r.ids):
        return float("inf"), float("inf"), max(len(t.ids), len(r.ids))
    gap = max(
        _rel_gap(t.volume(), ref_feat["volume"]),
        _rel_gap(t.barycenter(), ref_feat["barycenter"]),
        _rel_gap(t.wall_areas(), ref_feat["wall_areas"]),
    )
    ok = r.count > 0
    igap = _inertia_gap(t, ref_feat, ok)
    lm = (np.setxor1d(t.l1_labels(), ref_feat["l1_labels"]).size
          + np.setxor1d(t.margin_labels(), ref_feat["margin_labels"]).size)
    return gap, igap, int(lm)


def judge(tables: Sequence[Tuple[int, object]], refs: List[reference.RefTable],
          limits: Dict[str, float]) -> Tuple[Dict[str, Tuple[float, float]], int]:
    """({number: (value, limit)}, passes wrong) of ``tables``, a list of
    (frame, table) in the order the passes ran, against ``refs[frame]``."""
    passes_wrong = label_rows = pair_rows = lm_wrong = 0
    fgap = igap = 0.0
    feats = [reference.features(r) for r in refs]
    sample = {}
    for i, (f, _) in enumerate(tables):
        sample.setdefault(f, set()).add(i)
    firsts = {min(v) for v in sample.values()} | {max(v) for v in sample.values()}
    for i, (f, t) in enumerate(tables):
        r = refs[f]
        if not same_integers(t, r):
            lr = _label_rows_wrong(t, r)
            pr = _pair_rows_wrong(t, r, max(r.ids.shape[0], 1))
            passes_wrong += 1
            label_rows += lr
            pair_rows += pr
        if i in firsts:
            g, ig, lm = _feature_gaps(t, r, feats[f])
            fgap, igap, lm_wrong = max(fgap, g), max(igap, ig), lm_wrong + lm
    values = {
        "passes_wrong": passes_wrong,
        "label_rows_wrong": label_rows,
        "pair_rows_wrong": pair_rows,
        "l1_margin_wrong": lm_wrong,
        "feature_gap": fgap,
        "inertia_gap": igap,
    }
    return {k: (v, limits[k]) for k, v in values.items()}, passes_wrong
