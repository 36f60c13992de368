"""Per-block sweep rows → per-label moments and the sorted wall-pair table.

Plain PyTorch on the device of its inputs; the counterpart of the XLA stages
after the TPU kernel in ``tissue_analysis_tpu/ops/blocked.py``
(``_global_moment_combine``, ``_compact_pair_mats``, ``_sorted_pair_reduce``,
``assemble_pairs``). int64 moments and int64 pair keys need none of the
reference's split columns, two-key sorts or fixed-size buffers.
:func:`shift_moments` and :func:`sum_by_key` move a slab's tables to its
global offset and merge pair tables, the sharded engine's counterparts of
the reference's in-kernel z offset and ``_sorted_pair_reduce_keys``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tissue_analysis_tpu_torch.ops.block_sweep import IMAX

__all__ = ["combine_moments", "reduce_pairs", "sum_by_key", "shift_moments", "decode_pairs"]


def combine_moments(
    ids: torch.Tensor, mom: torch.Tensor, gmin: torch.Tensor,
    gmax: torch.Tensor, n: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Segment-combine (block, slot) rows into per-label tables.

    Returns (moments int64 [n, 10], cmin int32 [n, 3], cmax int32 [n, 3]);
    labels with no voxel keep cmin = IMAX, cmax = -1."""
    seg = torch.where(ids == IMAX, n, ids).reshape(-1).to(torch.int64)
    dev = ids.device
    table = torch.zeros((n + 1, 10), dtype=torch.int64, device=dev)
    table.index_add_(0, seg, mom.reshape(-1, 10))
    seg3 = seg[:, None].expand(-1, 3)
    cmin = torch.full((n + 1, 3), IMAX, dtype=torch.int32, device=dev)
    cmin.scatter_reduce_(0, seg3, gmin.reshape(-1, 3), "amin")
    cmax = torch.full((n + 1, 3), -1, dtype=torch.int32, device=dev)
    cmax.scatter_reduce_(0, seg3, gmax.reshape(-1, 3), "amax")
    return table[:n], cmin[:n], cmax[:n]


def reduce_pairs(
    ids: torch.Tensor, faces: torch.Tensor, n: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nonzero face entries → (sorted unique keys, totals), int64 each.

    key = lo·4n + hi·4 + axis for the label pair lo < hi < n and the face
    axis; totals sum the entries of equal keys across blocks."""
    L = ids.shape[1]
    b, s, c = torch.nonzero(faces, as_tuple=True)
    cnt = faces[b, s, c].to(torch.int64)
    axis = torch.div(c, L, rounding_mode="floor")
    ga = ids[b, s].to(torch.int64)
    gb = ids[b, c % L].to(torch.int64)
    lo = torch.minimum(ga, gb)
    hi = torch.maximum(ga, gb)
    ok = (hi < n) & (lo != hi)
    return sum_by_key((lo * (4 * n) + hi * 4 + axis)[ok], cnt[ok])


def sum_by_key(
    key: torch.Tensor, count: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 keys and counts → (sorted unique keys, the sum of the counts
    of each), on the device of ``key``."""
    ukey, inv = torch.unique(key, sorted=True, return_inverse=True)
    total = torch.zeros(ukey.shape[0], dtype=torch.int64, device=key.device)
    total.index_add_(0, inv, count)
    return ukey, total


def shift_moments(
    mom: torch.Tensor, cmin: torch.Tensor, cmax: torch.Tensor, d: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-label tables of a slab (``engine.Finished`` layout, 2 or 3 axes)
    moved by ``d`` along axis 0 (z; y for a 2D image), exactly in int64:
    Σ(a+d) = Σa + d·count, Σ(a+d)² = Σa² + 2d·Σa + d²·count and
    Σ(a+d)b = Σab + d·Σb, all from the slab's own sums. The bbox moves
    where count > 0; absent rows keep IMAX / -1. Returns new tensors."""
    nd = cmin.shape[1]
    count = mom[:, 0]
    out = mom.clone()
    # s2 starts at column 1 + nd with (0,0), (0,1), .., (0,nd-1)
    out[:, 1 + nd] += 2 * d * mom[:, 1] + d * d * count
    out[:, 2 + nd:1 + 2 * nd] += d * mom[:, 2:1 + nd]
    out[:, 1] += d * count
    step = torch.where(count > 0, d, 0).to(cmin.dtype)
    cmin, cmax = cmin.clone(), cmax.clone()
    cmin[:, 0] += step
    cmax[:, 0] += step
    return out, cmin, cmax


def decode_pairs(
    key: np.ndarray, total: np.ndarray, n: int, axes: int = 3
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host decode of :func:`reduce_pairs` → (pair_lo int32, pair_hi int32,
    wall_face_counts int64 [E, axes]), pairs in ascending (lo, hi) order."""
    key = np.asarray(key, dtype=np.int64)
    n4 = np.int64(4 * n)
    lo = key // n4
    rest = key % n4
    hi = rest >> 2
    ax = rest & 3
    gk = (lo << 32) | hi
    m = gk.shape[0]
    # keys are unique and ascending, so (lo, hi) runs are contiguous
    starts = np.empty(m, dtype=bool)
    if m:
        starts[0] = True
        np.not_equal(gk[1:], gk[:-1], out=starts[1:])
    inv = np.cumsum(starts) - 1
    uniq = gk[starts]
    counts3 = np.zeros((uniq.shape[0], axes), dtype=np.int64)
    counts3[inv, ax] = np.asarray(total, dtype=np.int64)
    return (
        (uniq >> 32).astype(np.int32),
        (uniq & 0xFFFFFFFF).astype(np.int32),
        counts3,
    )
