"""Flat segment-moment sweep: the moments half of the flat engine.

Counterpart of ``tissue_analysis_tpu/ops/segred.py``. One pass over the
labeled stack in flat (raster) order yields, per label, the voxel count,
Σcoord, Σcoordᵢ·coordⱼ (``features.finalize.tri_pairs`` order) and the
per-axis coordinate min / max, with no per-block dictionary: any number of
labels may meet in any neighbourhood.

The reference accumulates int32 with a hi/lo split of the second moments, a
chunk bound that keeps the sums inside int32, per-chunk partial tables and
an int64 combine on the host. Here the sums are int64 on the device
(``index_add_``), the bbox is int32 (``scatter_reduce_`` amin / amax), and
one table is accumulated over the chunks, so per-voxel temporaries never
exceed one chunk. d = 2 and d = 3 are native: a 2D image is not lifted.

A chunk is cut into runs of one label within one x-row. A run's sums have
closed forms (count = len, Σx = len·(x0 + x1)/2, Σx² by the
square-pyramidal formula, every other coordinate constant over the run), so
one row a run is added, not one a voxel as the reference's
``_chunk_features`` builds them: with a row a voxel every voxel of a large
segment (the background) adds into the same table row, address by address.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from tissue_analysis_tpu_torch.core.stack import widened
from tissue_analysis_tpu_torch.features.finalize import tri_pairs
from tissue_analysis_tpu_torch.ops.block_sweep import IMAX
from tissue_analysis_tpu_torch.utils import timing

__all__ = [
    "moment_sweep",
    "moment_chunks",
    "pad_flat",
    "combine_moment_partials",
    "feature_count",
    "pick_chunk",
    "DEFAULT_CHUNK",
]

#: voxels a chunk. The reference's 2²¹ was an int32 bound; here a chunk only
#: bounds the temporaries (~100 B a voxel at most), and every chunk costs a
#: few host syncs (``nonzero``, ``unique``), so fewer, larger chunks are faster
DEFAULT_CHUNK = 1 << 24
#: x extents up to here keep a run's closed-form Σx² inside int64
_MAX_X = 1 << 20

Moments = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def feature_count(ndim: int) -> int:
    """1 (count) + D (Σcoord) + P (Σ of products): int64 columns, so none of
    the reference's hi/lo pairs."""
    return 1 + ndim + ndim * (ndim + 1) // 2


def pick_chunk(shape: Sequence[int]) -> int:
    """Voxels a chunk: :data:`DEFAULT_CHUNK` or the whole stack. int64 sums
    need none of the reference's overflow bound."""
    return max(1, min(DEFAULT_CHUNK, math.prod(int(s) for s in shape)))


def pad_flat(dense: torch.Tensor, n_labels: int, chunk: int) -> torch.Tensor:
    """Flatten to int32 and pad to a multiple of ``chunk`` with the dropped
    pad-segment value ``n_labels``. :func:`moment_chunks` takes a ragged last
    chunk, so the port's engines never pad; this is for callers that keep
    the reference's fixed-chunk layout."""
    flat = widened(dense).reshape(-1).to(torch.int32)
    pad = -flat.numel() % chunk
    if not pad:
        return flat
    return torch.cat([flat, flat.new_full((pad,), n_labels)])


def _coords(gidx: torch.Tensor, shape) -> list:
    """Per-axis coordinates of global flat indices in a stack of ``shape``."""
    coords, rem = [], gidx
    for d in range(len(shape)):
        stride = math.prod(shape[d + 1:])
        c = torch.div(rem, stride, rounding_mode="floor")
        rem = rem - c * stride
        coords.append(c)
    return coords


def _run_rows(seg: torch.Tensor, g0: int, shape):
    """One row a run of equal labels within an x-row, sums in closed form."""
    k, nd, X = seg.numel(), len(shape), int(shape[-1])
    gidx = g0 + torch.arange(k, dtype=torch.int64, device=seg.device)
    start = gidx % X == 0
    # a Python value set into a card's tensor is copied from the host: a wait
    with timing.wait("segred.run_start"):
        start[0] = True
    start[1:] |= seg[1:] != seg[:-1]
    with timing.wait("segred.nonzero"):
        first = torch.nonzero(start).squeeze(1)
    # the host's k, copied to the device, waits for the device's queue
    with timing.wait("segred.run_end"):
        length = torch.diff(first, append=first.new_tensor([k]))
    c = _coords(gidx[first], shape)
    x0 = c[-1]
    x1 = x0 + length - 1
    sx = (x0 + x1) * length // 2

    def pyramid(m):  # Σ_{x=0}^{m} x², 0 for m = -1
        return m * (m + 1) * (2 * m + 1) // 6

    s1 = [ci * length for ci in c[:-1]] + [sx]
    s2 = []
    for i, j in tri_pairs(nd):
        if j < nd - 1:
            s2.append(c[i] * c[j] * length)
        elif i < nd - 1:
            s2.append(c[i] * sx)
        else:
            s2.append(pyramid(x1) - pyramid(x0 - 1))
    lo = torch.stack(c, dim=1).to(torch.int32)
    hi = torch.stack(c[:-1] + [x1], dim=1).to(torch.int32)
    return seg[first], torch.stack([length] + s1 + s2, dim=1), lo, hi


def moment_chunks(
    flat: torch.Tensor, flat_start: int, shape: Sequence[int], n_labels: int,
    chunk: int,
) -> Moments:
    """Moments of a flat slice of labels, accumulated chunk by chunk.

    ``flat`` is a 1D slice (any length) of the stack of ``shape`` in raster
    order and ``flat_start`` the global flat index of ``flat[0]``: z-slabs
    are contiguous in flat order, so a slab gets its global coordinates with
    no shift afterwards. Labels outside ``0..n_labels-1`` (``n_labels`` is
    the pad segment) are dropped.

    Returns (mom int64 [n, F], cmin int32 [n, D], cmax int32 [n, D]) in the
    layout of ``engine.Finished``; cmin = IMAX and cmax = -1 where a label
    has no voxel in the slice."""
    shape = tuple(int(s) for s in shape)
    if shape[-1] > _MAX_X:
        raise ValueError(f"x extents up to {_MAX_X} are taken, got {shape[-1]}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    n, nd, dev = int(n_labels), len(shape), flat.device
    mom = torch.zeros((n + 1, feature_count(nd)), dtype=torch.int64, device=dev)
    cmin = torch.full((n + 1, nd), IMAX, dtype=torch.int32, device=dev)
    cmax = torch.full((n + 1, nd), -1, dtype=torch.int32, device=dev)
    for s in range(0, flat.numel(), chunk):
        timing.count("flat.chunks")
        seg = widened(flat[s:s + chunk]).to(torch.int64)
        seg = torch.where((seg >= 0) & (seg < n), seg, n)
        seg, feats, lo, hi = _run_rows(seg, int(flat_start) + s, shape)
        mom.index_add_(0, seg, feats)
        idx = seg[:, None].expand(-1, nd)
        cmin.scatter_reduce_(0, idx, lo, "amin")
        cmax.scatter_reduce_(0, idx, hi, "amax")
    return mom[:n], cmin[:n], cmax[:n]


def moment_sweep(
    dense: torch.Tensor, n_labels: int, chunk=None, flat_start: int = 0,
    shape=None,
) -> Moments:
    """Moments of a whole stack, or of a z-slab of the stack of ``shape``
    that starts at global flat index ``flat_start`` (see
    :func:`moment_chunks` for the result)."""
    shape = tuple(dense.shape) if shape is None else tuple(shape)
    if len(shape) != dense.dim():
        raise ValueError(f"shape {shape} does not match a {dense.dim()}D slab")
    if chunk is None:
        chunk = pick_chunk(dense.shape)
    return moment_chunks(dense.reshape(-1), flat_start, shape, n_labels, chunk)


def combine_moment_partials(parts: Sequence[Moments]) -> Moments:
    """Merge per-slab partials in global coordinates (sums add, the bbox
    takes min / max) on the device of the first. The reference combines its
    per-chunk int32 partials on the host; here a slab's chunks are already
    one table, so this merges slabs."""
    dev = parts[0][0].device
    moms, cmins, cmaxs = zip(*[[t.to(dev) for t in p] for p in parts])
    return (
        torch.stack(moms).sum(0),
        torch.stack(cmins).amin(0),
        torch.stack(cmaxs).amax(0),
    )
