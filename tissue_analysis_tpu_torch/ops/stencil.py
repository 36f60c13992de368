"""Shifted-comparison sweeps: the pairs half of the flat engine, and the
box-neighbourhood adjacency (18/26-connectivity) of the facade.

Counterpart of ``tissue_analysis_tpu/ops/stencil.py``. For every axis the
stack is compared with its +1 shift; where two live labels differ, one
voxel face lies between them. The JAX version is XLA glue with (IMAX, IMAX)
sentinels, two int32 sort keys, fixed ``max_pairs`` buffers and a
rerun-larger retry. Here shapes are dynamic and keys are int64:

- :func:`pair_sweep` walks the stack in slabs of about one chunk of voxels,
  turns each slab's faces into keys ``lo·4n + hi·4 + axis``
  (:func:`pair_key_streams`), reduces them with ``torch.unique``
  (:func:`chunked_key_reduce`) and merges the slabs' partial tables once
  (``combine.sum_by_key``). No per-block dictionary: any number of labels
  may meet anywhere. The result is the ``pkey`` / ``ptotal`` of
  ``engine.Finished``, which ``combine.decode_pairs`` reads on the host and
  :func:`compact_runs_to_coo` on the device;
- :func:`margin_presence` marks the labels on the image's faces;
- :func:`adjacency_offsets` reduces each offset's contacts over int64
  ``lo·n + hi`` keys and merges them into one ascending (lo, hi) table.
  Reducing offset by offset keeps the working set at one offset's shifted
  views (a concatenation of all 13 key streams of a 512³ stack would need
  ~14 GB of int64 before the sort).
"""

from __future__ import annotations

import itertools
import math
from typing import Iterable, Optional, Tuple, Union

import torch

from tissue_analysis_tpu_torch.core.stack import widened
from tissue_analysis_tpu_torch.ops.combine import sum_by_key
from tissue_analysis_tpu_torch.ops.segred import DEFAULT_CHUNK
from tissue_analysis_tpu_torch.utils import timing

__all__ = [
    "pair_sweep",
    "adjacency_offsets",
    "connectivity_offsets",
    "default_max_pairs",
    "pair_key_streams",
    "chunked_key_reduce",
    "compact_runs_to_coo",
    "margin_presence",
    "pair_sweep_bytes",
    "PAIR_BYTES",
]

#: device bytes :func:`pair_sweep` holds at least a voxel of a slab, as it
#: makes an axis's keys: the int32 lo and hi, the mask, and three int64
#: terms of the key alive at once
PAIR_BYTES = 4 + 4 + 1 + 3 * 8


def default_max_pairs(n_labels: int) -> int:
    """The reference's default size of its fixed pair buffers. The port's
    pair tables have the size of their content, so nothing here uses it: it
    is kept for callers that pass ``max_pairs`` to an entry point that takes
    the argument for the reference's signature and ignores it."""
    return max(1024, 32 * n_labels)


def connectivity_offsets(ndim: int, connectivity: int):
    """Canonical half-space shift offsets for an ndim cross/box neighborhood.

    connectivity follows ``nd.generate_binary_structure`` semantics: 1 =
    faces only (the reference default), ndim = full box (26-connectivity in
    3D). Each unordered voxel-pair direction appears once (first nonzero
    component positive).
    """
    offs = []
    for off in itertools.product((-1, 0, 1), repeat=ndim):
        if all(o == 0 for o in off):
            continue
        order = sum(abs(o) for o in off)
        if order > connectivity:
            continue
        first = next(o for o in off if o != 0)
        if first < 0:
            continue  # canonical representative of the ± pair
        offs.append(off)
    return tuple(offs)


def _shifted_views(lab: torch.Tensor, off):
    """(a, b) views of ``lab`` with b the neighbour of a at ``off``."""
    sl_a, sl_b = [], []
    for d, o in enumerate(off):
        size = lab.shape[d]
        if o == 1:
            sl_a.append(slice(0, size - 1))
            sl_b.append(slice(1, size))
        elif o == -1:
            sl_a.append(slice(1, size))
            sl_b.append(slice(0, size - 1))
        else:
            sl_a.append(slice(None))
            sl_b.append(slice(None))
    return lab[tuple(sl_a)], lab[tuple(sl_b)]


def adjacency_offsets(dense: torch.Tensor, n_labels: int, offsets):
    """Label-pair contacts for arbitrary shift offsets.

    Returns (pair_lo, pair_hi, counts), int64 tensors on the device of
    ``dense``, in ascending (lo, hi) order: one row per pair of distinct
    labels < ``n_labels`` that touch along any offset, with the number of
    such voxel-pair contacts (diagonal contacts carry no face area: the
    facade's ``min_contact_area`` filter stays face-based).
    """
    n = int(n_labels)
    lab = widened(dense)
    keys, counts = [], []
    for off in offsets:
        a, b = _shifted_views(lab, off)
        valid = (a != b) & (a < n) & (b < n)
        a = a[valid].to(torch.int64)
        b = b[valid].to(torch.int64)
        k, c = torch.unique(
            torch.minimum(a, b) * n + torch.maximum(a, b), return_counts=True
        )
        keys.append(k)
        counts.append(c)
    ukey, total = sum_by_key(torch.cat(keys), torch.cat(counts))
    return ukey // n, ukey % n, total


def pair_key_streams(lab: torch.Tensor, n_labels: int, offsets, tags) -> torch.Tensor:
    """int64 keys ``lo·4n + hi·4 + tag`` of the shifted-comparison entries of
    ``lab`` (a signed integer tensor), one offset after the other.

    An entry is kept where the two labels differ and both are live
    (``0 <= label < n_labels``; pad voxels carry the label n); the rest is
    left out, not marked by a sentinel."""
    n = int(n_labels)
    keys = []
    for off, tag in zip(offsets, tags):
        a, b = _shifted_views(lab, off)
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        valid = (lo != hi) & (lo >= 0) & (hi < n)
        # one masked select (one host sync) an offset, on the finished keys
        key = lo.to(torch.int64) * (4 * n) + hi.to(torch.int64) * 4 + int(tag)
        with timing.wait("stencil.mask"):
            keys.append(key[valid])
    return torch.cat(keys)


def chunked_key_reduce(
    keys: Union[torch.Tensor, Iterable[torch.Tensor]], chunk: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A voxel-scale stream of int64 keys → (sorted unique keys, the number
    of entries of each), int64 each.

    Two levels: every ``chunk``-sized piece is reduced by its own
    ``torch.unique``, then all pieces' tables merge in one
    ``combine.sum_by_key``. ``keys`` is one tensor or an iterable of
    tensors, consumed one at a time, so a caller can make the stream slab by
    slab and never hold all of it."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if isinstance(keys, torch.Tensor):
        keys = (keys,)
    ks, cs = [], []
    for stream in keys:
        # an empty stream still gives its (empty) table, on its device
        for s in range(0, max(stream.numel(), 1), chunk):
            piece = stream[s:s + chunk]
            # the reduction of an empty piece returns without a wait
            with timing.wait("stencil.unique", syncs=int(piece.numel() > 0)):
                k, c = torch.unique(piece, sorted=True, return_counts=True)
            ks.append(k)
            cs.append(c)
    if not ks:
        raise ValueError("chunked_key_reduce needs at least one key tensor")
    if len(ks) == 1:
        return ks[0], cs[0]
    return sum_by_key(torch.cat(ks), torch.cat(cs))


def compact_runs_to_coo(
    key: torch.Tensor, total: torch.Tensor, n_labels: int, ndim: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sorted unique keys and totals → the COO wall table on their device:
    (pair_lo int32 [E], pair_hi int32 [E], counts int64 [E, ndim]), pairs in
    ascending (lo, hi) order. The device-side twin of
    ``combine.decode_pairs``."""
    pair, inv = torch.unique_consecutive(key >> 2, return_inverse=True)
    counts = torch.zeros((pair.numel(), ndim), dtype=torch.int64, device=key.device)
    counts[inv, key & 3] = total
    n = int(n_labels)
    return (pair // n).to(torch.int32), (pair % n).to(torch.int32), counts


def margin_presence(lab: torch.Tensor, n_labels: int) -> torch.Tensor:
    """bool [n]: the label has a voxel on a face of the image."""
    n = int(n_labels)
    planes = []
    for d in range(lab.dim()):
        planes.append(lab.select(d, 0).reshape(-1))
        planes.append(lab.select(d, lab.shape[d] - 1).reshape(-1))
    boundary = widened(torch.cat(planes)).to(torch.int64)
    boundary = boundary[(boundary >= 0) & (boundary < n)]
    present = torch.zeros(n, dtype=torch.bool, device=lab.device)
    present[boundary] = True
    return present


def pair_sweep_bytes(shape, chunk: Optional[int] = None) -> int:
    """The least device bytes :func:`pair_sweep` takes over a stack of
    ``shape`` in slabs of about ``chunk`` voxels: :data:`PAIR_BYTES` a voxel
    of its largest slab. The flat engine takes no fewer."""
    chunk = DEFAULT_CHUNK if chunk is None else int(chunk)
    plane = math.prod(int(s) for s in shape[1:])
    return PAIR_BYTES * min(math.prod(int(s) for s in shape), max(1, chunk // plane) * plane)


def pair_sweep(
    dense: torch.Tensor, n_labels: int, chunk: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Face-adjacency table of a 2D or 3D stack of segment ids: (sorted
    unique keys ``lo·4n + hi·4 + axis``, faces of each), int64 each, the
    ``pkey`` / ``ptotal`` of ``engine.Finished``.

    The stack is walked along axis 0 in slabs of about ``chunk`` voxels
    (default ``segred.DEFAULT_CHUNK``); a slab's faces along axis 0 reach
    one plane into the next slab. Labels outside ``0..n_labels-1`` touch
    nothing."""
    nd = dense.dim()
    if nd not in (2, 3):
        raise ValueError(f"expected a 2D or 3D stack, got shape {tuple(dense.shape)}")
    chunk = DEFAULT_CHUNK if chunk is None else int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    depth = dense.shape[0]
    rows = max(1, chunk // max(1, math.prod(dense.shape[1:])))
    offs = tuple(tuple(int(d == a) for d in range(nd)) for a in range(nd))

    def streams():
        for r0 in range(0, depth, rows):
            lab = widened(dense[r0:r0 + rows + 1])
            body = lab[:rows]
            yield torch.cat([
                pair_key_streams(lab, n_labels, offs[:1], (0,)),
                pair_key_streams(body, n_labels, offs[1:], range(1, nd)),
            ])

    return chunked_key_reduce(streams(), chunk)
