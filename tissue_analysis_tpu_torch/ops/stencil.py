"""Box-neighbourhood adjacency (18/26-connectivity) for the facade.

Counterpart of ``tissue_analysis_tpu/ops/stencil.py``
(``connectivity_offsets``, ``adjacency_offsets``). The JAX version is XLA
glue with fixed ``max_pairs`` buffers and a rerun-larger retry; here shapes
are dynamic, so each offset's contacts are reduced on the stack's device
with ``torch.unique`` over int64 ``lo·n + hi`` keys and merged into one
ascending (lo, hi) table. Reducing offset by offset keeps the working set
at one offset's shifted views (a concatenation of all 13 key streams of a
512³ stack would need ~14 GB of int64 before the sort).
"""

from __future__ import annotations

import itertools

import torch

from tissue_analysis_tpu_torch.core.stack import widened

__all__ = ["connectivity_offsets", "adjacency_offsets"]


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
    key = torch.cat(keys)
    ukey, inv = torch.unique(key, sorted=True, return_inverse=True)
    total = torch.zeros(ukey.shape[0], dtype=torch.int64, device=key.device)
    total.index_add_(0, inv, torch.cat(counts))
    return ukey // n, ukey % n, total
