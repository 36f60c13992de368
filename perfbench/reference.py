"""The plain reference: a labeled stack's feature table, worked out again.

Plain PyTorch and NumPy, written from the semantics alone. It imports
nothing of the program and takes nothing the program made: it reads the raw
label array that the benchmark generated and handed to both sides.

What it computes, for a 3D array of raw labels:

- the relabel: the ids that occur, ascending, with the background's id
  swapped into segment 0 (the two segments trade places);
- per segment: the voxel count, Σ of each coordinate, Σ of each product of
  two coordinates (zz, zy, zx, yy, yx, xx), and the bounding box, summed
  over the runs of one segment along x, each in closed form;
- the walls: for each pair of segments lo < hi that touch across a voxel
  face, the number of such faces along z, along y and along x, pairs in
  ascending (lo, hi) order;
- the margin: segments whose bounding box touches a face of the array.

The sums are accumulated in ``acc`` (int64, exact, by default). The
control of the benchmark's check runs this same code with float32 sums,
rounded back to integers afterwards.

:func:`features` derives in float64 what users read from such a table:
volume, barycenter, covariance and its eigenvalues, wall areas, margin and
L1 labels (the segments that touch the background).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["RefTable", "reference_table", "features", "IMAX", "SLAB"]

IMAX = 2**31 - 1
#: z-planes a step of the reference holds (64 reads the same and takes more memory)
SLAB = 32
# second-moment columns: (i, j) coordinate axes, row-major upper triangle
TRI = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


@dataclasses.dataclass
class RefTable:
    ids: np.ndarray  # int64[N], original label of each segment
    shape: Tuple[int, ...]
    voxelsize: Tuple[float, ...]
    background_segment: Optional[int]
    count: np.ndarray  # int64[N]
    s1: np.ndarray  # int64[N, 3]
    s2: np.ndarray  # int64[N, 6]
    cmin: np.ndarray  # int64[N, 3]
    cmax: np.ndarray  # int64[N, 3]
    pair_lo: np.ndarray  # int64[E]
    pair_hi: np.ndarray  # int64[E]
    wall_face_counts: np.ndarray  # int64[E, 3]
    margin: np.ndarray  # bool[N]


def relabel(present: np.ndarray, background: Optional[int]):
    """(ids, background segment) from the sorted ids that occur."""
    ids = np.asarray(present, dtype=np.int64).copy()
    bseg = None
    if background is not None:
        pos = int(np.searchsorted(ids, background))
        if pos < ids.size and ids[pos] == background:
            ids[0], ids[pos] = ids[pos], ids[0]
            bseg = 0
    return ids, bseg


def _sq_sum(k: torch.Tensor) -> torch.Tensor:
    """0² + 1² + ... + k² (0 for k < 0)."""
    return k * (k + 1) * (2 * k + 1) // 6


def _slabs(Z: int, slab: int):
    for z0 in range(0, Z, slab):
        yield z0, min(Z, z0 + slab)


def reference_table(raw, voxelsize, background: Optional[int] = 1,
                    device="cpu", slab: int = SLAB,
                    acc: torch.dtype = torch.int64) -> RefTable:
    """The table of the 3D raw label array ``raw`` (host NumPy array or
    tensor), computed on ``device`` in z-slabs of ``slab`` planes, with sums
    accumulated in ``acc``."""
    dev = torch.device(device)
    raw = torch.as_tensor(np.asarray(raw)) if not torch.is_tensor(raw) else raw
    raw = raw.to(dev)  # one copy of the labels, as they are stored
    if raw.dim() != 3:
        raise ValueError(f"expected a 3D label array, got shape {tuple(raw.shape)}")
    Z, Y, X = (int(s) for s in raw.shape)

    def piece(z0, z1):
        return raw[z0:z1].to(torch.int64)

    # ids that occur
    top = 0
    for z0, z1 in _slabs(Z, slab):
        p = piece(z0, z1)
        if int(p.min()) < 0:
            raise ValueError("negative labels")
        top = max(top, int(p.max()))
    present = torch.zeros(top + 1, dtype=torch.bool, device=dev)
    for z0, z1 in _slabs(Z, slab):
        present |= torch.bincount(piece(z0, z1).reshape(-1), minlength=top + 1) > 0
    ids, bseg = relabel(torch.nonzero(present).reshape(-1).cpu().numpy(), background)
    n = int(ids.size)
    lut = torch.zeros(top + 1, dtype=torch.int64, device=dev)
    lut[torch.as_tensor(ids, device=dev)] = torch.arange(n, device=dev)

    count = torch.zeros(n, dtype=acc, device=dev)
    s1 = [torch.zeros(n, dtype=acc, device=dev) for _ in range(3)]
    s2 = [torch.zeros(n, dtype=acc, device=dev) for _ in TRI]
    cmin = [torch.full((n,), IMAX, dtype=torch.int64, device=dev) for _ in range(3)]
    cmax = [torch.full((n,), -1, dtype=torch.int64, device=dev) for _ in range(3)]
    keys = [[], [], []]
    nums = [[], [], []]
    for z0, z1 in _slabs(Z, slab):
        z_hi = min(Z, z1 + 1)  # one plane past the slab, for z faces
        seg_ext = lut[piece(z0, z_hi)]
        seg = seg_ext[: z1 - z0]
        # moments by runs of one segment along x: a run of length m from x0
        # to x1 in row (z, y) adds m, Σx = m(x0 + x1)/2 and Σx² in closed form
        rows = seg.reshape(-1, X)
        starts = torch.ones_like(rows, dtype=torch.bool)
        starts[:, 1:] = rows[:, 1:] != rows[:, :-1]
        r, x0 = torch.nonzero(starts, as_tuple=True)
        first = r * X + x0
        x1 = torch.cat([first[1:], first.new_full((1,), rows.numel())]) - 1 - r * X
        lab = rows[r, x0]
        m = x1 - x0 + 1
        z = z0 + torch.div(r, Y, rounding_mode="floor")
        y = r % Y
        sx = m * (x0 + x1) // 2
        sxx = _sq_sum(x1) - _sq_sum(x0 - 1)
        count.index_add_(0, lab, m.to(acc))
        for a, v in enumerate((z * m, y * m, sx)):
            s1[a].index_add_(0, lab, v.to(acc))
        for col, v in enumerate((z * z * m, z * y * m, z * sx, y * y * m, y * sx, sxx)):
            s2[col].index_add_(0, lab, v.to(acc))
        for a, (lo, hi) in enumerate(((z, z), (y, y), (x0, x1))):
            cmin[a].scatter_reduce_(0, lab, lo, "amin")
            cmax[a].scatter_reduce_(0, lab, hi, "amax")
        # walls: each voxel against its +1 neighbour along each axis
        for axis, (a, b) in enumerate((
            (seg_ext[:-1], seg_ext[1:]),
            (seg[:, :-1], seg[:, 1:]),
            (seg[:, :, :-1], seg[:, :, 1:]),
        )):
            ne = a != b
            lo = torch.minimum(a, b)[ne]
            hi = torch.maximum(a, b)[ne]
            k, c = torch.unique(lo * n + hi, return_counts=True)
            keys[axis].append(k)
            nums[axis].append(c.to(acc))

    all_keys = torch.unique(torch.cat([k for ks in keys for k in ks]))
    faces = torch.zeros((all_keys.numel(), 3), dtype=acc, device=dev)
    for axis in range(3):
        for k, c in zip(keys[axis], nums[axis]):
            faces[:, axis].index_add_(0, torch.searchsorted(all_keys, k), c)

    def host_int(t):
        if t.dtype.is_floating_point:
            t = torch.round(t.to(torch.float64))
        return t.to(torch.int64).cpu().numpy()

    count_h = host_int(count)
    cmin_h = torch.stack(cmin, 1).cpu().numpy()
    cmax_h = torch.stack(cmax, 1).cpu().numpy()
    empty = count_h == 0
    cmin_h[empty] = 0
    cmax_h[empty] = 0
    edge = np.asarray((Z, Y, X), dtype=np.int64) - 1
    margin = ~empty & ((cmin_h == 0).any(axis=1) | (cmax_h == edge).any(axis=1))
    keys_h = all_keys.cpu().numpy()
    return RefTable(
        ids=ids, shape=(Z, Y, X),
        voxelsize=tuple(float(v) for v in voxelsize),
        background_segment=bseg,
        count=count_h, s1=host_int(torch.stack(s1, 1)),
        s2=host_int(torch.stack(s2, 1)),
        cmin=cmin_h, cmax=cmax_h,
        pair_lo=keys_h // n, pair_hi=keys_h % n,
        wall_face_counts=host_int(faces),
        margin=margin,
    )


def features(t, dtype=np.float64) -> dict:
    """What users read from a table, computed in ``dtype`` (float64 by
    default) from its integer fields (any object with :class:`RefTable`'s
    fields). ``eigenvectors[k, a]`` is the axis of ``eigenvalues[k, a]``,
    largest first."""
    v = np.asarray(t.voxelsize, dtype=dtype)
    count = np.asarray(t.count).astype(dtype)
    s1 = np.asarray(t.s1).astype(dtype)
    s2 = np.asarray(t.s2).astype(dtype)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = s1 / count[:, None]
        m2 = np.zeros((count.size, 3, 3), dtype=dtype)
        for col, (i, j) in enumerate(TRI):
            m2[:, i, j] = m2[:, j, i] = s2[:, col]
        cov = m2 / count[:, None, None] - mean[:, :, None] * mean[:, None, :]
    cov = cov * (v[:, None] * v[None, :])[None]
    ok = count > 0
    evals = np.full((count.size, 3), np.nan, dtype=dtype)
    evecs = np.full((count.size, 3, 3), np.nan, dtype=dtype)
    w, V = np.linalg.eigh(cov[ok])
    evals[ok] = w[:, ::-1]
    evecs[ok] = np.swapaxes(V[:, :, ::-1], 1, 2)
    bseg = t.background_segment
    lo, hi = np.asarray(t.pair_lo), np.asarray(t.pair_hi)
    if bseg is None:
        l1 = np.zeros(0, dtype=np.int64)
    else:
        l1 = np.unique(np.concatenate([hi[lo == bseg], lo[hi == bseg]]))
    ids = np.asarray(t.ids)
    return {
        "volume": count * np.prod(v),
        "barycenter": mean * v[None],
        "covariance": cov,
        "eigenvalues": evals,
        "eigenvectors": evecs,
        "wall_areas": np.asarray(t.wall_face_counts).astype(dtype) @ (np.prod(v) / v),
        "margin_labels": np.sort(ids[np.asarray(t.margin, dtype=bool)]),
        "l1_labels": np.sort(ids[l1]),
    }
