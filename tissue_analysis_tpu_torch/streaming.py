"""Out-of-core streamed analysis — stacks larger than device memory.

The resident engine holds the whole stack, and the sweep's outputs, on the
device. This module removes that bound: the stack is read, relabeled and
swept as a sequence of z-slabs, and device memory holds about one slab at a
time. The result is bit-identical to the resident
:func:`~tissue_analysis_tpu_torch.engine.analyze_stack` at any ``slab_z``,
dividing the depth or not.

- Label discovery is a separate streaming presence scan (bincount for
  ≤16-bit dtypes, per-slab ``np.unique`` otherwise), so the dense relabel
  table exists before the first voxel reaches the device.
- Each slab runs ``analyze``'s sweep, combine and pair reduce
  (:func:`~tissue_analysis_tpu_torch.engine.dispatch_stack` /
  :func:`~tissue_analysis_tpu_torch.engine.collect_stack`) with slab-local
  z; the global z offset is re-applied on the host in exact int64
  (:func:`_shift_moments_z`).
- The slab's own far z plane reads as the dropped label and counts no
  face. The z-faces between the previous slab's last plane, kept on the
  device, and this slab's first plane are counted by
  :func:`~tissue_analysis_tpu_torch.ops.seam.seam_pairs` (lower-z owner,
  once each, on axis 0).
- Slab k+1 is read, relabeled and dispatched before slab k is collected,
  so the host's work on one slab overlaps the device's on the other.

Sources are anything exposing ``shape``/``dtype``/``read(z0, z1)``:
in-memory arrays, ``np.memmap``, or synthetic generators
(:class:`TiledSource` materializes nothing). Counterpart of
``tissue_analysis_tpu/streaming.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from tissue_analysis_tpu_torch.core.stack import LabeledStack, resolve_device
from tissue_analysis_tpu_torch.engine import (
    _margin_from_bbox,
    block_engine,
    collect_stack,
    dispatch_stack,
    resolve_engine,
)
from tissue_analysis_tpu_torch.features.table import FeatureTable
from tissue_analysis_tpu_torch.ops.combine import decode_pairs
from tissue_analysis_tpu_torch.ops.seam import seam_pairs
from tissue_analysis_tpu_torch.utils import timing

__all__ = [
    "ArraySource",
    "TiledSource",
    "analyze_streamed",
]


# ---------------------------------------------------------------------------
# Slab sources
# ---------------------------------------------------------------------------


class ArraySource:
    """Slab source over a host array (ndarray or np.memmap)."""

    def __init__(self, array, voxelsize: Optional[Tuple[float, ...]] = None):
        self.array = array
        self.shape = tuple(int(s) for s in array.shape)
        self.dtype = array.dtype
        self.voxelsize = voxelsize or getattr(array, "voxelsize", None)

    def read(self, z0: int, z1: int) -> np.ndarray:
        return np.asarray(self.array[z0:z1])


class TiledSource:
    """Synthetic (tz, ty, tx) tiling of a base stack with per-tile label
    offsets — generates any slab on demand, materializing nothing.

    Labels other than the background get ``tile_index * stride`` added, so
    every tile holds distinct cells whose per-cell features must bit-match
    the base stack's (the scale-up validation recipe from BASELINE.md).
    """

    def __init__(self, base: np.ndarray, tiles: Tuple[int, int, int],
                 background: int = 1, stride: Optional[int] = None):
        self.base = np.asarray(base)
        self.tiles = tiles
        self.background = background
        self.stride = int(stride or (int(self.base.max()) + 1))
        self.shape = tuple(
            int(t * s) for t, s in zip(tiles, self.base.shape)
        )
        need = self.stride * (tiles[0] * tiles[1] * tiles[2] + 1)
        self.dtype = np.uint16 if need <= 0xFFFF else np.int32
        self.voxelsize = None

    def read(self, z0: int, z1: int) -> np.ndarray:
        bz, by, bx = self.base.shape
        _, ty, tx = self.tiles
        out = np.empty((z1 - z0, by * ty, bx * tx), dtype=self.dtype)
        for z in range(z0, z1):
            tz, lz = divmod(z, bz)
            plane = self.base[lz].astype(np.int64)
            row = np.concatenate(
                [
                    np.where(
                        plane == self.background,
                        plane,
                        plane + ((tz * ty + iy) * tx + ix) * self.stride,
                    )
                    for iy in range(ty)
                    for ix in range(tx)
                ],
                axis=None,
            ).reshape(ty, tx, by, bx).transpose(0, 2, 1, 3).reshape(
                by * ty, bx * tx
            )
            out[z - z0] = row
        return out


# ---------------------------------------------------------------------------
# Streaming label discovery + relabel LUT
# ---------------------------------------------------------------------------


def _scan_ids(source, slab_z: int, background) -> Tuple[np.ndarray, Optional[int]]:
    """Streaming presence scan → (ids int64[n] in LabeledStack order
    (sorted ascending, background swapped to segment 0), background_segment).
    """
    z = source.shape[0]
    small = np.dtype(source.dtype).itemsize <= 2
    if small:
        present = np.zeros(1 << 16, dtype=bool)
        for z0 in range(0, z, slab_z):
            slab = source.read(z0, min(z0 + slab_z, z))
            counts = np.bincount(slab.reshape(-1), minlength=1 << 16)
            present |= counts > 0
        ids = np.nonzero(present)[0].astype(np.int64)
    else:
        ids = np.zeros(0, dtype=np.int64)
        for z0 in range(0, z, slab_z):
            slab = source.read(z0, min(z0 + slab_z, z))
            ids = np.union1d(ids, np.unique(slab).astype(np.int64))
    background_segment = None
    if background is not None:
        pos = int(np.searchsorted(ids, background))
        if pos < ids.shape[0] and ids[pos] == background:
            if pos != 0:
                ids = ids.copy()
                ids[0], ids[pos] = ids[pos], ids[0]
            background_segment = 0
    return ids, background_segment


def _make_relabel(ids: np.ndarray, dtype) -> "callable":
    """Vectorized original-label → dense-segment mapper honoring the
    background swap encoded in ``ids`` (segment i = ids[i])."""
    n = ids.shape[0]
    out_dtype = np.uint16 if n <= 0xFFFF else np.int32
    if np.dtype(dtype).itemsize <= 2:
        lut = np.zeros(1 << 16, dtype=out_dtype)
        lut[ids] = np.arange(n, dtype=out_dtype)
        return lambda slab: lut[slab]
    order = np.argsort(ids, kind="stable")
    ids_sorted = ids[order]
    seg_of_rank = order.astype(out_dtype)

    def relabel(slab):
        return seg_of_rank[np.searchsorted(ids_sorted, slab)]

    return relabel


# ---------------------------------------------------------------------------
# Host-side exact combine
# ---------------------------------------------------------------------------


def _shift_moments_z(m: dict, z0: int) -> dict:
    """Re-apply the global z offset to slab-local moments, exactly (int64).

    s2 column order is zz, zy, zx, yy, yx, xx (features.finalize.tri_pairs);
    s2 updates use the LOCAL s1, so they run first.
    """
    z0 = np.int64(z0)
    count, s1, s2 = m["count"], m["s1"], m["s2"]
    s2[:, 0] += 2 * z0 * s1[:, 0] + z0 * z0 * count
    s2[:, 1] += z0 * s1[:, 1]
    s2[:, 2] += z0 * s1[:, 2]
    s1[:, 0] += z0 * count
    present = count > 0
    m["cmin"][present, 0] += z0
    m["cmax"][present, 0] += z0
    return m


class _Accumulator:
    """Exact int64 running combine of per-slab moment/pair partials."""

    def __init__(self, n: int):
        self.count = np.zeros(n, np.int64)
        self.s1 = np.zeros((n, 3), np.int64)
        self.s2 = np.zeros((n, 6), np.int64)
        self.cmin = np.full((n, 3), np.iinfo(np.int64).max)
        self.cmax = np.full((n, 3), np.iinfo(np.int64).min)
        self.pair_parts = []

    def add_moments(self, m: dict) -> None:
        self.count += m["count"]
        self.s1 += m["s1"]
        self.s2 += m["s2"]
        present = m["count"] > 0
        self.cmin[present] = np.minimum(self.cmin[present], m["cmin"][present])
        self.cmax[present] = np.maximum(self.cmax[present], m["cmax"][present])

    def add_pairs(self, lo, hi, counts3) -> None:
        self.pair_parts.append((lo, hi, counts3))

    def finish(self, ids, shape, voxelsize, background_segment) -> FeatureTable:
        absent = self.count == 0
        self.cmin[absent] = 0
        self.cmax[absent] = 0
        if self.pair_parts:
            lo = np.concatenate([p[0] for p in self.pair_parts])
            hi = np.concatenate([p[1] for p in self.pair_parts])
            c3 = np.concatenate([p[2] for p in self.pair_parts])
            gk = (lo.astype(np.int64) << 32) | hi.astype(np.int64)
            uniq, inv = np.unique(gk, return_inverse=True)
            counts3 = np.zeros((uniq.shape[0], 3), dtype=np.int64)
            np.add.at(counts3, inv, c3)
            pair_lo = (uniq >> 32).astype(np.int32)
            pair_hi = (uniq & 0xFFFFFFFF).astype(np.int32)
        else:
            pair_lo = np.zeros(0, np.int32)
            pair_hi = np.zeros(0, np.int32)
            counts3 = np.zeros((0, 3), np.int64)
        return FeatureTable(
            ids=ids.copy(),
            shape=shape,
            voxelsize=voxelsize,
            background_segment=background_segment,
            count=self.count,
            s1=self.s1,
            s2=self.s2,
            cmin=self.cmin,
            cmax=self.cmax,
            pair_lo=pair_lo,
            pair_hi=pair_hi,
            wall_face_counts=counts3,
            margin=_margin_from_bbox(self.count, self.cmin, self.cmax, shape),
        )


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def analyze_streamed(
    source,
    background: Optional[int] = 1,
    voxelsize: Optional[Tuple[float, ...]] = None,
    slab_z: Optional[int] = None,
    engine: str = "auto",
    device=None,
) -> FeatureTable:
    """Streamed out-of-core analysis → FeatureTable (bit-identical to
    :func:`engine.analyze_stack` on the same voxels).

    ``source``: a 3D host ndarray / np.memmap, or any object with
    ``shape``/``dtype``/``read(z0, z1)``. ``device`` (default: the current
    CUDA device; ``"cpu"`` for the CPU) holds one ``(slab_z, Y, X)`` slab,
    its sweep's outputs and the previous slab's last plane, whatever the
    stack's depth. ``engine`` takes the
    port's names or the JAX package's (``pallas`` → ``cuda``, ``blocked``
    → ``torch``). ``auto`` sweeps every slab by blocks, as the reference's
    streamed engine does, and raises where a block is past that engine's
    dictionary; ``chunked`` sweeps every slab with the flat engine.
    """
    dev = resolve_device(device)
    engine = block_engine(resolve_engine(engine), dev)
    if isinstance(source, np.ndarray) or (
        hasattr(source, "shape") and not hasattr(source, "read")
    ):
        source = ArraySource(source, voxelsize=voxelsize)
    shape = tuple(int(s) for s in source.shape)
    if len(shape) != 3:
        raise ValueError("analyze_streamed expects a 3D source")
    if voxelsize is None:
        voxelsize = getattr(source, "voxelsize", None) or (1.0,) * 3
    voxelsize = tuple(float(v) for v in voxelsize)
    z = shape[0]
    if slab_z is None:
        slab_z = min(128, -(-z // 8) * 8)
    if slab_z < 1:
        raise ValueError(f"slab_z must be positive, got {slab_z}")

    with timing.stage("stream: presence scan", int(np.prod(shape))):
        ids, background_segment = _scan_ids(source, slab_z, background)
    n = int(ids.shape[0])
    relabel = _make_relabel(ids, source.dtype)
    acc = _Accumulator(n)

    def collect(z0, handle, seam_in, first):
        table = collect_stack(handle)
        # the slab's table is not kept: shift its arrays in place
        m = {f: getattr(table, f) for f in ("count", "s1", "s2", "cmin", "cmax")}
        acc.add_moments(_shift_moments_z(m, z0))
        acc.add_pairs(table.pair_lo, table.pair_hi, table.wall_face_counts)
        if seam_in is not None:
            with timing.stage("stream: z-seam", None, dev):
                key, total = seam_pairs(seam_in, first, n)
                acc.add_pairs(*decode_pairs(key.cpu().numpy(), total.cpu().numpy(), n))

    # software pipeline: slab k+1 is read, relabeled and dispatched before
    # slab k is collected
    pending = None
    prev_last = None
    for z0 in range(0, z, slab_z):
        z1 = min(z0 + slab_z, z)
        with timing.stage("stream: slab read+relabel", (z1 - z0) * shape[1] * shape[2]):
            slab = relabel(source.read(z0, z1))
        stack = LabeledStack.from_numpy(slab, ids, voxelsize, background_segment, dev)
        handle = dispatch_stack(stack, engine)
        if pending is not None:
            collect(*pending)
        # copies of the seam planes: a slab's memory goes once it is collected
        pending = (z0, handle, prev_last, stack.dense[0].clone())
        prev_last = stack.dense[-1].clone()
    if pending is not None:
        collect(*pending)
    return acc.finish(ids, shape, voxelsize, background_segment)
