"""LabeledStack — the device-side representation of a segmented image.

A dense ``torch.Tensor`` of segment ids on an explicit device, plus the
physical voxel size and the dense-relabel table (original label ids ↔
``0..N-1``). Dense relabeling happens once at ingest on the host; every
device sweep then works on the compact segment space, with the background
pinned to segment 0 when present.

``dense`` is ``uint16`` while the segment ids and the pad label ``n`` fit
(n ≤ 65535), else ``int32``. PyTorch's ``uint16`` supports little beyond
``==``, ``unique`` and ``.to``: consumers widen it once (:func:`widened`,
or inside a kernel) and never compute on it directly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["LabeledStack", "dense_dtype", "resolve_device", "widened"]

# unsigned types torch stores but cannot order, reduce or select on, and
# the signed type each round-trips through exactly
_WIDER = {torch.uint16: torch.int32, torch.uint32: torch.int64, torch.uint64: torch.int64}


def resolve_device(device) -> torch.device:
    """``None`` → the current CUDA device. A CUDA device must exist, whether
    asked for or defaulted to: without one this raises, and ``device="cpu"``
    runs the plain engine on the CPU (there is no silent CPU fallback)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device was found (torch.cuda.is_available() is False); '
                'pass device="cpu" to run the plain engine on the CPU'
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was requested but torch.cuda.is_available() is False"
        )
    return dev


def widened(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a copy in a signed type torch computes on
    (``uint16`` → ``int32``, ``uint32``/``uint64`` → ``int64``)."""
    return t.to(_WIDER[t.dtype]) if t.dtype in _WIDER else t


def dense_dtype(n_labels: int):
    """(numpy, torch) dtype of a stack of ``n_labels`` segment ids."""
    # segment ids and the pad sentinel n_labels fit uint16 — halves the
    # host->device transfer and the sweep's read traffic
    return (np.uint16, torch.uint16) if n_labels <= 0xFFFF else (np.int32, torch.int32)


@dataclasses.dataclass(frozen=True)
class LabeledStack:
    """Dense-relabeled voxel stack.

    Attributes
    ----------
    dense:
        ``uint16``/``int32`` tensor of segment ids in ``0..n_labels-1``
        (2D ``[Y,X]`` or 3D ``[Z,Y,X]``) on the stack's device.
    ids:
        ``int64[n_labels]`` host array mapping segment id -> original label,
        ascending except the background label, pinned to segment 0.
    voxelsize:
        physical size per axis, same order as array axes.
    background_segment:
        segment id of the background label, or ``None`` if the background
        label does not occur in the image.
    all_present:
        every segment id has voxels (a stack relabeled from an image by
        :meth:`from_array`); False where that is not known, as for a raw id
        range or ids given to :meth:`from_numpy`.
    """

    dense: torch.Tensor
    ids: np.ndarray
    voxelsize: Tuple[float, ...]
    background_segment: Optional[int]
    all_present: bool = False

    @property
    def n_labels(self) -> int:
        return int(self.ids.shape[0])

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.dense.shape)

    @property
    def ndim(self) -> int:
        return self.dense.dim()

    @property
    def device(self) -> torch.device:
        return self.dense.device

    @property
    def background_id(self) -> Optional[int]:
        if self.background_segment is None:
            return None
        return int(self.ids[self.background_segment])

    @classmethod
    def from_numpy(
        cls,
        dense: np.ndarray,
        ids: np.ndarray,
        voxelsize: Tuple[float, ...],
        background_segment: Optional[int],
        device=None,
    ) -> "LabeledStack":
        """Wrap an already-relabeled host stack (segment ids ``0..n-1``)."""
        from tissue_analysis_tpu_torch.utils import timing

        dev = resolve_device(device)
        ids = np.asarray(ids, dtype=np.int64)
        np_dtype, _ = dense_dtype(ids.shape[0])
        # torch.from_numpy shares memory and needs a writable C-order array
        dense = np.require(dense, dtype=np_dtype, requirements=["C", "W"])
        with timing.stage("ingest: host->device transfer", int(dense.size), dev):
            dense_dev = torch.from_numpy(dense).to(dev)
        return cls(
            dense=dense_dev,
            ids=ids,
            voxelsize=tuple(float(v) for v in voxelsize),
            background_segment=background_segment,
        )

    @classmethod
    def from_array(
        cls,
        image,
        voxelsize: Optional[Tuple[float, ...]] = None,
        background: Optional[int] = None,
        device=None,
    ) -> "LabeledStack":
        """Ingest a labeled image (host ndarray or SpatialImage).

        Labels are densified on the host (native C++ relabel, numpy
        fallback); if ``background`` is present in the image its segment is
        swapped to position 0 so background-aware features (epidermis/L1
        detection) can address it statically. The dense stack then moves to
        ``device`` (default: the current CUDA device; ``"cpu"`` for the CPU).
        """
        dev = resolve_device(device)
        arr = np.asarray(image)
        if voxelsize is None:
            voxelsize = getattr(image, "voxelsize", None)
        if voxelsize is None:
            voxelsize = (1.0,) * arr.ndim
        voxelsize = tuple(float(v) for v in voxelsize)
        if len(voxelsize) != arr.ndim:
            raise ValueError("voxelsize length must equal image ndim")
        if arr.ndim not in (2, 3):
            raise ValueError(f"expected 2D or 3D labeled image, got ndim={arr.ndim}")
        if not np.issubdtype(arr.dtype, np.integer):
            raise TypeError(
                f"labeled images must have an integer dtype, got {arr.dtype}"
            )

        from tissue_analysis_tpu_torch import native
        from tissue_analysis_tpu_torch.utils import timing

        with timing.stage("ingest: dense relabel", int(arr.size)):
            nat = native.relabel(arr, background)
        if nat is not None:
            # C++ two-pass relabel (same segment convention as below:
            # ids ascending, background swapped to position 0)
            dense, ids, background_segment = nat
        else:
            ids, dense = np.unique(arr, return_inverse=True)
            ids = ids.astype(np.int64)
            dense = dense.reshape(arr.shape).astype(np.int32)

            background_segment = None
            if background is not None:
                pos = np.searchsorted(ids, background)
                if pos < ids.shape[0] and ids[pos] == background:
                    if pos != 0:
                        # swap segment `pos` <-> 0 in both table and image
                        remap = np.arange(ids.shape[0], dtype=np.int32)
                        remap[0], remap[pos] = pos, 0
                        dense = remap[dense]
                        ids = ids.copy()
                        ids[0], ids[pos] = ids[pos], ids[0]
                    background_segment = 0

        stack = cls.from_numpy(dense, ids, voxelsize, background_segment, dev)
        return dataclasses.replace(stack, all_present=True)

    def segment_of(self, label: int) -> Optional[int]:
        """Segment id of an original label, or None if absent."""
        pos = int(np.searchsorted(self.ids, label))
        if pos < self.n_labels and int(self.ids[pos]) == label:
            return pos
        # background may have been swapped away from its sorted position
        hits = np.nonzero(self.ids == label)[0]
        return int(hits[0]) if hits.size else None
