"""Module-level wall/morphology helpers.

Parity targets: the module-level functions of ``spatial_image_analysis.py``:
``dilation``, ``dilation_by``, ``wall``, ``hollow_out_cells``,
``sort_boundingbox``, ``distance``. The voxel-heavy ones
(``hollow_out_cells``, ``wall``) are face stencils in plain PyTorch on an
explicit ``device`` (default: the current CUDA device; ``"cpu"`` for the
CPU).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tissue_analysis_tpu_torch.core.spatial_image import SpatialImage
from tissue_analysis_tpu_torch.core.stack import resolve_device, widened

__all__ = [
    "dilation",
    "dilation_by",
    "wall",
    "hollow_out_cells",
    "sort_boundingbox",
    "distance",
]


def dilation(slices: Sequence[slice], shape: Optional[Tuple[int, ...]] = None):
    """Grow a bounding-box slice tuple by 1, clamped (``:: dilation``)."""
    return dilation_by(slices, 1, shape)


def dilation_by(
    slices: Sequence[slice], amount: int, shape: Optional[Tuple[int, ...]] = None
):
    """Grow a bounding-box slice tuple by ``amount`` (``:: dilation_by``)."""
    out = []
    for d, s in enumerate(slices):
        start = max(0, s.start - amount)
        stop = s.stop + amount
        if shape is not None:
            stop = min(shape[d], stop)
        out.append(slice(start, stop))
    return tuple(out)


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    return widened(t.to(resolve_device(device)))


def _interior_mask(lab: torch.Tensor) -> torch.Tensor:
    """True where all face neighbors share the voxel's label (array edges are
    never interior — matching wall extraction that keeps the tissue surface)."""
    interior = torch.ones(lab.shape, dtype=torch.bool, device=lab.device)
    for d in range(lab.dim()):
        size = lab.shape[d]
        same = lab.narrow(d, 0, size - 1) == lab.narrow(d, 1, size - 1)
        # voxel i vs i+1 on [0, size-1), vs i-1 on [1, size); edges False
        interior.narrow(d, size - 1, 1).fill_(False)
        interior.narrow(d, 0, 1).fill_(False)
        interior.narrow(d, 0, size - 1).logical_and_(same)
        interior.narrow(d, 1, size - 1).logical_and_(same)
    return interior


def hollow_out_cells(image, background: int, verbose: bool = False, device=None):
    """Keep only wall voxels; interior voxels become background
    (``:: hollow_out_cells``)."""
    arr = np.asarray(image)
    lab = _to_device(arr, device)
    bg = torch.tensor(background, dtype=lab.dtype, device=lab.device)
    out = torch.where(_interior_mask(lab), bg, lab).cpu().numpy()
    out = out.astype(arr.dtype, copy=False)
    if verbose:
        kept = int((out != background).sum())
        print(f"hollow_out_cells: kept {kept} wall voxels")
    return SpatialImage(out, voxelsize=getattr(image, "voxelsize", None))


def wall(mask_img, label_id: int, device=None) -> np.ndarray:
    """Boundary-voxel mask of one label (``:: wall``)."""
    arr = np.asarray(mask_img)
    mask = _to_device(arr, device) == label_id
    # on the two-valued mask image, "interior" = every face neighbour is
    # the label too (the label's voxels against everything else)
    return (mask & ~_interior_mask(mask)).cpu().numpy()


def sort_boundingbox(boundingboxes, labels=None, reverse: bool = True):
    """Labels sorted by bounding-box voxel volume (``:: sort_boundingbox``)."""
    if isinstance(boundingboxes, dict):
        items = boundingboxes.items() if labels is None else (
            (l, boundingboxes[l]) for l in labels
        )
    else:
        items = enumerate(boundingboxes)

    def bbox_size(sl):
        if sl is None:
            return -1
        return math.prod(s.stop - s.start for s in sl)

    return [l for l, sl in sorted(items, key=lambda kv: bbox_size(kv[1]), reverse=reverse)]


def distance(pt_a, pt_b) -> float:
    """Euclidean distance between two points (``:: distance``)."""
    a = np.asarray(pt_a, dtype=np.float64)
    b = np.asarray(pt_b, dtype=np.float64)
    return float(np.sqrt(np.sum((a - b) ** 2)))
