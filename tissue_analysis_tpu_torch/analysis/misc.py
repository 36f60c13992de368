"""Small label-image utilities.

Parity target: the reference's misc/util module (SURVEY.md §2.1 row 9 [L]:
"small conversions, label-list I/O"). Host-side numpy — these are glue, not
hot paths (relabeling at scale goes through the native ingest relabel).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from tissue_analysis_tpu_torch.core.spatial_image import SpatialImage

__all__ = [
    "save_labels",
    "load_labels",
    "labels_in_image",
    "relabel_image",
    "remove_cells",
]


def save_labels(labels: Sequence[int], path: str) -> None:
    """One label id per line (the reference scripts' label-list format)."""
    with open(path, "w") as f:
        for l in labels:
            f.write(f"{int(l)}\n")


def load_labels(path: str) -> List[int]:
    with open(path) as f:
        return [int(line) for line in f if line.strip()]


def labels_in_image(image, exclude: Iterable[int] = ()) -> List[int]:
    """Sorted unique labels, minus ``exclude``."""
    drop = set(int(x) for x in exclude)
    return [int(l) for l in np.unique(np.asarray(image)) if int(l) not in drop]


def relabel_image(image, mapping: Dict[int, int], default: Optional[int] = None):
    """Apply {old label: new label}; unmapped labels keep their value, or
    ``default`` if given. Returns a SpatialImage with the input voxelsize."""
    arr = np.asarray(image)
    ids = np.unique(arr)
    lut_src = ids
    lut_dst = np.array(
        [
            mapping.get(int(l), int(l) if default is None else default)
            for l in ids
        ],
        dtype=arr.dtype if default is None else np.result_type(arr.dtype, int),
    )
    idx = np.searchsorted(lut_src, arr)
    out = lut_dst[idx]
    return SpatialImage(out, voxelsize=getattr(image, "voxelsize", None))


def remove_cells(image, labels: Iterable[int], background: int = 1):
    """Relabel the given cells to the background (``remove_margins_cells``
    building block)."""
    arr = np.asarray(image).copy()
    arr[np.isin(arr, list(labels))] = background
    return SpatialImage(arr, voxelsize=getattr(image, "voxelsize", None))
