"""The least bytes a pass has to move, and the peaks they are held against.

A pass reads the stack once and writes the table once. Both are counted from
the stack's shape and the table's size alone, whatever engine, dictionary
size or intermediate buffer the program uses:

- the stack: one label a voxel, in the narrowest type that holds every
  segment id (2 bytes up to 65,536 labels, else 4);
- the table, as users receive it: a label's id, count, 3 sums, 6 sums of
  products and 6 bounding-box ends as 8-byte integers and a margin flag
  (137 bytes), and a wall's two segment ids (4 bytes each) and 3 face
  counts (8 bytes each), 32 bytes.

``peaks.json`` holds each card's published peaks, by the name that
``torch.cuda.get_device_name()`` gives.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

__all__ = ["pass_bytes", "peak_bytes_per_s", "LABEL_BYTES", "PAIR_BYTES"]

LABEL_BYTES = 8 * (1 + 1 + 3 + 6 + 6) + 1
PAIR_BYTES = 4 + 4 + 3 * 8


def pass_bytes(shape: Sequence[int], n_labels: int, n_pairs: int) -> int:
    voxels = 1
    for s in shape:
        voxels *= int(s)
    label = 2 if n_labels <= 1 << 16 else 4
    return voxels * label + n_labels * LABEL_BYTES + n_pairs * PAIR_BYTES


def peak_bytes_per_s(device_name: str) -> Optional[float]:
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")) as f:
        peaks = json.load(f)
    entry = peaks.get(device_name)
    return None if entry is None else float(entry["hbm_bytes_per_s"])
