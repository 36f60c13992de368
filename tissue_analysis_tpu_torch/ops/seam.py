"""Face contacts across the z-seam between two streamed slabs.

Plain PyTorch on the device of its inputs; the counterpart of the XLA glue
``tissue_analysis_tpu/ops/blocked.py`` ``plane_seam_tiles`` and
``seam_tiles_entries`` (not of a Pallas kernel). A slab is swept on its own,
so its far z plane reads as the dropped label and counts no face; the faces
between the previous slab's last plane and this slab's first plane are
counted here, once each, on axis 0 (the lower-z owner).
"""

from __future__ import annotations

from typing import Tuple

import torch

from tissue_analysis_tpu_torch.core.stack import widened

__all__ = ["seam_pairs"]


def seam_pairs(
    prev_last: torch.Tensor, first: torch.Tensor, n: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """z-faces between two [Y, X] planes of segment ids → (sorted unique
    keys, totals), int64 each, in :func:`combine.reduce_pairs`' key format
    (lo·4n + hi·4 + axis, axis 0) for :func:`combine.decode_pairs`."""
    if prev_last.shape != first.shape or prev_last.dim() != 2:
        raise ValueError(
            f"expected two [Y, X] planes of one shape, got "
            f"{tuple(prev_last.shape)} and {tuple(first.shape)}"
        )
    a = widened(prev_last).reshape(-1).to(torch.int64)
    b = widened(first).reshape(-1).to(torch.int64)
    ok = (a != b) & (a >= 0) & (a < n) & (b >= 0) & (b < n)
    a, b = a[ok], b[ok]
    key = torch.minimum(a, b) * (4 * n) + torch.maximum(a, b) * 4
    return torch.unique(key, sorted=True, return_counts=True)
