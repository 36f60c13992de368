"""The flat engine over a list of blocks: the blocks a block sweep cannot
take, swept beside it.

``engine="auto"`` sweeps a stack by blocks at a dictionary size L and gives
the few blocks whose dictionaries hold more than L labels to this module
(``engine._route``). Their rows join the block sweep's combine
(``combine.combine_moments``, ``combine.reduce_pairs``), so that the table
equals the flat engine's over the whole stack, exactly.

The k blocks are gathered at once into ``[k, bz+1, by+1, bx+1]`` boxes: each
block with one plane past each of its far faces, the pad label n past the
image (:func:`gather_blocks`). From the boxes, vectorised over the blocks,
in about forty device operations and with no host sync:

- :func:`moment_rows`: one row a voxel of the blocks, in global
  coordinates: count, Σz, Σy, Σx and the six products in
  ``features.finalize.tri_pairs`` order; the segment n where the voxel is
  past the image, so that the combine drops it;
- :func:`pair_keys`: for each voxel of the blocks and each axis, the key
  ``lo·4n + hi·4 + axis`` of the voxel and its +1 neighbour, the neighbour
  possibly in the halo, with a mask of the keys that are a face between two
  labels. A face belongs to the block of its lo voxel, as in the block
  sweep, so every face is counted once.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["block_origins", "gather_blocks", "moment_rows", "pair_keys", "routed_bytes",
           "BOX_BYTES", "ROW_BYTES"]

#: device bytes a voxel of the gathered boxes takes at most: its int64 flat
#: index, its label as read (up to int32) and as int32, the int32 label with
#: the pad past the image, and the mask
BOX_BYTES = 8 + 4 + 4 + 4 + 1
#: device bytes a voxel of a routed block takes at most, at the largest of
#: the three moments that hold its temporaries. The pair reduce of the
#: combine holds the voxel's three keys and masks (3 · 9), the keys and
#: counts that pass the mask (3 · 16), and ``torch.unique``'s six int64
#: buffers of those keys (a copy, the sort's keys and indices and their
#: order, the inverse, a scan: 3 · 48). The moment rows (int64 segment and
#: [10] moments, int32 [3] coordinates: 100) are added into the combine's
#: tables and let go before it; :func:`pair_keys`, beside them, holds the
#: int32 lo and hi of each axis, the masks and the keys (100 + 24 + 27):
#: both take less.
ROW_BYTES = 3 * (8 + 1) + 3 * (8 + 8) + 3 * 6 * 8


def routed_bytes(block: Sequence[int], k: int) -> int:
    """Device bytes of the flat sweep of ``k`` routed blocks of shape
    ``block``, to the end of the combine: :data:`BOX_BYTES` a voxel of
    their boxes, and :data:`ROW_BYTES` a voxel of the blocks."""
    box = math.prod(int(b) + 1 for b in block)
    return int(k) * (box * BOX_BYTES + math.prod(int(b) for b in block) * ROW_BYTES)


def block_origins(idx: np.ndarray, shape, block) -> np.ndarray:
    """int64 ``[3, k]``: the z, y and x of the first voxel of each block
    ``idx`` (z-major block order over an image of ``shape``)."""
    gy, gx = (-(-int(s) // int(b)) for s, b in zip(shape[1:], block[1:]))
    idx = np.asarray(idx, dtype=np.int64)
    return np.stack([idx // (gy * gx) * block[0], idx // gx % gy * block[1],
                     idx % gx * block[2]])


def gather_blocks(dense: torch.Tensor, n: int, block, origins: torch.Tensor) -> Tuple[
        torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The blocks of the ``[Z, Y, X]`` stack ``dense`` whose first voxels
    are ``origins`` (int64 ``[3, k]``, on its device), each with one plane
    past each far face: (int32 ``[k, bz+1, by+1, bx+1]`` labels, the pad
    label n past the image and for a label outside ``0..n-1``; per axis the
    int64 ``[k, b+1]`` global coordinates of the box, past the image
    included)."""
    shape = tuple(int(s) for s in dense.shape)
    Z, Y, X = shape
    ar = torch.arange(max(block) + 1, device=origins.device)
    cz, cy, cx = (o[:, None] + ar[:int(b) + 1] for o, b in zip(origins, block))
    flat = (cz * (Y * X))[:, :, None, None] + (cy * X)[:, None, :, None] + cx[:, None, None, :]
    # past the image an index is held inside the stack and its label masked
    flat.clamp_(max=Z * Y * X - 1)
    # uint16 labels are gathered through their int16 view and widened after
    wide = dense.dtype == torch.uint16
    v = (dense.view(torch.int16) if wide else dense).reshape(-1)[flat].to(torch.int32)
    del flat
    ok = (cz < Z)[:, :, None, None] & (cy < Y)[:, None, :, None] & (cx < X)[:, None, None, :]
    if wide:
        v &= 0xFFFF
    else:
        ok &= v >= 0
    ok &= v < n
    return torch.where(ok, v, n), (cz, cy, cx)


def moment_rows(box: torch.Tensor, coords, block) -> Tuple[
        torch.Tensor, torch.Tensor, torch.Tensor]:
    """One row a voxel of the blocks of :func:`gather_blocks`'s ``box`` and
    ``coords``: (segment int64 [r], moments int64 [r, 10], coordinates int32
    [r, 3]), r = k·bz·by·bx, in global coordinates. A voxel past the image
    has the segment n, the pad label. Each column is a product of at most
    two axes' coordinates, broadcast into the rows by one ``cat``."""
    bz, by, bx = (int(b) for b in block)
    cz, cy, cx = coords
    z = cz[:, :bz, None, None, None]
    y, x = cy[:, None, :by, None, None], cx[:, None, None, :bx, None]
    shape = (box.shape[0], bz, by, bx, 1)
    coord = torch.cat([c.expand(shape) for c in (z, y, x)], -1).view(-1, 3).to(torch.int32)
    # count, Σz, Σy, Σx, then zz, zy, zx, yy, yx, xx (tri_pairs order)
    cols = (torch.ones_like(z), z, y, x, z * z, z * y, z * x, y * y, y * x, x * x)
    mom = torch.cat([c.expand(shape) for c in cols], -1).view(-1, 10)
    seg = box[:, :bz, :by, :bx].to(torch.int64).reshape(-1)
    return seg, mom, coord


def pair_keys(box: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The faces of the blocks of :func:`gather_blocks`'s ``box`` as (int64
    keys ``lo·4n + hi·4 + axis``, bool mask): one key for each axis and each
    voxel of the blocks, its +1 neighbour possibly in the halo. The mask
    holds where the two labels differ and both are < n."""
    _, tz, ty, tx = box.shape
    a = box[:, :tz - 1, :ty - 1, :tx - 1]
    b = torch.stack([box[:, 1:, :ty - 1, :tx - 1], box[:, :tz - 1, 1:, :tx - 1],
                     box[:, :tz - 1, :ty - 1, 1:]])
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    del b
    ok = (lo != hi) & (hi < n)
    axis = torch.arange(3, device=box.device).view(3, 1, 1, 1, 1)
    key = lo.to(torch.int64).mul_(4 * n).add_(hi, alpha=4).add_(axis)
    return key.view(-1), ok.view(-1)
