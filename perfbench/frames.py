"""Raw label frames, made on the device from a seed.

A frame is a meristem-like stack: each voxel takes the nearest of
``ncells`` seed points (labels 2, 3, ...), and label 1, the background,
lies outside a centred sphere of radius 0.95 · min(shape) / 2. This is the
arithmetic of the program's ``core/synthetic.py::voronoi_stack``, frozen
here in PyTorch and computed by brute force over the seeds near each plane:
squared distances are exact integers in float32 (coordinates below 2¹¹),
so the nearest seed, and the first of equally near ones, is the same on
every run of a seed.

A traffic mix may overwrite one box of a frame with fresh labels
(``dense_block``), after the frame's largest id.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["frame_seed", "voronoi_frame", "dense_block", "make_frame"]

_BLOCK = 1 << 27  # float32 distances a step of the generator holds: 512 MiB
_TORCH_DTYPES = {np.dtype(np.uint16): torch.uint16, np.dtype(np.int32): torch.int32}


def frame_seed(seed: int, index: int) -> int:
    """The seed of frame ``index`` of a run seeded ``seed`` (any integer)."""
    ss = np.random.SeedSequence([int(seed) % 2**64, int(index)])
    return int(ss.generate_state(1, np.uint64)[0])


def _nearest(z: int, ys: torch.Tensor, xs: torch.Tensor, pts: torch.Tensor):
    """(squared distance, index) of the nearest of seeds ``pts`` to each
    voxel of plane ``z``, the first of equally near ones. The distance is
    separable, (y − py)² + (z − pz)² plus (x − px)², and exact in float32;
    rows go in blocks of at most ``_BLOCK`` distances."""
    dyz = (ys[:, None] - pts[None, :, 1]) ** 2 + (z - pts[None, :, 0]) ** 2
    dx = (xs[:, None] - pts[None, :, 2]) ** 2
    rows = max(1, _BLOCK // (xs.numel() * pts.shape[0]))
    best, idx = zip(*(torch.min(dyz[r:r + rows, None, :] + dx[None, :, :], 2)
                      for r in range(0, ys.numel(), rows)))
    return torch.cat(best).reshape(-1), torch.cat(idx).reshape(-1)


def voronoi_frame(shape: Sequence[int], ncells: int, seed: int, device,
                 background: int = 1) -> torch.Tensor:
    """int32 labels of one Voronoi frame of ``shape`` on ``device``."""
    shape = tuple(int(s) for s in shape)
    if max(shape) >= 2048:
        raise ValueError("frames up to 2047 voxels a side keep distances exact")
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    pts = torch.stack(
        [torch.randint(0, s, (ncells,), generator=g, device=dev) for s in shape], 1
    ).to(torch.float32)  # [S, 3]
    Z, Y, X = shape
    ys = torch.arange(Y, device=dev, dtype=torch.float32)
    xs = torch.arange(X, device=dev, dtype=torch.float32)
    out = torch.empty((Z, Y * X), dtype=torch.int32, device=dev)
    # a plane's nearest seed is searched among the seeds within w planes of
    # it; where some voxel's nearest of those lies farther than w, seeds
    # beyond could be nearer, and the plane searches all of them
    w = 2 * math.ceil((Z * Y * X / ncells) ** (1 / 3))
    for z in range(Z):
        near = torch.nonzero((pts[:, 0] - z).abs() <= w).reshape(-1)
        if 0 < near.numel() < ncells:
            best, idx = _nearest(z, ys, xs, pts[near])
            if not bool((best > w * w).any()):
                out[z] = near[idx].to(torch.int32) + 2
                continue
        out[z] = _nearest(z, ys, xs, pts)[1].to(torch.int32) + 2
    out = out.view(Z, Y, X)
    # background outside the sphere, tested in float64 as the host generator does
    c = [(s - 1) / 2.0 for s in shape]
    r2 = (0.95 * min(shape) / 2.0) ** 2
    d = [(torch.arange(s, device=dev, dtype=torch.float64) - ci) ** 2 for s, ci in zip(shape, c)]
    outside = (d[0].view(-1, 1, 1) + d[1].view(1, -1, 1) + d[2].view(1, 1, -1)) > r2
    out[outside] = background
    return out


def dense_block(frame: torch.Tensor, box, fresh: int) -> torch.Tensor:
    """``frame`` with the box ``((z0, z1), (y0, y1), (x0, x1))`` overwritten
    by ``fresh`` new labels after the frame's largest, in runs of equal
    length along the box's flat order (one voxel each where ``fresh`` is
    the box's voxel count)."""
    (z0, z1), (y0, y1), (x0, x1) = box
    k = (z1 - z0) * (y1 - y0) * (x1 - x0)
    first = int(frame.max()) + 1
    fill = first + torch.arange(k, device=frame.device, dtype=torch.int64) * int(fresh) // k
    frame[z0:z1, y0:y1, x0:x1] = fill.view(z1 - z0, y1 - y0, x1 - x0).to(frame.dtype)
    return frame


def make_frame(config: dict, traffic: dict, seed: int, index: int, device,
               background: int = 1) -> np.ndarray:
    """Frame ``index`` of a run seeded ``seed``: a host array of the
    configuration's label type (``dtype``), made on ``device``."""
    frame = voronoi_frame(config["shape"], int(config["ncells"]), frame_seed(seed, index),
                         device, background)
    block: Optional[dict] = traffic.get("dense_block")
    if block:
        frame = dense_block(frame, (block["z"], block["y"], block["x"]), int(block["fresh"]))
    dtype = np.dtype(config["dtype"])
    if int(frame.max()) > np.iinfo(dtype).max:
        raise ValueError(f"labels up to {int(frame.max())} do not fit {dtype}")
    # narrowed on the device, so that only the frame's own bytes cross
    return frame.to(_TORCH_DTYPES[dtype]).cpu().numpy()
