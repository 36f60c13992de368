"""Adversarial inputs of the per-block sweep, made with numpy from fixed seeds.

Each case is built to break one assumption a fast sweep could make: runs of
one label (none here: every voxel differs from its +x neighbour), runs that
stop at a lane, warp row or block boundary (they cross all of them here),
full blocks (a ragged stack), at least one live label per block (one label,
or none), labels below 2¹⁶ (ids spread over n = 70,000), a dictionary with
room to spare (exactly L labels per block, and one more), and the default
block shape ((4, 8, 32) and the 2D block (1, 128, 128)). All are at most
64³ voxels.

:data:`CASES` maps a name to a function returning ``(dense, n, block, L)``:
a C-contiguous uint16 or int32 ``[Z, Y, X]`` array of segment ids (``n``
marks a voxel that takes no part), the label count, the block shape and the
dictionary size. ``tests/test_torch_block_sweep.py`` holds the plain sweep
against the JAX package's kernels on them, and ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` the CUDA kernel against the plain sweep.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from tissue_analysis_tpu_torch.core.synthetic import voronoi_stack

__all__ = ["CASES", "Case"]

Case = Tuple[np.ndarray, int, Tuple[int, int, int], int]
BLOCK = (8, 16, 128)


def _alternating(shape, distinct: int) -> np.ndarray:
    """(x + 7y + 3z) mod ``distinct``: every voxel differs from its +x, +y
    and +z neighbours, and a block at least ``distinct`` wide in x holds
    exactly ``distinct`` labels."""
    z, y, x = np.indices(shape, dtype=np.int64)
    return (x + 7 * y + 3 * z) % distinct


def _runs(shape, pool: np.ndarray, seed: int, longest: int = 300) -> np.ndarray:
    """Runs of one label along the flat (z, y, x) order, of random lengths
    1..``longest``, so they start and stop anywhere: inside a lane's voxels,
    across rows, planes and blocks. Labels are drawn from ``pool``."""
    rng = np.random.default_rng(seed)
    size = int(np.prod(shape))
    lengths = rng.integers(1, longest + 1, size=size // 2 + 1)
    ends = np.cumsum(lengths)
    k = int(np.searchsorted(ends, size)) + 1
    labels = rng.choice(pool, size=k)
    return np.repeat(labels, lengths[:k])[:size].reshape(shape)


def _dense(img) -> Tuple[np.ndarray, int]:
    """Segment ids 0..n-1 of a labelled image, and n."""
    ids, inv = np.unique(np.asarray(img), return_inverse=True)
    return inv.reshape(np.shape(img)), int(ids.shape[0])


def _case(arr, n: int, block=BLOCK, L: int = 32, dtype=None) -> Case:
    if dtype is None:
        dtype = np.uint16 if n <= 0xFFFF else np.int32
    return np.ascontiguousarray(arr, dtype=dtype), int(n), tuple(block), int(L)


def _spread_pool(n: int, k: int, seed: int) -> np.ndarray:
    """k distinct ids over 0..n-1, the top one (n - 1) among them."""
    pool = np.random.default_rng(seed).choice(n - 1, size=k - 1, replace=False)
    return np.append(pool, n - 1)


def _voronoi_ragged() -> Case:
    dense, n = _dense(voronoi_stack((19, 45, 150), 30, seed=11))
    return _case(dense, n, L=64)


CASES: Dict[str, Callable[[], Case]] = {
    # 32 labels a block at L = 32: the dictionary exactly full
    "alternate-x-at-L": lambda: _case(_alternating((16, 32, 256), 32), 32),
    # 33 labels a block at L = 32: every block overflows by one
    "alternate-x-over-L": lambda: _case(_alternating((16, 32, 256), 33), 33),
    "runs-across-boundaries": lambda: _case(
        _runs((16, 40, 300), np.arange(40), seed=12), 40, L=64),
    "ragged-19x45x150": _voronoi_ragged,
    "single-label": lambda: _case(np.zeros((12, 20, 140)), 1),
    "all-n": lambda: _case(np.full((9, 17, 129), 5), 5),
    "runs-i32-n70000": lambda: _case(
        _runs((16, 32, 256), _spread_pool(70000, 40, 13), seed=14), 70000, L=64,
        dtype=np.int32),
    "alternate-block4x8x32": lambda: _case(
        _alternating((9, 17, 70), 32), 32, block=(4, 8, 32)),
    "runs-2d-block1x128x128": lambda: _case(
        _runs((1, 200, 300), np.arange(50), seed=15, longest=200), 50,
        block=(1, 128, 128), L=64),
}
