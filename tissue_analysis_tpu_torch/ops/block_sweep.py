"""Fused per-block sweep: the CUDA kernel's wrapper and its plain version.

Counterpart of both TPU kernels of ``tissue_analysis_tpu/ops/pallas_block.py``,
which compute one per-block contract:

- kernel-v2, ``_kernel_factory_v2``: the default block (8, 16, 128) with
  fewer than 2¹⁶ labels;
- kernel-v1, ``_kernel_factory``: any block shape and any label count, so
  every 2D image (lifted to ``[1, Y, X]``, block (1, 128, 128)) and every
  label space with n ≥ 2¹⁶ (int32 labels).

One hand-written kernel takes the block shape and the label width (uint16
or int32) at run time and serves both. For every block of shape ``block``
(z-major block order, ragged far edges allowed) the sweep returns:

- ``ids``   int32 [B, L]      slot labels ascending, IMAX in empty slots;
  the dictionary holds the labels < n of the block's voxels and of the +1
  z/y/x neighbours just past its far faces;
- ``mom``   int64 [B, L, 10]  count, Σz, Σy, Σx, Σzz, Σzy, Σzx, Σyy, Σyx,
  Σxx over the block's voxels of each slot label, in global coordinates;
- ``gmin`` / ``gmax`` int32 [B, L, 3]  global bbox (IMAX / -1 when the slot
  has no voxel in the block);
- ``faces`` int32 [B, L, 3L]  pz | py | px: faces[b, s, d·L + t] counts the
  voxels of label ids[s] in the block whose +1 neighbour along axis d has
  label ids[t] ≠ ids[s] (cross-block faces included, diagonal zero);
- ``ovf``   int32 [B]  1 where the block has more than L dictionary labels.
  Such a block's other outputs are undefined (the kernel's differ from the
  plain version's); callers rerun with a larger L.

:func:`block_sweep` launches the CUDA kernel (``csrc/block_sweep.cu``) for a
CUDA tensor and runs :func:`block_sweep_reference` for a CPU tensor; it
never falls back from one to the other. The kernel is compiled with nvcc on
first use into ``build/kernels/`` beside the package and loaded with ctypes.
Its persistent CTAs walk the blocks, sum each lane's runs of one label in
registers before any atomic, and add the face counts into a zeroed
``faces`` in device memory, for any L up to :func:`max_dict_size`. On a
CUDA device both versions raise ``ValueError``, not a bare out-of-memory
error, for a ``faces`` the device cannot hold.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import NamedTuple, Tuple

import torch

__all__ = [
    "IMAX",
    "SweepOut",
    "block_sweep",
    "block_sweep_reference",
    "build_kernel",
    "max_dict_size",
    "PLAIN_MAX_DICT",
]

IMAX = 2**31 - 1
DEFAULT_BLOCK = (8, 16, 128)
_DTYPES = (torch.uint16, torch.int32)
_MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper
#: dictionary bound of the plain version: above the kernel's (~2600)
PLAIN_MAX_DICT = 4096

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "block_sweep.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]


class SweepOut(NamedTuple):
    ids: torch.Tensor
    mom: torch.Tensor
    gmin: torch.Tensor
    gmax: torch.Tensor
    faces: torch.Tensor
    ovf: torch.Tensor


def _grid(shape, block) -> Tuple[int, int, int]:
    return tuple(-(-s // b) for s, b in zip(shape, block))


def _check(dense: torch.Tensor, n: int, block, L: int) -> None:
    if not isinstance(dense, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(dense).__name__}")
    if dense.dim() != 3:
        raise ValueError(f"expected a [Z, Y, X] stack, got shape {tuple(dense.shape)}")
    if dense.dtype not in _DTYPES:
        raise TypeError(f"expected uint16 or int32 labels, got {dense.dtype}")
    if not dense.is_contiguous():
        raise ValueError("the stack must be contiguous")
    if len(block) != 3 or min(block) < 1:
        raise ValueError(f"bad block shape {block}")
    if L < 1:
        raise ValueError(f"dictionary size must be positive, got {L}")
    if not 0 <= n < IMAX:
        raise ValueError(f"label count out of range: {n}")
    # local moment sums are int32 in the kernel: K·(extent-1)² < 2³¹
    K = block[0] * block[1] * block[2]
    if K * (max(block) - 1) ** 2 >= 2**31:
        raise ValueError(f"block {block} too large for int32 local moments")


# --------------------------------------------------------------- build/load
_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_NVCC_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"block_sweep_{digest.hexdigest()[:16]}.so")


def build_kernel() -> ctypes.CDLL:
    """Compile (once per source digest) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = _so_path()
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as td:
                tmp = os.path.join(td, "block_sweep.so")
                res = subprocess.run(
                    [_nvcc(), *_NVCC_FLAGS, _SRC, "-o", tmp],
                    capture_output=True, text=True, timeout=600,
                )
                if res.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
                    )
                os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ta_block_sweep.argtypes = [vp] + [ci] * 9 + [vp] * 7
        lib.ta_block_sweep.restype = ci
        lib.ta_block_sweep_smem_bytes.argtypes = [ci]
        lib.ta_block_sweep_smem_bytes.restype = ctypes.c_longlong
        _lib = lib
        return lib


@functools.lru_cache(maxsize=None)
def max_dict_size() -> int:
    """Largest dictionary size L the kernel takes: the one whose block state
    (hash, local moments, bbox) fits shared memory."""
    smem = build_kernel().ta_block_sweep_smem_bytes
    L = 1
    while smem(L + 1) <= _MAX_SMEM:
        L += 1
    return L


def _faces_buffer(B: int, L: int, block, dev: torch.device) -> torch.Tensor:
    """Zeroed int32 [B, L, 3L]; a ``ValueError`` naming the bytes and the
    block when the device cannot hold them (rather than a bare
    out-of-memory error from the allocator).

    The allocator itself decides: asking first (``torch.cuda.memory_stats``,
    ``cudaMemGetInfo``) made back-to-back launches 0.02-0.04 ms slower
    each on an H100."""
    try:
        return torch.zeros((B, L, 3 * L), dtype=torch.int32, device=dev)
    except torch.cuda.OutOfMemoryError:
        free = torch.cuda.mem_get_info(dev)[0]
        raise ValueError(
            f"the [B, L, 3L] face counts of {B} blocks of {block} at "
            f"L={L} need {B * L * 3 * L * 4:,} bytes; {dev} has {free:,} free "
            f'(engine="chunked", the flat engine, needs no face buffer)'
        ) from None


# ---------------------------------------------------------------- wrappers
def block_sweep(dense: torch.Tensor, n: int, block=DEFAULT_BLOCK, L: int = 32) -> SweepOut:
    """Per-block sweep of ``dense`` (see the module docstring).

    A CUDA tensor launches the hand-written kernel (or raises); a CPU tensor
    runs the plain PyTorch version. ``block_sweep.launches`` counts kernel
    launches."""
    block = tuple(int(b) for b in block)
    _check(dense, n, block, L)
    if dense.device.type == "cpu":
        return block_sweep_reference(dense, n, block, L)
    if dense.device.type != "cuda":
        raise ValueError(f"unsupported device {dense.device}")
    return _launch(build_kernel(), dense, n, block, L)


def _launch(lib, dense, n, block, L) -> SweepOut:
    """Launch the kernel: it writes ids, mom, gmin, gmax and ovf, and adds
    the face counts into a zeroed device buffer."""
    if lib.ta_block_sweep_smem_bytes(L) > _MAX_SMEM:
        raise ValueError(
            f"dictionary size L={L} exceeds the kernel's shared-memory bound "
            f"(max {max_dict_size()})"
        )
    Z, Y, X = dense.shape
    gz, gy, gx = _grid(dense.shape, block)
    B = gz * gy * gx
    dev = dense.device
    i32 = dict(dtype=torch.int32, device=dev)
    out = SweepOut(
        ids=torch.empty((B, L), **i32),
        mom=torch.empty((B, L, 10), dtype=torch.int64, device=dev),
        gmin=torch.empty((B, L, 3), **i32),
        gmax=torch.empty((B, L, 3), **i32),
        faces=_faces_buffer(B, L, block, dev),
        ovf=torch.empty((B,), **i32),
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ta_block_sweep(
            dense.data_ptr(), int(dense.dtype == torch.int32), Z, Y, X,
            *block, L, n, *(t.data_ptr() for t in out), stream,
        )
    if err != 0:
        raise RuntimeError(f"block_sweep kernel launch failed: CUDA error {err}")
    block_sweep.launches += 1
    return out


block_sweep.launches = 0


def block_sweep_reference(
    dense: torch.Tensor, n: int, block=DEFAULT_BLOCK, L: int = 32
) -> SweepOut:
    """Plain PyTorch version of the kernel, on the device of ``dense``.

    Vectorized over voxels: a sorted unique of (block, label) keys over the
    voxels and the +1 neighbours past each block's far faces gives the
    slots (rank within the block); ``index_add_`` accumulates moments and
    faces, ``scatter_reduce_`` the bbox. On overflow the L smallest labels
    keep slots."""
    block = tuple(int(b) for b in block)
    _check(dense, n, block, L)
    dev = dense.device
    Z, Y, X = dense.shape
    bz, by, bx = block
    gz, gy, gx = _grid(dense.shape, block)
    B = gz * gy * gx
    n1 = n + 1
    v = dense.reshape(-1).to(torch.int64)
    lab_ok = (v >= 0) & (v < n)

    ar = [torch.arange(s, device=dev, dtype=torch.int64) for s in (Z, Y, X)]
    zc = ar[0].view(-1, 1, 1).expand(Z, Y, X).reshape(-1)
    yc = ar[1].view(1, -1, 1).expand(Z, Y, X).reshape(-1)
    xc = ar[2].view(1, 1, -1).expand(Z, Y, X).reshape(-1)
    bidx = ((zc // bz) * gy + yc // by) * gx + xc // bx

    # +1 neighbour per axis: flat stride, in-range mask, far-face mask
    nbrs = []
    for coord, extent, bs, stride in (
        (zc, Z, bz, Y * X), (yc, Y, by, X), (xc, X, bx, 1)
    ):
        inr = coord + 1 < extent
        idx = torch.nonzero(inr).squeeze(1)
        nv = v[idx + stride]
        far = (coord[idx] % bs) == bs - 1
        nbrs.append((idx, nv, far))

    # ---- dictionary keys: block voxels + neighbours past the far faces
    keys = [bidx[lab_ok] * n1 + v[lab_ok]]
    for idx, nv, far in nbrs:
        ok = far & (nv >= 0) & (nv < n)
        keys.append(bidx[idx[ok]] * n1 + nv[ok])
    ukeys = torch.unique(torch.cat(keys), sorted=True)
    ublk = ukeys // n1
    start = torch.searchsorted(ukeys, ublk * n1)
    rank = torch.arange(ukeys.shape[0], device=dev) - start
    ovf = (torch.bincount(ublk, minlength=B) > L).to(torch.int32)
    keep = rank < L
    ids = torch.full((B, L), IMAX, dtype=torch.int32, device=dev)
    ids[ublk[keep], rank[keep]] = (ukeys[keep] % n1).to(torch.int32)

    def slot_of(key):
        pos = torch.searchsorted(ukeys, key)
        r = rank[pos]
        return torch.where(r < L, r, -1)

    # ---- moments and bbox over the block's voxels
    vox = torch.nonzero(lab_ok).squeeze(1)
    vb = bidx[vox]
    vs = slot_of(vb * n1 + v[vox])
    good = vs >= 0
    vox, vb, vs = vox[good], vb[good], vs[good]
    row = vb * L + vs
    c = (zc[vox], yc[vox], xc[vox])
    mom = torch.zeros((10, B * L), dtype=torch.int64, device=dev)
    mom[0].index_add_(0, row, torch.ones_like(row))
    for d in range(3):
        mom[1 + d].index_add_(0, row, c[d])
    # tri_pairs order: zz, zy, zx, yy, yx, xx
    for q, (i, j) in enumerate(((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))):
        mom[4 + q].index_add_(0, row, c[i] * c[j])
    gmin = torch.full((3, B * L), IMAX, dtype=torch.int32, device=dev)
    gmax = torch.full((3, B * L), -1, dtype=torch.int32, device=dev)
    for d in range(3):
        cd = c[d].to(torch.int32)
        gmin[d].scatter_reduce_(0, row, cd, "amin")
        gmax[d].scatter_reduce_(0, row, cd, "amax")

    # ---- faces: a voxel's neighbour label looked up in the voxel's block
    faces = _faces_buffer(B, L, block, dev).view(-1)
    for d, (idx, nv, _far) in enumerate(nbrs):
        a = v[idx]
        ok = (a >= 0) & (a < n) & (nv >= 0) & (nv < n) & (nv != a)
        idx, a, nv = idx[ok], a[ok], nv[ok]
        blk = bidx[idx]
        s = slot_of(blk * n1 + a)
        t = slot_of(blk * n1 + nv)
        ok = (s >= 0) & (t >= 0)
        flat = ((blk[ok] * L + s[ok]) * 3 + d) * L + t[ok]
        faces.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))

    return SweepOut(
        ids=ids,
        mom=mom.t().contiguous().view(B, L, 10),
        gmin=gmin.t().contiguous().view(B, L, 3),
        gmax=gmax.t().contiguous().view(B, L, 3),
        faces=faces.view(B, L, 3 * L),
        ovf=ovf,
    )
