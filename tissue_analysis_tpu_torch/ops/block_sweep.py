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

:func:`block_label_counts` is the dictionary step alone: int32 ``[B]``, each
block's number of dictionary labels, saturated at ``cap + 1``, so that
``count[b] > L`` exactly where a sweep at ``L`` sets ``ovf[b]`` (for L ≤
cap). :func:`count_block_labels` returns those counts and the largest of
them (:class:`LabelCounts`), which the kernel writes itself, so a caller
reads one int and launches nothing more. It has no TPU counterpart: the
engine reads the largest count before a sweep to pick the sweep's L, or no
block sweep at all, where the reference's engine catches a failed sweep and
falls back. On a card the count takes one of two load paths by a rule on
shape and pointer (:func:`count_plan`): ``"bulk"`` copies each block's
labels and far-face planes into a shared-memory tile by TMA (one tile a
CTA, two or three CTAs an SM) where the stack's first byte and its row
pitch are multiples of 16 bytes, and ``"direct"`` loads them from device
memory elsewhere. Both are one kernel; neither is a fallback after a
failure.

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

from tissue_analysis_tpu_torch.utils import timing

__all__ = [
    "IMAX",
    "CountPlan",
    "LabelCounts",
    "SweepOut",
    "block_label_counts",
    "block_label_counts_reference",
    "block_sweep",
    "block_sweep_reference",
    "build_kernel",
    "count_block_labels",
    "count_plan",
    "max_dict_size",
    "PLAIN_MAX_DICT",
]

IMAX = 2**31 - 1
DEFAULT_BLOCK = (8, 16, 128)
_DTYPES = (torch.uint16, torch.int32)
_MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper
#: dictionary bound of the plain version: above the kernel's (~2600)
PLAIN_MAX_DICT = 4096
_COUNT_STAGES = 1  # label tiles a CTA holds: one, so that 2-3 CTAs share an SM
_COUNT_LIST = 1024  # hash slots a block lists as it fills them

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
        lib.ta_block_label_count.argtypes = [vp] + [ci] * 17 + [vp] * 3
        lib.ta_block_label_count.restype = ci
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
    timing.count("launches.block_sweep")
    return out


block_sweep.launches = 0


class LabelCounts(NamedTuple):
    """Each block's dictionary size, saturated at ``cap + 1`` (int32
    ``[B]``), and the largest of them (int32, 0-d; 0 for no block)."""

    counts: torch.Tensor
    largest: torch.Tensor


class CountPlan(NamedTuple):
    """How the count kernel runs on a stack: the load path, the hash of
    ``2**hbits`` slots, ``nlist`` slots listed a block, and on the bulk
    path ``stages`` tiles of ``box`` (z, y, x) labels, ``stage_bytes``
    apart; ``smem`` bytes of dynamic shared memory a CTA."""

    path: str
    cap: int
    hbits: int
    nlist: int
    stages: int
    box: Tuple[int, int, int]
    stage_bytes: int
    smem: int


def count_plan(dense: torch.Tensor, block, cap: int) -> CountPlan:
    """The count kernel's plan for ``dense`` (any device: the rule reads
    only shape, label width and pointer).

    The hash holds ≥ 1.25 (cap + 1) slots (≥ 64); past the shared memory a
    CTA may use that raises ``ValueError``. A tile is the block and its +1
    far-face planes, the x side rounded up to 16 bytes; a CTA holds one
    tile (``stages``), beside the hash. The path is ``"bulk"`` (TMA tiles)
    where ``dense.data_ptr()`` and the row pitch ``X · elsize`` are
    multiples of 16 bytes, every side of the tile is at most 256 and the
    tile fits beside the hash; ``"direct"`` (loads from device memory)
    otherwise."""
    cap = int(cap)
    bz, by, bx = (int(b) for b in block)
    Z, Y, X = (int(s) for s in dense.shape)
    es = dense.element_size()
    hbits = max(6, (-(-5 * (cap + 1) // 4) - 1).bit_length())
    nlist = min(cap + 1, _COUNT_LIST)
    # 128 bytes to align the ring, then hash, listed slots, 32 ints (two
    # counts and a block's place, twice)
    fixed = 128 + 4 * ((1 << hbits) + nlist + 32)
    if fixed > _MAX_SMEM:
        raise ValueError(
            f"count cap={cap} exceeds the count kernel's shared-memory bound "
            f"({fixed:,} bytes of hash a CTA, {_MAX_SMEM:,} available)"
        )
    v = 16 // es
    box = (min(bz + 1, Z), min(by + 1, Y), -(-min(bx + 1, X) // v) * v)
    stage_bytes = -(-(box[0] * box[1] * box[2] * es) // 128) * 128
    stages = min(_COUNT_STAGES, (_MAX_SMEM - fixed) // (stage_bytes + 8))
    if (dense.data_ptr() % 16 == 0 and X * es % 16 == 0 and max(box) <= 256
            and stages >= 1):
        smem = fixed + stages * (stage_bytes + 8)
        return CountPlan("bulk", cap, hbits, nlist, stages, box, stage_bytes, smem)
    return CountPlan("direct", cap, hbits, nlist, 0, box, 0, fixed)


def count_block_labels(dense: torch.Tensor, n: int, block, cap: int) -> LabelCounts:
    """Each block's number of dictionary labels, saturated at ``cap + 1``,
    and the largest of them (see the module docstring).

    A CUDA tensor launches the hand-written count kernel (or raises), which
    writes both; the load path follows :func:`count_plan` and is left in
    ``block_label_counts.path``. A CPU tensor runs
    :func:`block_label_counts_reference` and takes its maximum.
    ``block_label_counts.launches`` counts kernel launches."""
    block = tuple(int(b) for b in block)
    _check(dense, n, block, cap)
    if dense.device.type == "cpu":
        counts = block_label_counts_reference(dense, n, block, cap)
        largest = counts.max() if counts.numel() else torch.zeros((), dtype=torch.int32)
        return LabelCounts(counts, largest)
    if dense.device.type != "cuda":
        raise ValueError(f"unsupported device {dense.device}")
    return _launch_count(build_kernel(), dense, n, block, cap)


def block_label_counts(dense: torch.Tensor, n: int, block, cap: int) -> torch.Tensor:
    """The counts of :func:`count_block_labels` alone: int32 ``[B]``."""
    return count_block_labels(dense, n, block, cap).counts


_count_ws: dict = {}


def _count_workspace(dev: torch.device, stream: int) -> torch.Tensor:
    """The count kernel's int32 [2] workspace for its largest count, one a
    device and stream (launches on one stream run in turn), zeroed once;
    every launch leaves it zero."""
    key = (dev.index, stream)
    ws = _count_ws.get(key)
    if ws is None:
        ws = _count_ws[key] = torch.zeros((2,), dtype=torch.int32, device=dev)
    return ws


def _launch_count(lib, dense, n, block, cap) -> LabelCounts:
    plan = count_plan(dense, block, cap)
    Z, Y, X = dense.shape
    gz, gy, gx = _grid(dense.shape, block)
    B = gz * gy * gx
    dev = dense.device
    if B == 0:
        return LabelCounts(torch.empty((0,), dtype=torch.int32, device=dev),
                           torch.zeros((), dtype=torch.int32, device=dev))
    out = torch.empty((B + 1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ta_block_label_count(
            dense.data_ptr(), int(dense.dtype == torch.int32), Z, Y, X, *block, n,
            plan.cap, plan.hbits, plan.nlist, plan.stages, *plan.box, plan.stage_bytes,
            plan.smem, out.data_ptr(), _count_workspace(dev, stream).data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"block_label_count kernel launch failed ({plan.path} path): CUDA error {err}")
    block_label_counts.launches += 1
    timing.count("launches.block_label_count")
    block_label_counts.path = plan.path
    return LabelCounts(out[:B], out[B])


block_label_counts.launches = 0
block_label_counts.path = None


def _layout(dense: torch.Tensor, block):
    """The plain versions' view of ``dense``: its labels (int64, flat),
    the voxel coordinates, each voxel's block, the block count, and per
    axis the +1 neighbour (the voxels that have one, its label, and whether
    it lies past the voxel's block's far face)."""
    dev = dense.device
    Z, Y, X = dense.shape
    bz, by, bx = block
    gz, gy, gx = _grid(dense.shape, block)
    v = dense.reshape(-1).to(torch.int64)
    ar = [torch.arange(s, device=dev, dtype=torch.int64) for s in (Z, Y, X)]
    zc = ar[0].view(-1, 1, 1).expand(Z, Y, X).reshape(-1)
    yc = ar[1].view(1, -1, 1).expand(Z, Y, X).reshape(-1)
    xc = ar[2].view(1, 1, -1).expand(Z, Y, X).reshape(-1)
    bidx = ((zc // bz) * gy + yc // by) * gx + xc // bx
    nbrs = []
    for coord, extent, bs, stride in (
        (zc, Z, bz, Y * X), (yc, Y, by, X), (xc, X, bx, 1)
    ):
        inr = coord + 1 < extent
        idx = torch.nonzero(inr).squeeze(1)
        nv = v[idx + stride]
        far = (coord[idx] % bs) == bs - 1
        nbrs.append((idx, nv, far))
    return v, (zc, yc, xc), bidx, gz * gy * gx, nbrs


def _dictionary(v, n: int, bidx, B: int, nbrs):
    """Every block's dictionary, the labels < n of its voxels and of the +1
    neighbours past its far faces, as sorted unique keys block·(n+1) +
    label, and the dictionary size of each block."""
    n1 = n + 1
    lab_ok = (v >= 0) & (v < n)
    keys = [bidx[lab_ok] * n1 + v[lab_ok]]
    for idx, nv, far in nbrs:
        ok = far & (nv >= 0) & (nv < n)
        keys.append(bidx[idx[ok]] * n1 + nv[ok])
    ukeys = torch.unique(torch.cat(keys), sorted=True)
    return ukeys, torch.bincount(ukeys // n1, minlength=B)


def block_label_counts_reference(dense: torch.Tensor, n: int, block, cap: int) -> torch.Tensor:
    """Plain PyTorch version of the count kernel, on the device of
    ``dense``: the sizes of :func:`block_sweep_reference`'s dictionaries,
    saturated at ``cap + 1``."""
    block = tuple(int(b) for b in block)
    _check(dense, n, block, cap)
    v, _, bidx, B, nbrs = _layout(dense, block)
    sizes = _dictionary(v, n, bidx, B, nbrs)[1]
    return sizes.clamp_(max=cap + 1).to(torch.int32)


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
    n1 = n + 1
    v, (zc, yc, xc), bidx, B, nbrs = _layout(dense, block)
    lab_ok = (v >= 0) & (v < n)

    # ---- dictionary keys: block voxels + neighbours past the far faces
    ukeys, sizes = _dictionary(v, n, bidx, B, nbrs)
    ublk = ukeys // n1
    start = torch.searchsorted(ukeys, ublk * n1)
    rank = torch.arange(ukeys.shape[0], device=dev) - start
    ovf = (sizes > L).to(torch.int32)
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
