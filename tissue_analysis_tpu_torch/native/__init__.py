"""Native (C++) host-side kernels with a transparent numpy fallback.

The reference's native layer is scipy.ndimage's C loops (SURVEY.md §2.2);
the rebuild's host-side native layer covers the ingest path (dense
relabeling), which otherwise costs a full O(V log V) `np.unique` sort over
the stack. The library is compiled on demand with g++ (-O3 -fopenmp) and
cached under ``~/.cache/tissue_analysis_tpu_torch``; if no compiler is available
everything silently falls back to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

# eigh3_batch is intentionally NOT exported: its contract (``bad`` rows
# carry unreliable vectors and MUST be LAPACK-recomputed) is fulfilled by
# features.finalize._eigh3, the only supported caller (ADVICE r3 #3)
__all__ = ["available", "relabel", "load"]

_ABI_VERSION = 3
_SRC = os.path.join(os.path.dirname(__file__), "relabel.cpp")

_DTYPE_CODES = {
    np.dtype(np.uint8): 0,
    np.dtype(np.uint16): 1,
    np.dtype(np.uint32): 2,
    np.dtype(np.int32): 3,
    np.dtype(np.int64): 4,
    np.dtype(np.uint64): 5,
}

_lib = None
_load_failed = False


# -ffp-contract=off: no FMA contraction, so ta_eigh3 matches the numpy
# analytic path bit-for-bit across hosts (ADVICE r3 #2); relabel is pure
# integer code and loses nothing
_CXX_FLAGS = [
    "-O3", "-march=native", "-ffp-contract=off", "-fopenmp", "-shared",
    "-fPIC", "-std=c++17",
]


def _cache_path() -> str:
    with open(_SRC, "rb") as f:
        payload = f.read() + " ".join(_CXX_FLAGS).encode()
        digest = hashlib.sha256(payload).hexdigest()[:16]
    cache_dir = os.environ.get(
        "TA_NATIVE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "tissue_analysis_tpu_torch"),
    )
    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir, f"ta_native_{digest}.so")


def _build(so_path: str) -> bool:
    try:
        with tempfile.TemporaryDirectory() as td:
            tmp = os.path.join(td, "ta_native.so")
            subprocess.run(
                ["g++", *_CXX_FLAGS, _SRC, "-o", tmp],
                check=True,
                capture_output=True,
                timeout=180,
            )
            os.replace(tmp, so_path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def load() -> Optional[ctypes.CDLL]:
    """The native library handle, building it on first use (None if n/a)."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if os.environ.get("TA_NO_NATIVE"):
        _load_failed = True
        return None
    so_path = _cache_path()
    if not os.path.exists(so_path) and not _build(so_path):
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(so_path)
        argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib.ta_relabel.restype = ctypes.c_int64
        lib.ta_relabel.argtypes = argtypes
        lib.ta_relabel_u16.restype = ctypes.c_int64
        lib.ta_relabel_u16.argtypes = argtypes
        lib.ta_eigh3.restype = ctypes.c_int64
        lib.ta_eigh3.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ta_native_abi_version.restype = ctypes.c_int64
        if lib.ta_native_abi_version() != _ABI_VERSION:
            raise OSError("stale native build")
        _lib = lib
    except (OSError, AttributeError):
        # AttributeError: a cached .so missing a symbol (possible only if
        # the digest/ABI guards are ever weakened) must also fall back to
        # numpy instead of crashing (ADVICE r3 #1)
        _load_failed = True
        return None
    return _lib


def available() -> bool:
    return load() is not None


def relabel(
    arr: np.ndarray, background: Optional[int]
) -> Optional[Tuple[np.ndarray, np.ndarray, Optional[int]]]:
    """Dense-relabel via the native library.

    Returns (dense int32, ids int64 — ascending except background swapped to
    position 0, bg_segment or None), or None when the native path is
    unavailable for this input (caller falls back to numpy).
    """
    lib = load()
    if lib is None:
        return None
    arr = np.ascontiguousarray(arr)
    code = _DTYPE_CODES.get(arr.dtype)
    if code is None:
        return None
    n = arr.size
    # first attempt writes uint16 dense directly (halves the write traffic
    # and skips the downstream downcast pass); falls back to int32 when the
    # label count exceeds the uint16 segment space
    out_dtype = np.uint16
    fn = lib.ta_relabel_u16
    max_ids = 1 << 16
    while True:
        dense = np.empty(arr.shape, dtype=out_dtype)
        ids = np.empty(max_ids, dtype=np.int64)
        bg_seg = ctypes.c_int64(-1)
        res = fn(
            arr.ctypes.data_as(ctypes.c_void_p),
            n,
            code,
            0 if background is None else int(background),
            0 if background is None else 1,
            dense.ctypes.data_as(ctypes.c_void_p),
            ids.ctypes.data_as(ctypes.c_void_p),
            max_ids,
            ctypes.byref(bg_seg),
        )
        if res == -(1 << 63):
            return None  # unsupported dtype (shouldn't happen, gated above)
        if res < 0:
            max_ids = int(-res)
            if out_dtype == np.uint16 and max_ids > 0xFFFF:
                out_dtype = np.int32
                fn = lib.ta_relabel
            continue
        n_ids = int(res)
        bg = int(bg_seg.value)
        return dense, ids[:n_ids].copy(), (bg if bg >= 0 else None)


def eigh3_batch(
    A: np.ndarray,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
    """Batched analytic symmetric 3×3 eigendecomposition (native path).

    Returns ``(w [m,3] ascending, V [m,3,3] columns = eigenvectors,
    bad [m] bool, n_bad)`` or None when the native library is unavailable.
    ``bad`` rows (near-degenerate spectrum / degenerate cross products —
    the same mask as ``features.finalize._eigh3``'s numpy path) carry
    unreliable vectors and MUST be recomputed by the caller with LAPACK.
    """
    lib = load()
    if lib is None:
        return None
    A = np.ascontiguousarray(A, dtype=np.float64)
    m = A.shape[0]
    w = np.empty((m, 3), dtype=np.float64)
    V = np.empty((m, 3, 3), dtype=np.float64)
    bad = np.empty(m, dtype=np.uint8)
    n_bad = lib.ta_eigh3(
        A.ctypes.data_as(ctypes.c_void_p),
        m,
        w.ctypes.data_as(ctypes.c_void_p),
        V.ctypes.data_as(ctypes.c_void_p),
        bad.ctypes.data_as(ctypes.c_void_p),
    )
    return w, V, bad.view(bool), int(n_bad)
