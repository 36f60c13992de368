"""SpatialImage: an ndarray with physical voxel-size metadata, plus inrimage I/O.

Equivalent capability to the reference's external dependency
``openalea.image`` (``SpatialImage``, ``imread``/``imsave`` for the ``.inr``
inrimage format used by the MARS-ALT confocal segmentation pipeline) — see
SURVEY.md §1 "I/O & image type". Implemented from the public inrimage format
description (256-byte-block ASCII header + raw data), not ported.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

__all__ = ["SpatialImage", "imread", "imsave", "read_inrimage", "write_inrimage"]

_DEFAULT_VOXELSIZE = 1.0


class SpatialImage(np.ndarray):
    """ndarray subclass carrying per-axis physical voxel sizes.

    ``voxelsize`` (and its legacy alias ``resolution``) is ordered like the
    array axes. For a 3D stack indexed ``[z, y, x]`` the voxelsize is
    ``(vz, vy, vx)``.
    """

    def __new__(cls, array, voxelsize=None, resolution=None, **kwargs):
        obj = np.asarray(array).view(cls)
        if voxelsize is None:
            voxelsize = resolution
        if voxelsize is None:
            voxelsize = getattr(array, "voxelsize", None)
        if voxelsize is None:
            voxelsize = (_DEFAULT_VOXELSIZE,) * obj.ndim
        voxelsize = tuple(float(v) for v in voxelsize)
        if len(voxelsize) != obj.ndim:
            raise ValueError(
                f"voxelsize {voxelsize} does not match image ndim {obj.ndim}"
            )
        obj._voxelsize = voxelsize
        return obj

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self._voxelsize = getattr(obj, "_voxelsize", None)

    @property
    def voxelsize(self):
        vs = getattr(self, "_voxelsize", None)
        if vs is None or len(vs) != self.ndim:
            return (_DEFAULT_VOXELSIZE,) * self.ndim
        return vs

    @voxelsize.setter
    def voxelsize(self, value):
        value = tuple(float(v) for v in value)
        if len(value) != self.ndim:
            raise ValueError("voxelsize length must equal ndim")
        self._voxelsize = value

    # Legacy name used throughout the reference (SURVEY.md §3.1: reads
    # ``.resolution`` into a voxelsize tuple).
    @property
    def resolution(self):
        return self.voxelsize

    @resolution.setter
    def resolution(self, value):
        self.voxelsize = value


# ---------------------------------------------------------------------------
# inrimage (.inr / .inr.gz) reader & writer
# ---------------------------------------------------------------------------

_INR_HEADER_BLOCK = 256
_INR_MAGIC = "#INRIMAGE-4#{"

_NP_TO_INR = {
    np.dtype(np.uint8): ("unsigned fixed", 8),
    np.dtype(np.uint16): ("unsigned fixed", 16),
    np.dtype(np.uint32): ("unsigned fixed", 32),
    np.dtype(np.uint64): ("unsigned fixed", 64),
    np.dtype(np.int8): ("signed fixed", 8),
    np.dtype(np.int16): ("signed fixed", 16),
    np.dtype(np.int32): ("signed fixed", 32),
    np.dtype(np.int64): ("signed fixed", 64),
    np.dtype(np.float32): ("float", 32),
    np.dtype(np.float64): ("float", 64),
}


def _inr_dtype(type_str: str, pixsize_bits: int) -> np.dtype:
    kind = {"unsigned fixed": "u", "signed fixed": "i", "float": "f"}[type_str]
    return np.dtype(f"<{kind}{pixsize_bits // 8}")


def write_inrimage(path: str, image: np.ndarray) -> None:
    """Write an array as .inr: 2D ``[Y,X]``, 3D ``[Z,Y,X]``, or vectorial
    4D ``[Z,Y,X,V]`` (VDIM=V, components interlaced per voxel — the
    inrimage convention for multichannel confocal stacks)."""
    img = np.asarray(image)
    voxelsize = getattr(image, "voxelsize", (_DEFAULT_VOXELSIZE,) * img.ndim)
    vdim = 1
    if img.ndim == 2:
        zdim, (ydim, xdim) = 1, img.shape
        vz, (vy, vx) = 1.0, voxelsize[:2]
    elif img.ndim == 3:
        zdim, ydim, xdim = img.shape
        vz, vy, vx = voxelsize[:3]
    elif img.ndim == 4:
        zdim, ydim, xdim, vdim = img.shape
        vz, vy, vx = voxelsize[:3]
    else:
        raise ValueError(f"inrimage supports 2D/3D/4D arrays, got ndim={img.ndim}")
    if img.dtype not in _NP_TO_INR:
        raise ValueError(f"unsupported dtype for inrimage: {img.dtype}")
    type_str, bits = _NP_TO_INR[img.dtype]
    header = (
        f"{_INR_MAGIC}\n"
        f"XDIM={xdim}\n"
        f"YDIM={ydim}\n"
        f"ZDIM={zdim}\n"
        f"VDIM={vdim}\n"
        f"TYPE={type_str}\n"
        f"PIXSIZE={bits} bits\n"
        f"SCALE=2**0\n"
        f"CPU=decm\n"
        f"VX={vx}\n"
        f"VY={vy}\n"
        f"VZ={vz}\n"
    )
    pad = _INR_HEADER_BLOCK - (len(header) + 4) % _INR_HEADER_BLOCK
    header += "\n" * pad + "##}\n"
    data = np.ascontiguousarray(img, dtype=img.dtype.newbyteorder("<")).tobytes()
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(data)


def read_inrimage(path: str) -> SpatialImage:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    end = raw.find(b"##}")
    if not raw.startswith(_INR_MAGIC.encode()) or end < 0:
        raise ValueError(f"{path} is not an inrimage file")
    data_start = raw.find(b"\n", end) + 1
    fields = {}
    for line in raw[:end].decode("ascii", "ignore").splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            fields[k.strip()] = v.strip()
    xdim, ydim, zdim = (int(fields[k]) for k in ("XDIM", "YDIM", "ZDIM"))
    vdim = int(fields.get("VDIM", 1))
    dtype = _inr_dtype(fields["TYPE"], int(fields["PIXSIZE"].split()[0]))
    count = xdim * ydim * zdim * vdim
    arr = np.frombuffer(raw, dtype=dtype, count=count, offset=data_start)
    vx = float(fields.get("VX", _DEFAULT_VOXELSIZE))
    vy = float(fields.get("VY", _DEFAULT_VOXELSIZE))
    vz = float(fields.get("VZ", _DEFAULT_VOXELSIZE))
    if vdim > 1:
        # vectorial image: components are interlaced per voxel — read into
        # a trailing channel axis (unit "voxelsize" for the channel axis)
        if zdim == 1:
            return SpatialImage(
                arr.reshape(ydim, xdim, vdim).copy(), voxelsize=(vy, vx, 1.0)
            )
        return SpatialImage(
            arr.reshape(zdim, ydim, xdim, vdim).copy(),
            voxelsize=(vz, vy, vx, 1.0),
        )
    if zdim == 1:
        return SpatialImage(arr.reshape(ydim, xdim).copy(), voxelsize=(vy, vx))
    return SpatialImage(arr.reshape(zdim, ydim, xdim).copy(), voxelsize=(vz, vy, vx))


def imread(path: str) -> SpatialImage:
    """Read an image; .inr/.inr.gz use the inrimage reader, .npy/.npz numpy."""
    p = str(path)
    if p.endswith((".inr", ".inr.gz")):
        return read_inrimage(p)
    if p.endswith(".npy"):
        return SpatialImage(np.load(p))
    if p.endswith(".npz"):
        with np.load(p) as z:
            img = z["image"]
            vs = tuple(z["voxelsize"]) if "voxelsize" in z else None
        return SpatialImage(img, voxelsize=vs)
    raise ValueError(f"unsupported image format: {path}")


def imsave(path: str, image: np.ndarray) -> None:
    p = str(path)
    if p.endswith((".inr", ".inr.gz")):
        write_inrimage(p, image)
    elif p.endswith(".npy"):
        np.save(p, np.asarray(image))
    elif p.endswith(".npz"):
        vs = getattr(image, "voxelsize", (_DEFAULT_VOXELSIZE,) * np.ndim(image))
        np.savez_compressed(p, image=np.asarray(image), voxelsize=np.asarray(vs))
    else:
        raise ValueError(f"unsupported image format: {path}")
    if not os.path.exists(p):  # pragma: no cover - sanity
        raise IOError(f"failed to write {p}")
