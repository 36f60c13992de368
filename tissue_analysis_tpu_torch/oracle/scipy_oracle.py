"""Golden oracle: the reference's semantics in direct scipy.ndimage calls.

The port's copy of ``tissue_analysis_tpu/oracle/scipy_oracle.py``: host
scipy and numpy, importing only ``features.finalize``, so it runs where JAX
does not. Written from SURVEY.md §3's behavioural traces of
``VirtualPlants/tissue_analysis``, it is the executable parity target for
the engines:

- volume        → ``nd.sum(ones, img, index)``           (§3.2)
- barycenter    → ``nd.center_of_mass``                   (§3.2)
- boundingbox   → ``nd.find_objects`` (1-indexed, None-for-absent) (§3.2)
- neighbors     → per-label ``nd.binary_dilation`` with the default cross
                  structuring element = 6-connectivity in 3D (§3.3)
- wall faces    → per-axis shifted comparisons, each adjacent voxel pair
                  counted once; anisotropic face areas ∏v/v_d (§3.4)
- inertia_axis  → exact integer coordinate moments routed through the SAME
                  canonical finalizer as the engine (features.finalize), so
                  float results are bit-comparable (§7 exactness rule)

This module is deliberately slow (it IS the baseline cost model, BASELINE.md).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.ndimage as nd

from tissue_analysis_tpu_torch.features import finalize

__all__ = ["ScipyOracle"]


def _dilate_slices(slices, shape, amount=1):
    """Grow a slice tuple by ``amount``, clamped to the array (``:: dilation``)."""
    return tuple(
        slice(max(0, s.start - amount), min(dim, s.stop + amount))
        for s, dim in zip(slices, shape)
    )


class ScipyOracle:
    def __init__(self, image, voxelsize=None, background: Optional[int] = 1):
        self.image = np.asarray(image)
        if voxelsize is None:
            voxelsize = getattr(image, "voxelsize", (1.0,) * self.image.ndim)
        self.voxelsize = tuple(float(v) for v in voxelsize)
        self.background = background
        self.labels = np.unique(self.image).astype(np.int64)

    # ------------------------------------------------------------- features
    def volume(self, real: bool = True) -> Dict[int, float]:
        ones = np.ones_like(self.image, dtype=np.float64)
        vals = nd.sum(ones, self.image, index=self.labels)
        if real:
            vals = vals * float(np.prod(np.asarray(self.voxelsize, np.float64)))
        return {int(l): v for l, v in zip(self.labels, np.atleast_1d(vals))}

    def barycenter(self, real: bool = True) -> Dict[int, np.ndarray]:
        ones = np.ones_like(self.image, dtype=np.float64)
        coms = nd.center_of_mass(ones, self.image, index=self.labels)
        out = {}
        for l, c in zip(self.labels, coms):
            c = np.asarray(c, dtype=np.float64)
            if real:
                c = c * np.asarray(self.voxelsize, np.float64)
            out[int(l)] = c
        return out

    def boundingbox(self) -> Dict[int, Optional[Tuple[slice, ...]]]:
        img = self.image.astype(np.int64)
        objs = nd.find_objects(img)  # slot i ↔ label i+1
        out: Dict[int, Optional[Tuple[slice, ...]]] = {}
        for l in self.labels:
            li = int(l)
            out[li] = objs[li - 1] if 1 <= li <= len(objs) else None
        return out

    # ------------------------------------------------------------ adjacency
    def neighbors(
        self,
        labels: Optional[Sequence[int]] = None,
        connectivity: int = 1,
        min_contact_area: Optional[float] = None,
        real: bool = True,
    ) -> Dict[int, List[int]]:
        """Per-label dilation adjacency (SURVEY.md §3.3)."""
        img = self.image
        struct = nd.generate_binary_structure(img.ndim, connectivity)
        bboxes = self.boundingbox()
        areas = self.wall_pairs(real=real) if min_contact_area is not None else None
        out: Dict[int, List[int]] = {}
        for l in self.labels if labels is None else labels:
            li = int(l)
            bb = bboxes.get(li)
            if bb is None:
                out[li] = []
                continue
            sl = _dilate_slices(bb, img.shape)
            sub = img[sl]
            mask = sub == li
            dil = nd.binary_dilation(mask, structure=struct)
            neigh = np.unique(sub[dil & ~mask])
            nl = [int(x) for x in neigh]
            if min_contact_area is not None:
                nl = [
                    x
                    for x in nl
                    if areas.get((min(li, x), max(li, x)), 0.0) >= min_contact_area
                ]
            out[li] = sorted(nl)
        return out

    def wall_pairs(self, real: bool = True) -> Dict[Tuple[int, int], float]:
        """{(a, b) a<b: wall measure} — real area or total face count.

        Each 6-adjacent voxel pair with differing labels contributes one
        face; per-axis face area = ∏voxelsize / voxelsize_d (§3.4).
        """
        img = self.image
        v = np.asarray(self.voxelsize, np.float64)
        face_area = np.prod(v) / v
        out: Dict[Tuple[int, int], float] = {}
        for d in range(img.ndim):
            sl_a = [slice(None)] * img.ndim
            sl_b = [slice(None)] * img.ndim
            sl_a[d] = slice(0, -1)
            sl_b[d] = slice(1, None)
            a = img[tuple(sl_a)].ravel()
            b = img[tuple(sl_b)].ravel()
            diff = a != b
            a, b = a[diff].astype(np.int64), b[diff].astype(np.int64)
            lo = np.minimum(a, b)
            hi = np.maximum(a, b)
            key = lo * (int(self.labels.max()) + 1) + hi
            uk, cnt = np.unique(key, return_counts=True)
            w = float(face_area[d]) if real else 1.0
            base = int(self.labels.max()) + 1
            for k, c in zip(uk, cnt):
                pair = (int(k // base), int(k % base))
                out[pair] = out.get(pair, 0.0) + c * w
        return out

    def cell_wall_surface(self, l1: int, l2: int, real: bool = True) -> float:
        pair = (min(l1, l2), max(l1, l2))
        return self.wall_pairs(real=real).get(pair, 0.0)

    # ----------------------------------------------- epidermis/L1/margins
    def cells_in_image_margins(self) -> List[int]:
        img = self.image
        vals = []
        for d in range(img.ndim):
            vals.append(np.take(img, 0, axis=d).ravel())
            vals.append(np.take(img, img.shape[d] - 1, axis=d).ravel())
        return sorted(int(x) for x in np.unique(np.concatenate(vals)))

    def l1(self) -> List[int]:
        """Cells adjacent to background (``:: L1``)."""
        if self.background is None:
            return []
        nbh = self.neighbors()
        return sorted(
            int(l)
            for l in self.labels
            if int(l) != self.background and self.background in nbh[int(l)]
        )

    def epidermis_surface(self, real: bool = True) -> Dict[int, float]:
        """Wall area with the background per L1 cell (``:: epidermis_surface``)."""
        if self.background is None:
            return {}
        pairs = self.wall_pairs(real=real)
        out: Dict[int, float] = {}
        for (a, b), area in pairs.items():
            if a == self.background and b != self.background:
                out[b] = out.get(b, 0.0) + area
            elif b == self.background and a != self.background:
                out[a] = out.get(a, 0.0) + area
        return out

    # ------------------------------------------------------------- moments
    def integer_moments(self):
        """Exact int64 moments per label — engine-comparable ground truth."""
        img = self.image
        labels = self.labels
        d = img.ndim
        pairs = finalize.tri_pairs(d)
        n = labels.shape[0]
        count = np.zeros(n, np.int64)
        s1 = np.zeros((n, d), np.int64)
        s2 = np.zeros((n, len(pairs)), np.int64)
        cmin = np.zeros((n, d), np.int64)
        cmax = np.zeros((n, d), np.int64)
        for k, l in enumerate(labels):
            coords = np.nonzero(img == l)
            count[k] = coords[0].shape[0]
            if count[k] == 0:
                continue
            cs = [c.astype(np.int64) for c in coords]
            for a in range(d):
                s1[k, a] = cs[a].sum()
                cmin[k, a] = cs[a].min()
                cmax[k, a] = cs[a].max()
            for col, (i, j) in enumerate(pairs):
                s2[k, col] = np.sum(cs[i] * cs[j])
        return count, s1, s2, cmin, cmax

    def inertia_axes(self, real: bool = True):
        count, s1, s2, _, _ = self.integer_moments()
        evals, evecs = finalize.inertia_axes(
            count, s1, s2, self.voxelsize if real else None
        )
        return (
            {int(l): evals[k] for k, l in enumerate(self.labels)},
            {int(l): evecs[k] for k, l in enumerate(self.labels)},
        )
