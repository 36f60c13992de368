"""Deterministic synthetic segmented stacks for tests and benchmarks.

Recipe from SURVEY.md §4.0 (used for the baseline measurements): Voronoi
labels around random seed points via ``distance_transform_edt`` nearest-seed
indices, labels starting at 2 (label 1 = background), voxels outside a
centered sphere (radius ``0.95·n/2``) set to background — which gives every
stack an epidermis (L1) layer and margin background like a real segmented
meristem stack.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.ndimage as nd

from tissue_analysis_tpu_torch.core.spatial_image import SpatialImage

__all__ = ["voronoi_stack", "two_slab_image", "single_cube_image", "grid_stack", "monolayer_shell"]


def voronoi_stack(
    shape: Tuple[int, ...],
    ncells: int,
    seed: int = 0,
    background: int = 1,
    sphere: bool = True,
    voxelsize: Optional[Tuple[float, ...]] = None,
    dtype=np.uint16,
) -> SpatialImage:
    """Synthetic segmented tissue stack (2D or 3D).

    Labels are ``background`` outside the tissue sphere and ``2..ncells+1``
    (minus any empty Voronoi cells) inside.
    """
    shape = tuple(int(s) for s in shape)
    ndim = len(shape)
    rng = np.random.default_rng(seed)
    seeds = np.stack(
        [rng.integers(0, s, size=ncells) for s in shape], axis=1
    )  # [ncells, ndim]

    seed_img = np.zeros(shape, dtype=bool)
    seed_img[tuple(seeds.T)] = True
    # nearest-seed voxel indices -> Voronoi regions
    _, indices = nd.distance_transform_edt(~seed_img, return_indices=True)
    nearest = tuple(indices[d] for d in range(ndim))
    seed_label = np.zeros(shape, dtype=np.int64)
    # last writer wins for coincident seeds — deterministic
    seed_label[tuple(seeds.T)] = np.arange(ncells, dtype=np.int64) + 2
    labels = seed_label[nearest]

    if sphere:
        center = [(s - 1) / 2.0 for s in shape]
        radius = 0.95 * min(shape) / 2.0
        grids = np.ogrid[tuple(slice(0, s) for s in shape)]
        dist2 = sum((g - c) ** 2 for g, c in zip(grids, center))
        labels[dist2 > radius * radius] = background
    if np.issubdtype(dtype, np.integer):
        assert labels.max() <= np.iinfo(dtype).max
    img = labels.astype(dtype)
    if voxelsize is None:
        voxelsize = (1.0,) * ndim
    return SpatialImage(img, voxelsize=voxelsize)


def two_slab_image(
    shape=(8, 8, 8), axis=0, background=None, voxelsize=None
) -> SpatialImage:
    """Two labels split along an axis — the minimal adjacency edge case."""
    img = np.full(shape, 2, dtype=np.uint8)
    half = shape[axis] // 2
    sl = [slice(None)] * len(shape)
    sl[axis] = slice(half, None)
    img[tuple(sl)] = 3
    if background is not None:
        img[(0,) * len(shape)] = background
    return SpatialImage(img, voxelsize=voxelsize or (1.0,) * len(shape))


def single_cube_image(shape=(12, 12, 12), background=1, voxelsize=None) -> SpatialImage:
    """One cubic cell floating in background."""
    img = np.full(shape, background, dtype=np.uint8)
    sl = tuple(slice(s // 4, 3 * s // 4) for s in shape)
    img[sl] = 5
    return SpatialImage(img, voxelsize=voxelsize or (1.0,) * len(shape))


def grid_stack(
    shape: Tuple[int, ...],
    cell: Tuple[int, ...],
    voxelsize: Optional[Tuple[float, ...]] = None,
) -> SpatialImage:
    """Regular grid of box cells — analytic ground truth at any label count.

    Cell (i, j, k) of extent ``cell`` gets label ``1 + flat_index`` (labels
    1..N, no background). Shape must be divisible by ``cell``. Used by the
    high-label-count tests (>2^16 cells) where the per-label scipy-dilation
    oracle is too slow but adjacency/moments are known in closed form.
    """
    if any(s % c for s, c in zip(shape, cell)):
        raise ValueError("shape must be divisible by cell")
    grid = tuple(s // c for s, c in zip(shape, cell))
    n = int(np.prod(grid))
    labels = np.arange(1, n + 1, dtype=np.int64).reshape(grid)
    out = labels
    for ax, c in enumerate(cell):
        out = np.repeat(out, c, axis=ax)
    dtype = np.uint16 if n + 1 <= 0xFFFF else np.int32
    return SpatialImage(out.astype(dtype), voxelsize=voxelsize)


def monolayer_shell(
    shape: Tuple[int, int, int] = (40, 40, 40),
    ncells: int = 48,
    seed: int = 0,
    background: int = 1,
    inside: int = 2,
    r_out: float = 0.44,
    thickness: float = 0.16,
    voxelsize: Optional[Tuple[float, float, float]] = None,
) -> SpatialImage:
    """Curved one-cell-thick monolayer over an inside filler (surfacic
    fixture for ``SpatialImageAnalysis3DS``).

    A spherical shell (outer radius ``r_out``·min(shape), thickness
    ``thickness``·min(shape)) is Voronoi-partitioned between ``ncells``
    seeds on the mid-surface (labels ``inside+1 ...``); everything outside
    the shell is ``background``, everything beneath it the unsegmented
    ``inside`` filler — the surface-segmentation layout of MARS-style
    meristem stacks.
    """
    rng = np.random.default_rng(seed)
    c = (np.asarray(shape, np.float64) - 1) / 2
    scale = min(shape)
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    pos = np.stack([zz, yy, xx], axis=-1).astype(np.float64) - c
    r = np.sqrt((pos**2).sum(-1))
    ro = r_out * scale
    ri = (r_out - thickness) * scale
    shell = (r <= ro) & (r > ri)

    dirs = rng.normal(size=(ncells, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    seeds = dirs * (ro + ri) / 2
    # nearest seed per shell voxel (ncells is small: brute force is fine)
    sv = pos[shell]  # [M, 3]
    d2 = ((sv[:, None, :] - seeds[None, :, :]) ** 2).sum(-1)
    lab = np.argmin(d2, axis=1).astype(np.int64) + inside + 1

    img = np.full(shape, background, dtype=np.uint16)
    img[r <= ri] = inside
    img[shell] = lab
    return SpatialImage(img, voxelsize=voxelsize or (1.0, 1.0, 1.0))
