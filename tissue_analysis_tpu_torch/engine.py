"""One-call fused analysis: labeled image → FeatureTable.

The whole per-voxel work is ONE per-block sweep (``ops/block_sweep.py``),
followed by a small combine and pair reduction on the same device
(``ops/combine.py``) and an exact host assembly. A 2D image is swept as a
``[1, Y, X]`` view with flat ``(1, 128, 128)`` blocks and its synthetic z
axis is dropped afterwards. :func:`analyze_raw` sweeps the raw label values
directly (no host relabel) and compacts the result on the host. Two engines
give bit-identical tables:

- ``"cuda"``  — the hand-written CUDA kernel (a stack on a CUDA device);
- ``"torch"`` — its plain PyTorch version (any device).

``engine="auto"`` picks ``"cuda"`` for a CUDA stack and ``"torch"`` for a
CPU stack. Nothing falls back from one engine to another: a failing kernel
raises.

:func:`dispatch_stack` launches a sweep without waiting for the device and
:func:`collect_stack` finishes it (overflow reruns, combine, readback), so a
caller can relabel the next frame or slab while the card sweeps this one;
:func:`analyze_stack` is the two in a row.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tissue_analysis_tpu_torch.core.stack import (
    LabeledStack,
    dense_dtype,
    resolve_device,
    widened,
)
from tissue_analysis_tpu_torch.features.table import FeatureTable
from tissue_analysis_tpu_torch.ops import combine
from tissue_analysis_tpu_torch.ops.block_sweep import (
    DEFAULT_BLOCK,
    PLAIN_MAX_DICT,
    SweepOut,
    block_sweep,
    block_sweep_reference,
    max_dict_size,
)
from tissue_analysis_tpu_torch.utils import timing

__all__ = [
    "analyze",
    "analyze_raw",
    "analyze_stack",
    "collect_stack",
    "dispatch_stack",
    "resolve_engine",
    "ENGINES",
]

ENGINES = ("auto", "cuda", "torch")

# the JAX package's engine names → the port's (``ENGINES``)
_ENGINE_NAMES = {
    "auto": "auto",
    "cuda": "cuda",
    "torch": "torch",
    "pallas": "cuda",
    "blocked": "torch",
    "chunked": "torch",
}

#: block of the lifted [1, Y, X] sweep of a 2D image (as the TPU engine's)
BLOCK_2D = (1, 128, 128)

# converged dictionary size per (shape, n, block, requested L): repeated
# analyses of same-sized stacks skip the overflow discovery sweeps. The
# block is part of the key: a [1, Y, X] stack and a lifted 2D image share
# shape and n but not the block, nor the labels per block.
_GOOD_L: dict = {}


def resolve_engine(name: str) -> str:
    """Map an engine name (port or JAX package) to the port's engine."""
    if name not in _ENGINE_NAMES:
        raise ValueError(
            f"unknown engine {name!r}; expected one of {sorted(_ENGINE_NAMES)}"
        )
    return _ENGINE_NAMES[name]


def _pick_sweep(stack: LabeledStack, engine: str):
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    on_cuda = stack.device.type == "cuda"
    if engine == "auto":
        engine = "cuda" if on_cuda else "torch"
    if engine == "cuda":
        if not on_cuda:
            raise ValueError(
                f"engine 'cuda' needs a stack on a CUDA device, got {stack.device}"
            )
        return block_sweep
    return block_sweep_reference


class Dispatched(NamedTuple):
    """A launched sweep (:func:`dispatch_stack`) awaiting :func:`collect_stack`."""

    stack: LabeledStack  # the swept stack ([1, Y, X] for a 2D image)
    image: LabeledStack  # the stack as given
    sweep: object
    block: tuple
    key: tuple
    L: int
    n_sweep: int
    out: SweepOut


def analyze_stack(
    stack: LabeledStack, engine: str = "auto", L: int = 32,
    n_bucket: Optional[int] = None,
) -> FeatureTable:
    """Labeled stack → FeatureTable in one fused device pass.

    ``L`` is the starting per-block dictionary size; a block with more
    labels makes the sweep rerun with L doubled, up to the engine's bound
    (:func:`~tissue_analysis_tpu_torch.ops.block_sweep.max_dict_size` for
    the kernel), and the converged size is remembered for later stacks of
    the same shape, label count and block. A 2D stack is swept as
    ``[1, Y, X]`` with block :data:`BLOCK_2D`.

    ``n_bucket`` sweeps a label space of ``max(n_labels, n_bucket)``; the
    rows past ``n_labels`` stay empty and are sliced away on the device, so
    the table equals the exact-n one. The reference buckets to share one
    compilation across time-series frames; the port compiles nothing per
    shape, so the bucket only keeps the reference's contract (and frames of
    one bucket share a converged dictionary size)."""
    return collect_stack(dispatch_stack(stack, engine, L, n_bucket))


def dispatch_stack(
    stack: LabeledStack, engine: str = "auto", L: int = 32,
    n_bucket: Optional[int] = None,
) -> Dispatched:
    """Launch the sweep of ``stack`` at the converged dictionary size without
    waiting for the device; :func:`collect_stack` finishes it."""
    image = stack
    if stack.ndim == 2:
        stack, block = _lift_2d(stack), BLOCK_2D
    elif stack.ndim == 3:
        block = DEFAULT_BLOCK
    else:
        raise ValueError(f"expected a 2D or 3D stack, got shape {stack.shape}")
    sweep = _pick_sweep(stack, engine)
    n = stack.n_labels
    n_sweep = n if n_bucket is None else max(n, int(n_bucket))
    key = (stack.shape, n_sweep, tuple(block), int(L))
    Lc = _GOOD_L.get(key, int(L))
    with timing.stage("device sweep (block)", int(np.prod(stack.shape)), stack.device):
        out = sweep(stack.dense, n_sweep, block, Lc)
    return Dispatched(stack, image, sweep, block, key, Lc, n_sweep, out)


def collect_stack(d: Dispatched) -> FeatureTable:
    """Finish a dispatched sweep: rerun with L doubled while a block
    overflows (``RuntimeError`` past the engine's bound), then combine,
    reduce the pairs, read back and assemble the table."""
    stack, out, Lc = d.stack, d.out, d.L
    dev = stack.device
    n, n_sweep = stack.n_labels, d.n_sweep
    while bool(out.ovf.any()):
        bound = max_dict_size() if d.sweep is block_sweep else PLAIN_MAX_DICT
        if Lc >= bound:
            raise RuntimeError(
                f"per-block dictionary still overflows at L={Lc}, the largest "
                f"this engine takes"
            )
        Lc = min(2 * Lc, bound)
        with timing.stage("device sweep (block)", int(np.prod(stack.shape)), dev):
            out = d.sweep(stack.dense, n_sweep, d.block, Lc)
    _GOOD_L[d.key] = Lc

    with timing.stage("combine + pair reduce", None, dev):
        mom, cmin, cmax = combine.combine_moments(
            out.ids, out.mom, out.gmin, out.gmax, n_sweep
        )
        pkey, ptotal = combine.reduce_pairs(out.ids, out.faces, n_sweep)
    with timing.stage("readback + host assemble"):
        mom = mom[:n].cpu().numpy()
        cmin = cmin[:n].cpu().numpy().astype(np.int64)
        cmax = cmax[:n].cpu().numpy().astype(np.int64)
        pair_lo, pair_hi, counts3 = combine.decode_pairs(
            pkey.cpu().numpy(), ptotal.cpu().numpy(), n_sweep
        )
    count = mom[:, 0].copy()
    empty = count == 0
    cmin[empty] = 0
    cmax[empty] = 0
    table = FeatureTable(
        ids=stack.ids.copy(),
        shape=stack.shape,
        voxelsize=stack.voxelsize,
        background_segment=stack.background_segment,
        count=count,
        s1=mom[:, 1:4].copy(),
        s2=mom[:, 4:10].copy(),
        cmin=cmin,
        cmax=cmax,
        pair_lo=pair_lo,
        pair_hi=pair_hi,
        wall_face_counts=counts3,
        margin=_margin_from_bbox(count, cmin, cmax, stack.shape),
    )
    return _strip_z(table, d.image) if d.image.ndim == 2 else table


def _margin_from_bbox(count, cmin, cmax, shape) -> np.ndarray:
    """A label touches an image face iff its bbox does (exact equivalence)."""
    present = count > 0
    lo = (cmin == 0).any(axis=1)
    hi = (cmax == (np.asarray(shape, dtype=np.int64) - 1)).any(axis=1)
    return present & (lo | hi)


def _lift_2d(stack: LabeledStack) -> LabeledStack:
    """[Y, X] stack → [1, Y, X] view, so 2D rides the 3D block sweep."""
    return LabeledStack(
        dense=stack.dense[None],
        ids=stack.ids,
        voxelsize=(1.0,) + stack.voxelsize,
        background_segment=stack.background_segment,
    )


def _strip_z(table: FeatureTable, stack: LabeledStack) -> FeatureTable:
    """Drop the synthetic z axis from a lifted-2D feature table.

    z moments are identically zero (all coordinates 0); s2 keeps the
    (yy, yx, xx) columns — the order is zz, zy, zx, yy, yx, xx. The margin
    is recomputed from the 2D bbox: in the lifted stack every label touches
    both z faces.
    """
    return FeatureTable(
        ids=table.ids,
        shape=stack.shape,
        voxelsize=stack.voxelsize,
        background_segment=table.background_segment,
        count=table.count,
        s1=table.s1[:, 1:],
        s2=table.s2[:, 3:6],
        cmin=table.cmin[:, 1:],
        cmax=table.cmax[:, 1:],
        pair_lo=table.pair_lo,
        pair_hi=table.pair_hi,
        wall_face_counts=table.wall_face_counts[:, 1:],
        margin=_margin_from_bbox(
            table.count, table.cmin[:, 1:], table.cmax[:, 1:], stack.shape
        ),
    )


def analyze(
    image,
    voxelsize: Optional[Tuple[float, ...]] = None,
    background: Optional[int] = 1,
    device=None,
    engine: str = "auto",
) -> FeatureTable:
    """Analyze a labeled image (host array / SpatialImage) in one fused pass
    on ``device`` (default: the current CUDA device; ``"cpu"`` runs the
    plain engine on the CPU)."""
    stack = LabeledStack.from_array(
        image, voxelsize=voxelsize, background=background, device=device
    )
    return analyze_stack(stack, engine=engine)


def analyze_raw(
    image,
    voxelsize: Optional[Tuple[float, ...]] = None,
    background: Optional[int] = 1,
    engine: str = "auto",
    max_raw_id: int = 1 << 20,
    device=None,
) -> FeatureTable:
    """Analyze the RAW labeled image on ``device`` with no host relabel.

    The raw array goes to the device as it is; the id range is taken there
    and the sweep runs in the raw id space ``n = max + 1`` (every label is
    its own segment id). A host compaction (:func:`_compact_raw_table`,
    O(labels + pairs)) then rebuilds the standard convention, so the
    result is bit-identical to ``analyze(image, ...)``.

    Negative labels, ids ≥ ``max_raw_id`` (a sparse huge id would inflate
    the per-label tables) and 2D images take the relabel path
    (:func:`analyze`) instead: these are input rules, not device fallbacks.
    """
    dev = resolve_device(device)
    arr = np.asarray(image)
    if voxelsize is None:
        voxelsize = getattr(image, "voxelsize", None)
    if voxelsize is None:
        voxelsize = (1.0,) * arr.ndim
    voxelsize = tuple(float(v) for v in voxelsize)
    if len(voxelsize) != arr.ndim:
        raise ValueError("voxelsize length must equal image ndim")
    if not np.issubdtype(arr.dtype, np.integer):
        raise TypeError(
            f"labeled images must have an integer dtype, got {arr.dtype}"
        )
    if arr.ndim != 3:
        return analyze(arr, voxelsize, background, dev, engine)
    voxels = int(arr.size)
    with timing.stage("ingest: host->device transfer (raw)", voxels, dev):
        raw = torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(dev)
    with timing.stage("ingest: device id-range scan", None, dev):
        mn, mx = (int(v) for v in torch.aminmax(widened(raw)))
    if mn < 0 or mx >= max_raw_id:
        return analyze(arr, voxelsize, background, dev, engine)
    n_sweep = mx + 1
    want = dense_dtype(n_sweep)[1]
    dense = raw if raw.dtype == want else raw.to(want)
    bseg = (
        int(background)
        if background is not None and 0 <= int(background) <= mx
        else None
    )
    stack = LabeledStack(
        dense=dense,
        ids=np.arange(n_sweep, dtype=np.int64),
        voxelsize=voxelsize,
        background_segment=bseg,
    )
    table = analyze_stack(stack, engine=engine)
    with timing.stage("raw-mode host compaction"):
        return _compact_raw_table(table, background)


def _compact_raw_table(t: FeatureTable, background) -> FeatureTable:
    """Raw-id-space table (one row per id in 0..max) → standard convention.

    Present labels are exactly the rows with voxels; absent ids cannot occur
    in pairs (both sides of a pair have voxels). Reproduces
    ``LabeledStack.from_array``'s convention bit for bit: ids ascending with
    the background swapped to segment 0, and the pair COO re-sorted
    ascending by (lo << 32 | hi) in the new segment space.
    """
    ids = np.nonzero(t.count > 0)[0].astype(np.int64)
    n_new = int(ids.shape[0])
    perm = np.arange(n_new)
    bseg = None
    if background is not None:
        pos = int(np.searchsorted(ids, int(background)))
        if pos < n_new and ids[pos] == int(background):
            if pos != 0:
                perm[[0, pos]] = perm[[pos, 0]]
            bseg = 0
    new_ids = ids[perm]
    seg_of_raw = np.zeros(t.n_labels, dtype=np.int64)
    seg_of_raw[new_ids] = np.arange(n_new)
    plo = seg_of_raw[t.pair_lo]
    phi = seg_of_raw[t.pair_hi]
    lo = np.minimum(plo, phi)
    hi = np.maximum(plo, phi)
    order = np.argsort((lo << 32) | hi)
    return FeatureTable(
        ids=new_ids,
        shape=t.shape,
        voxelsize=t.voxelsize,
        background_segment=bseg,
        count=t.count[new_ids],
        s1=t.s1[new_ids],
        s2=t.s2[new_ids],
        cmin=t.cmin[new_ids],
        cmax=t.cmax[new_ids],
        pair_lo=lo[order].astype(np.int32),
        pair_hi=hi[order].astype(np.int32),
        wall_face_counts=t.wall_face_counts[order],
        margin=t.margin[new_ids],
    )
