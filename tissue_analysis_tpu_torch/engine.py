"""One-call fused analysis: labeled image → FeatureTable.

The whole per-voxel work is ONE per-block sweep (``ops/block_sweep.py``),
followed by a small combine and pair reduction on the same device
(``ops/combine.py``) and an exact host assembly. Two engines give
bit-identical tables:

- ``"cuda"``  — the hand-written CUDA kernel (a stack on a CUDA device);
- ``"torch"`` — its plain PyTorch version (any device).

``engine="auto"`` picks ``"cuda"`` for a CUDA stack and ``"torch"`` for a
CPU stack. Nothing falls back from one engine to another: a failing kernel
raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from tissue_analysis_tpu_torch.core.stack import LabeledStack
from tissue_analysis_tpu_torch.features.table import FeatureTable
from tissue_analysis_tpu_torch.ops import combine
from tissue_analysis_tpu_torch.ops.block_sweep import (
    DEFAULT_BLOCK,
    block_sweep,
    block_sweep_reference,
)
from tissue_analysis_tpu_torch.utils import timing

__all__ = ["analyze", "analyze_stack", "ENGINES"]

ENGINES = ("auto", "cuda", "torch")

#: dictionary-size doublings tried after an overflow before giving up
MAX_DICT_RETRIES = 4

# converged dictionary size per (shape, n, requested L): repeated analyses
# of same-sized stacks skip the overflow discovery sweeps
_GOOD_L: dict = {}


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


def analyze_stack(
    stack: LabeledStack, engine: str = "auto", L: int = 32
) -> FeatureTable:
    """Labeled stack → FeatureTable in one fused device pass.

    ``L`` is the starting per-block dictionary size; a block with more
    labels makes the sweep rerun with L doubled (at most
    ``MAX_DICT_RETRIES`` times), and the converged size is remembered for
    later stacks of the same shape and label count."""
    if stack.ndim != 3:
        raise NotImplementedError(
            "2D stacks are not ported yet (ROADMAP.md, Queue 1: 2D images "
            "through the z=1 lift)"
        )
    sweep = _pick_sweep(stack, engine)
    n = stack.n_labels
    dev = stack.device
    voxels = int(np.prod(stack.shape))
    key = (stack.shape, n, int(L))
    Lc = _GOOD_L.get(key, int(L))
    for _attempt in range(MAX_DICT_RETRIES + 1):
        with timing.stage("device sweep (block)", voxels, dev):
            out = sweep(stack.dense, n, DEFAULT_BLOCK, Lc)
            overflow = bool(out.ovf.any())
        if not overflow:
            break
        Lc *= 2
    else:
        raise RuntimeError(
            f"per-block dictionary still overflows at L={Lc // 2}"
        )
    _GOOD_L[key] = Lc

    with timing.stage("combine + pair reduce", None, dev):
        mom, cmin, cmax = combine.combine_moments(
            out.ids, out.mom, out.gmin, out.gmax, n
        )
        pkey, ptotal = combine.reduce_pairs(out.ids, out.faces, n)
    with timing.stage("readback + host assemble"):
        mom = mom.cpu().numpy()
        cmin = cmin.cpu().numpy().astype(np.int64)
        cmax = cmax.cpu().numpy().astype(np.int64)
        pair_lo, pair_hi, counts3 = combine.decode_pairs(
            pkey.cpu().numpy(), ptotal.cpu().numpy(), n
        )
    count = mom[:, 0].copy()
    empty = count == 0
    cmin[empty] = 0
    cmax[empty] = 0
    return FeatureTable(
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


def _margin_from_bbox(count, cmin, cmax, shape) -> np.ndarray:
    """A label touches an image face iff its bbox does (exact equivalence)."""
    present = count > 0
    lo = (cmin == 0).any(axis=1)
    hi = (cmax == (np.asarray(shape, dtype=np.int64) - 1)).any(axis=1)
    return present & (lo | hi)


def analyze(
    image,
    voxelsize: Optional[Tuple[float, ...]] = None,
    background: Optional[int] = 1,
    device=None,
) -> FeatureTable:
    """Analyze a labeled image (host array / SpatialImage) in one fused pass
    on ``device`` (default: the CPU)."""
    stack = LabeledStack.from_array(
        image, voxelsize=voxelsize, background=background, device=device
    )
    return analyze_stack(stack)
