"""One-call fused analysis: labeled image → FeatureTable.

The whole per-voxel work is ONE per-block sweep (``ops/block_sweep.py``),
followed by a small combine and pair reduction on the same device
(``ops/combine.py``) and an exact host assembly. A 2D image is swept as a
``[1, Y, X]`` view with flat ``(1, 128, 128)`` blocks and its synthetic z
axis is dropped on the device after the combine. :func:`analyze_raw`
sweeps the raw label values directly (no host relabel) and compacts the
result on the host. Three engines give bit-identical tables:

- ``"cuda"``    — the hand-written CUDA kernel (a stack on a CUDA device);
- ``"torch"``   — its plain PyTorch version (any device);
- ``"chunked"`` — the flat engine (:func:`flat_sweep`, any device): segment
  sums over the whole stack in flat order (``ops/segred.py``) and a sort
  over the shifted-comparison keys (``ops/stencil.py``), with no per-block
  dictionary and no face buffer, 2D images native.

``engine="auto"`` picks ``"cuda"`` for a CUDA stack and ``"torch"`` for a
CPU stack. The block engines keep a dictionary of L labels a block and a
dense ``[B, L, 3L]`` face buffer. Before any launch ``"auto"`` decides in
two steps. First, from sizes alone, it holds the stack's labels a block
(``n_labels`` over its B blocks: some block holds at least that many)
against the largest L the block engine takes for B blocks on that device
(:func:`block_capacity`). Then it counts every block's dictionary labels on
the device (:func:`fit_dictionary`: one pass of a hand-written kernel on a
card, one readback) and sweeps once at the smallest L of the doubling ladder
that holds the largest count. Where a block is past the engine's bound, or
on a card the outputs at the counted L are past the memory the device can
give, ``"auto"`` reads every block's count and routes only the blocks past
a smaller L to the flat engine (:func:`split_plan`): the block sweep runs
at that L, and the routed blocks are swept flat beside it
(``ops/flat_blocks.py``), their rows joining its combine. Where no such
split takes fewer device bytes than the flat engine over the whole stack,
or the split does not fit the device either, and for a stack past the
first test: ``"auto"`` warns, adds one to :data:`reroutes` and sweeps the whole
stack with the flat engine instead. Nothing reroutes after a launch:
under ``"cuda"`` and ``"torch"`` a block that overflows makes the sweep
rerun with L doubled, and one that overflows the largest L, a face buffer
the device cannot hold, or a kernel that fails to build or launch raises
under every engine name, and the first two name ``engine="chunked"``.

:func:`dispatch_stack` launches a sweep without waiting for the device and
:func:`collect_stack` finishes it, so a caller can relabel the next frame or
slab while the card sweeps this one; :func:`analyze_stack` is the two in a
row. :func:`collect_stack` is :func:`finish_stack` (overflow reruns,
combine and pair reduce, on the device) then :func:`assemble_table`
(readback and host assembly); the sharded engine merges several slabs'
:class:`Finished` tables on the device between the two.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
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
from tissue_analysis_tpu_torch.ops import combine, flat_blocks, segred, stencil
from tissue_analysis_tpu_torch.ops.block_sweep import (
    DEFAULT_BLOCK,
    IMAX,
    PLAIN_MAX_DICT,
    block_sweep,
    block_sweep_reference,
    count_block_labels,
    max_dict_size,
)
from tissue_analysis_tpu_torch.utils import timing

__all__ = [
    "analyze",
    "analyze_raw",
    "analyze_stack",
    "analyze_stack_pallas",
    "analyze_stack_blocked",
    "analyze_stack_chunked",
    "dispatch_stack_pallas",
    "collect_stack_pallas",
    "assemble_table",
    "collect_stack",
    "dispatch_stack",
    "finish_stack",
    "flat_sweep",
    "Finished",
    "resolve_engine",
    "auto_engine",
    "block_capacity",
    "block_engine",
    "past_capacity",
    "dispatch_counted",
    "fit_dictionary",
    "split_plan",
    "ENGINES",
]

ENGINES = ("auto", "cuda", "torch", "chunked")

# the JAX package's engine names → the port's (``ENGINES``)
_ENGINE_NAMES = {
    "auto": "auto",
    "cuda": "cuda",
    "torch": "torch",
    "chunked": "chunked",
    "pallas": "cuda",
    "blocked": "torch",
}

#: stacks that ``engine="auto"`` gave to the flat engine before any launch,
#: because no block sweep could take them (a count of reroutes, as
#: ``block_sweep.launches`` is one of kernel launches)
reroutes = 0

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


def block_engine(engine: str, device) -> str:
    """``"auto"`` → the block engine of ``device`` (``"cuda"`` on a card,
    else ``"torch"``); any other name as it is. A caller that sweeps slabs
    of an image names the block engine so: the capacity test of ``"auto"``
    (:func:`auto_engine`) is one of a whole image."""
    if engine != "auto":
        return engine
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def dict_bound(engine: str) -> int:
    """Largest dictionary size L block engine ``engine`` (``"cuda"`` or
    ``"torch"``) takes."""
    return max_dict_size() if engine == "cuda" else PLAIN_MAX_DICT


def block_capacity(B: int, device, engine: str) -> int:
    """Largest dictionary size L that block engine ``engine`` takes for a
    sweep of ``B`` blocks on ``device``: the engine's bound, and on a card
    no more than the L whose ``[B, L, 3L]`` int32 face counts equal the
    card's whole memory."""
    cap = dict_bound(engine)
    device = torch.device(device)
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        cap = min(cap, math.isqrt(total // (12 * B)))
    return cap


def n_blocks(shape, block) -> int:
    """Blocks of shape ``block`` over an image of ``shape`` (ragged far
    edges included)."""
    return int(np.prod([-(-s // b) for s, b in zip(shape, block)]))


def past_capacity(n: int, shape, device, engine: str, part=None) -> Optional[str]:
    """Why block engine ``engine`` cannot finish an image of ``shape`` in
    which ``n`` labels have voxels, swept on ``device`` whole or in parts of
    shape ``part`` (slabs); None when it may. Some block holds at least
    ``n`` over the image's blocks labels, and that is held against
    :func:`block_capacity` for the blocks of one sweep."""
    block = BLOCK_2D[1:] if len(shape) == 2 else DEFAULT_BLOCK
    B, B_part = n_blocks(shape, block), n_blocks(shape if part is None else part, block)
    cap = block_capacity(B_part, device, engine)
    if n <= B * cap:
        return None
    L = -(-n // B)
    return (
        f"some {tuple(block)} block of this {tuple(shape)} image holds {L} "
        f"labels or more ({n:,} over its {B} blocks), more than the largest "
        f"dictionary L={cap} the {engine!r} block engine takes for a sweep of "
        f"{B_part} blocks on {device} (its [B, L, 3L] face counts at L={L} "
        f"would take {B_part * L * 3 * L * 4:,} bytes)"
    )


def _reroute(why: str) -> None:
    """Say why ``"auto"`` gives a stack to the flat engine, and count it."""
    global reroutes
    warnings.warn(
        f'{why}; sweeping it with the flat engine instead (engine="chunked" '
        f"asks for that engine by name)",
        UserWarning, stacklevel=4,
    )
    reroutes += 1
    timing.count("reroutes")


def auto_engine(stack: LabeledStack, device, part=None) -> str:
    """The engine ``"auto"`` starts from on ``device``: its block engine, or
    ``"chunked"`` (with a warning and one more of :data:`reroutes`) where
    :func:`past_capacity` says from sizes alone that no block sweep of
    ``stack`` can converge. That mean is evidence only where every label
    has voxels (``stack.all_present``, a stack relabeled from an image); a
    raw id range or a label space given by hand goes to the block engine,
    and :func:`fit_dictionary`'s count decides."""
    name = block_engine("auto", device)
    if not stack.all_present:
        return name
    why = past_capacity(stack.n_labels, stack.shape, device, name, part)
    if why is None:
        return name
    _reroute(why)
    return "chunked"


def sweep_bytes(B: int, L: int) -> int:
    """Bytes of a block sweep's outputs for ``B`` blocks at dictionary size
    ``L``: ids, mom, gmin, gmax, the ``[B, L, 3L]`` face counts and ovf."""
    return B * (4 + L * (4 + 80 + 24 + 12 * L))


def givable_bytes(device, want: int) -> Optional[int]:
    """Bytes a new allocation of ``want`` bytes on ``device`` can have: on a
    card the free memory ``cudaMemGetInfo`` reports, plus what PyTorch's
    allocator holds unused where the free memory alone is short of
    ``want`` (the allocator's statistics cost more host time than
    ``cudaMemGetInfo``); None (no bound) elsewhere."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free = torch.cuda.mem_get_info(device)[0]
    if free >= want:
        return free
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def fit_dictionary(d: "Dispatched", held: int = 0,
                   counts: Optional[list] = None) -> Optional[str]:
    """``"auto"``'s exact test of a block sweep ``d`` before its launch.

    One count of every block's dictionary labels
    (:func:`~tissue_analysis_tpu_torch.ops.block_sweep.count_block_labels`,
    the kernel on a card, saturated past the engine's bound) and one
    readback of the largest count m, which the kernel writes beside the
    counts (no reduction is launched for it). ``d.L`` becomes the smallest
    ``d.L · 2^k ≥ m`` up to the engine's bound: the size that
    :func:`finish_stack`'s overflow reruns would converge to, so the sweep
    runs once. Returns None, or why no block sweep can take the stack: a
    block past the engine's bound, or on a card outputs at that L (with
    ``held`` bytes that sweeps dispatched beside it will hold on the same
    device) past :func:`givable_bytes`. With a reason, the count is appended
    to ``counts`` where that is a list, for :func:`_route`. A label space no
    larger than ``d.L`` needs no count."""
    stack, n = d.stack, d.n_sweep
    if n <= d.L:
        return None
    name = "cuda" if d.sweep is block_sweep else "torch"
    bound = dict_bound(name)
    with timing.stage("device count (block labels)", stack.shape, stack.device,
                      span="count") as s:
        counted = count_block_labels(stack.dense, n, d.block, bound)
        with timing.wait("count.largest"):
            m = int(counted.largest)
        B = counted.counts.numel()
        s.set(B=B, largest=m)
    where = f"a {tuple(d.block)} block of this {tuple(d.image.shape)} image (one of {B})"
    if m > bound:
        if counts is not None:
            counts.append(counted)
        return (f"{where} holds more than {bound:,} dictionary labels, the largest "
                f"dictionary L={bound} the {name!r} block engine takes")
    L = d.L
    while L < m:
        L = min(2 * L, bound)
    need = sweep_bytes(B, L)
    with timing.span("memory_check"):
        give = givable_bytes(stack.device, held + need)
    if give is not None and held + need > give:
        if counts is not None:
            counts.append(counted)
        return (f"{where} holds {m:,} dictionary labels, so the {name!r} block "
                f"engine sweeps at L={L}, and its outputs there ([B, L, 3L] face "
                f"counts and the rest) need {need:,} bytes; {stack.device} can give "
                f"{give - held:,}")
    d.L = L
    return None


def split_plan(counts: np.ndarray, L: int, bound: int, block, whole: int) -> Optional[
        Tuple[int, int, np.ndarray]]:
    """The split of a block sweep that ``"auto"`` makes where
    :func:`fit_dictionary` finds no L for every block: (device bytes, L, the
    routed blocks), or None for none.

    ``counts`` are the blocks' dictionary sizes (saturated past ``bound``).
    For each L of the doubling ladder from ``L`` up to ``bound`` at which
    some block is past L, the block sweep at L and the flat sweep of the
    blocks past it take :func:`sweep_bytes` plus
    :func:`~tissue_analysis_tpu_torch.ops.flat_blocks.routed_bytes` of
    those blocks. The split is the L of the fewest bytes, if they are fewer
    than ``whole``, the bytes of the flat engine over the whole stack
    (``stencil.pair_sweep_bytes``, the least its chunks take): a split
    never asks for more device memory than the flat engine would. Its
    routed voxels are then fewer than a chunk's, so they are swept in one
    piece. The routed blocks are int64 indices, ascending."""
    B = int(counts.size)
    best = None
    while True:
        over = np.flatnonzero(counts > L)
        if over.size:
            need = sweep_bytes(B, L) + flat_blocks.routed_bytes(block, over.size)
            if need < whole and (best is None or need < best[0]):
                best = (need, L, over)
        if L >= bound:
            return best
        L = min(2 * L, bound)


def _route(d: "Dispatched", counted, chunk: Optional[int]) -> bool:
    """Give the blocks of ``d`` past a smaller L than the count asked for to
    the flat engine (:func:`split_plan`, against the flat engine in chunks
    of ``chunk`` voxels): one readback of the count ``counted``, and one
    copy of the routed blocks and their origins to the device. Sets ``d.L``
    and ``d.split``; False where no split is cheaper than the flat engine
    or the device cannot give its bytes."""
    bound = dict_bound("cuda" if d.sweep is block_sweep else "torch")
    with timing.span("route") as s:
        with timing.wait("route.counts"):
            counts = counted.counts.cpu().numpy()
        plan = split_plan(counts, d.L, bound, d.block,
                          stencil.pair_sweep_bytes(d.image.shape, chunk))
        if plan is None:
            return False
        need, L, over = plan
        with timing.span("memory_check"):
            give = givable_bytes(d.stack.device, need)
        if give is not None and need > give:
            return False
        split = np.concatenate(
            [over[None], flat_blocks.block_origins(over, d.stack.shape, d.block)])
        # the device is idle since the readback: the copy waits for nothing
        with timing.wait("route.blocks"):
            d.split = torch.from_numpy(split).to(d.stack.device)
        d.L = L
        s.set(L=L, k=int(over.size), bytes=need)
        timing.count("splits")
        timing.count("split.blocks", int(over.size))
    return True


def _block_plan(stack: LabeledStack, engine: str, L: int = 32,
                n_bucket: Optional[int] = None) -> "Dispatched":
    """A sweep of ``stack`` by block engine ``engine``, not launched yet
    (``out`` is None), from the converged dictionary size of its key."""
    if engine == "cuda":
        if stack.device.type != "cuda":
            raise ValueError(
                f"engine 'cuda' needs a stack on a CUDA device, got {stack.device}"
            )
        sweep = block_sweep
    else:
        sweep = block_sweep_reference
    image = stack
    if stack.ndim == 2:
        stack, block = _lift_2d(stack), BLOCK_2D
    else:
        block = DEFAULT_BLOCK
    n = stack.n_labels
    n_sweep = n if n_bucket is None else max(n, int(n_bucket))
    key = (stack.shape, n_sweep, tuple(block), int(L))
    return Dispatched(stack, image, sweep, block, key, _GOOD_L.get(key, int(L)), n_sweep, None)


def _launch(d: "Dispatched") -> "Dispatched":
    d.out = _sweep(d, d.L)
    return d


def _sweep(d: "Dispatched", L: int):
    """One block sweep of ``d``'s stack at dictionary size ``L``."""
    with timing.stage("device sweep (block)", d.stack.shape, d.stack.device,
                      span="sweep", L=L) as s:
        out = d.sweep(d.stack.dense, d.n_sweep, d.block, L)
        s.set(B=out.ovf.shape[0])
        timing.count("sweeps")
    return out


def _dispatch_flat(stack: LabeledStack, chunk: Optional[int] = None) -> "Dispatched":
    return Dispatched(stack, stack, flat_sweep, None, None, 0, stack.n_labels,
                      flat_sweep(stack, chunk))


def dispatch_counted(stack: LabeledStack, L: int = 32, n_bucket: Optional[int] = None,
                     chunk: Optional[int] = None) -> "Dispatched":
    """``"auto"`` past its mean test: the block sweep of ``stack`` at the
    L that :func:`fit_dictionary` counts; where it says no block sweep can
    take every block, the block sweep with the blocks past a smaller L
    routed to the flat engine (:func:`_route`), or, where no such split
    pays, the flat engine over the whole stack (a warning and one more of
    :data:`reroutes`). A streamed slab comes here directly: the label count
    of its whole image says nothing of its blocks."""
    pid = timing.new_pass()
    with timing.span("dispatch", pass_id=pid):
        d = _dispatch_counted(stack, L, n_bucket, chunk)
    d.pass_id = pid
    return d


def _dispatch_counted(stack: LabeledStack, L: int, n_bucket: Optional[int],
                      chunk: Optional[int]) -> "Dispatched":
    d = _block_plan(stack, block_engine("auto", stack.device), L, n_bucket)
    counted = []
    why = fit_dictionary(d, counts=counted)
    if why is not None and not _route(d, counted.pop(), chunk):
        _reroute(why)
        return _dispatch_flat(stack, chunk)
    _launch(d)
    if d.split is not None:
        # queued behind the block sweep, while the device runs it
        d.routed = _sweep_routed(d)
    return d


class Finished(NamedTuple):
    """A finished sweep's per-label tables and wall pairs, on the device, in
    the layout of the image as given (d = 2 or 3 axes):

    - ``mom``  int64 [n, 1 + d + d(d+1)/2]: count, Σ per axis, Σ of the
      products in ``features.finalize.tri_pairs`` order;
    - ``cmin`` / ``cmax`` int32 [n, d]: bbox, IMAX / -1 where count is 0;
    - ``pkey`` int64, sorted unique lo·4n + hi·4 + axis; ``ptotal`` int64,
      the face count of each key."""

    mom: torch.Tensor
    cmin: torch.Tensor
    cmax: torch.Tensor
    pkey: torch.Tensor
    ptotal: torch.Tensor


def flat_sweep(stack: LabeledStack, chunk: Optional[int] = None) -> Finished:
    """The flat engine's device side: moments by segment sums over the
    stack in flat order, pairs by a sort over the shifted-comparison keys,
    each in chunks of ``chunk`` voxels (default ``segred.DEFAULT_CHUNK``).
    No per-block dictionary, so no bound on the labels that meet in a
    block; a 2D stack is swept as it is."""
    if stack.ndim not in (2, 3):
        raise ValueError(f"expected a 2D or 3D stack, got shape {stack.shape}")
    n, dev, shape = stack.n_labels, stack.device, stack.shape
    with timing.stage("device sweep (flat moments)", shape, dev, span="flat.moments"):
        mom, cmin, cmax = segred.moment_sweep(stack.dense, n, chunk)
    with timing.stage("device sweep (flat pairs)", shape, dev, span="flat.pairs"):
        pkey, ptotal = stencil.pair_sweep(stack.dense, n, chunk)
    return Finished(mom, cmin, cmax, pkey, ptotal)


@dataclasses.dataclass
class Dispatched:
    """A launched sweep (:func:`dispatch_stack`) awaiting :func:`collect_stack`,
    which takes ``out`` from it: a handle is collected once."""

    stack: LabeledStack  # the swept stack ([1, Y, X] for a 2D image)
    image: LabeledStack  # the stack as given
    sweep: object  # block_sweep, block_sweep_reference or flat_sweep
    block: tuple
    key: tuple
    L: int
    n_sweep: int
    # the block sweep's SweepOut (None until launched), or the flat
    # engine's Finished
    out: object
    # the pass the dispatch opened, which the collect continues
    pass_id: int = 0
    # the blocks routed to the flat engine, on the device: int64 [4, k],
    # each block's index, then the z, y and x of its first voxel
    split: Optional[torch.Tensor] = None
    # their flat sweep: moment rows and face keys (_sweep_routed)
    routed: object = None


def analyze_stack(
    stack: LabeledStack, engine: str = "auto", L: int = 32,
    n_bucket: Optional[int] = None, *, max_pairs: Optional[int] = None,
    chunk: Optional[int] = None, block_config=None,
) -> FeatureTable:
    """Labeled stack → FeatureTable in one fused device pass.

    ``L`` is the starting per-block dictionary size. Under ``"cuda"`` and
    ``"torch"`` a block with more labels makes the sweep rerun with L
    doubled, up to the engine's bound
    (:func:`~tissue_analysis_tpu_torch.ops.block_sweep.max_dict_size` for
    the kernel), and the largest converged size is remembered for later
    stacks of the same shape, label count and block. Under ``"auto"`` an
    exact count of every block's labels before the sweep gives that size
    (:func:`fit_dictionary`), so the sweep runs once. A 2D stack is swept as
    ``[1, Y, X]`` with block :data:`BLOCK_2D`.

    ``n_bucket`` sweeps a label space of ``max(n_labels, n_bucket)``; the
    rows past ``n_labels`` stay empty and are sliced away on the device, so
    the table equals the exact-n one. The reference buckets to share one
    compilation across time-series frames; the port compiles nothing per
    shape, so the bucket only keeps the reference's contract (and frames of
    one bucket share a converged dictionary size).

    ``engine="chunked"`` (the flat engine, :func:`flat_sweep`, in chunks of
    ``chunk`` voxels) has no dictionary: it takes neither ``L`` nor
    ``n_bucket`` into account. ``engine="auto"`` gives it the blocks that
    no block sweep can take, or where that does not pay the whole stack,
    before any launch (see the module docstring).
    The reference's keywords are accepted: ``max_pairs`` (ignored: the
    port's pair table has the size of its content) and ``block_config``
    (None only)."""
    return collect_stack(dispatch_stack(
        stack, engine, L, n_bucket, max_pairs=max_pairs, chunk=chunk,
        block_config=block_config,
    ))


def dispatch_stack(
    stack: LabeledStack, engine: str = "auto", L: int = 32,
    n_bucket: Optional[int] = None, *, max_pairs: Optional[int] = None,
    chunk: Optional[int] = None, block_config=None,
) -> Dispatched:
    """Launch the sweep of ``stack`` without waiting for the device;
    :func:`collect_stack` finishes it. Under ``"auto"`` a block sweep is
    preceded by :func:`fit_dictionary`'s count, whose largest value is read
    back: one wait for the device before the launch. The other arguments
    are :func:`analyze_stack`'s."""
    _no_cfg(block_config)
    if stack.ndim not in (2, 3):
        raise ValueError(f"expected a 2D or 3D stack, got shape {stack.shape}")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    pid = timing.new_pass()
    with timing.span("dispatch", pass_id=pid, engine=engine):
        if engine == "auto" and auto_engine(stack, stack.device) != "chunked":
            d = _dispatch_counted(stack, L, n_bucket, chunk)
        elif engine in ("auto", "chunked"):
            d = _dispatch_flat(stack, chunk)
        else:
            d = _launch(_block_plan(stack, engine, L, n_bucket))
    d.pass_id = pid
    return d


def collect_stack(d: Dispatched) -> FeatureTable:
    """Finish a dispatched sweep on the device (:func:`finish_stack`), then
    read it back and assemble the table (:func:`assemble_table`)."""
    with timing.span("collect", pass_id=d.pass_id):
        return assemble_table(d.image, finish_stack(d))


def analyze_stack_chunked(
    stack: LabeledStack, max_pairs: Optional[int] = None, chunk: Optional[int] = None,
) -> FeatureTable:
    """The flat engine (the reference's chunked engine): :func:`flat_sweep`
    in chunks of ``chunk`` voxels, then :func:`assemble_table`. ``max_pairs``
    is the reference's pair-buffer size; the port's pair table has the size
    of its content, so the argument is accepted and ignored."""
    return assemble_table(stack, flat_sweep(stack, chunk))


def _no_cfg(cfg) -> None:
    """The reference's ``cfg`` / ``block_config``: the port has none."""
    if cfg is not None:
        raise ValueError(
            "the port has no PallasConfig / BlockConfig: pass cfg=None (the "
            "starting dictionary size is analyze_stack's L)"
        )


def dispatch_stack_pallas(stack: LabeledStack, cfg=None, n_bucket: Optional[int] = None):
    """:func:`dispatch_stack` through the CUDA kernel, under the reference's
    name; ``cfg`` must be None."""
    _no_cfg(cfg)
    return dispatch_stack(stack, "cuda", n_bucket=n_bucket)


def collect_stack_pallas(handle: Dispatched) -> FeatureTable:
    """:func:`collect_stack`, under the reference's name."""
    return collect_stack(handle)


def analyze_stack_pallas(
    stack: LabeledStack, cfg=None, n_bucket: Optional[int] = None
) -> FeatureTable:
    """The kernel engine under the reference's name (``engine="cuda"``: the
    stack must lie on a CUDA device); ``cfg`` must be None."""
    return collect_stack_pallas(dispatch_stack_pallas(stack, cfg, n_bucket))


def analyze_stack_blocked(
    stack: LabeledStack, cfg=None, n_bucket: Optional[int] = None
) -> FeatureTable:
    """The plain block engine under the reference's name
    (``engine="torch"``); ``cfg`` must be None."""
    _no_cfg(cfg)
    return analyze_stack(stack, "torch", n_bucket=n_bucket)


# lifted-2D moment columns kept for the [Y, X] image: count, y, x, yy, yx, xx
_COLS_2D = [0, 2, 3, 7, 8, 9]


def finish_stack(d: Dispatched) -> Finished:
    """The device side of :func:`collect_stack`: rerun with L doubled while
    a block overflows (the routed blocks aside), combine the moments and
    reduce the pairs. No readback. Past the engine's largest L this raises
    ``RuntimeError``, and past the face buffer the device can hold the
    sweep's ``ValueError`` stands; both name ``engine="chunked"``. A flat
    engine's dispatch is finished already."""
    # the handle lets go of the sweep's outputs, so that ``del out`` frees
    # them before the next L's face buffer (4x this one's) is asked for
    out, d.out = d.out, None
    if out is None:
        raise ValueError("this dispatched sweep was collected already")
    if d.sweep is flat_sweep:
        return out
    Lc = d.L
    bound = dict_bound("cuda" if d.sweep is block_sweep else "torch")
    with timing.span("finish") as fs:
        while _overflows(out, d.split):
            if Lc >= bound:
                raise RuntimeError(
                    f"per-block dictionary still overflows at L={Lc}, the largest "
                    f'this engine takes (engine="chunked", the flat engine, has '
                    f"no per-block dictionary)"
                )
            del out
            Lc = min(2 * Lc, bound)
            out = _sweep(d, Lc)
        fs.set(L=Lc)
        # stacks of one key share the largest size any of them needed (equal
        # slabs of one sharded stack, frames of one series)
        _GOOD_L[d.key] = max(Lc, _GOOD_L.get(d.key, Lc))
        return _combine(d, out)


def _overflows(out, split: Optional[torch.Tensor] = None) -> bool:
    """Whether a block of the sweep ``out`` overflowed its dictionary, the
    routed blocks (``Dispatched.split``) aside: one readback."""
    ovf = out.ovf if split is None else out.ovf.index_fill(0, split[0], 0)
    with timing.wait("finish.ovf"):
        return bool(ovf.any())


def _sweep_routed(d: Dispatched):
    """The flat sweep of the routed blocks of ``d``, under the flat
    engine's stage names: their moment rows and face keys."""
    stack, n = d.stack, d.n_sweep
    vox = d.split.shape[1] * math.prod(d.block)
    with timing.stage("device sweep (flat moments)", vox, stack.device, span="flat.moments"):
        box, coords = flat_blocks.gather_blocks(stack.dense, n, d.block, d.split[1:])
        rows = flat_blocks.moment_rows(box, coords, d.block)
    with timing.stage("device sweep (flat pairs)", vox, stack.device, span="flat.pairs"):
        keys = flat_blocks.pair_keys(box, n)
    return rows, keys


def _combine(d: Dispatched, out) -> Finished:
    """The combine and pair reduce of a converged sweep ``out`` of ``d``;
    where it routed blocks, their ids in ``out`` are set to IMAX, so that
    the combine drops their rows and face entries (undefined where the
    block overflowed), and their flat sweep's rows and keys join it."""
    stack, n, n_sweep = d.stack, d.stack.n_labels, d.n_sweep
    rows = keys = None
    if d.split is not None:
        out.ids.index_fill_(0, d.split[0], IMAX)
        (rows, keys), d.routed = d.routed, None
    with timing.stage("combine + pair reduce", None, stack.device, span="combine"):
        mom, cmin, cmax = combine.combine_moments(
            out.ids, out.mom, out.gmin, out.gmax, n_sweep, rows
        )
        # the rows are in the tables: let them go before the pair reduce
        del rows
        pkey, ptotal = combine.reduce_pairs(out.ids, out.faces, n_sweep, keys)
        mom, cmin, cmax = mom[:n], cmin[:n], cmax[:n]
        if n_sweep != n:
            # keys of the n_sweep space → the n space (hi < n: order kept)
            pkey = pkey - (pkey // (4 * n_sweep)) * (4 * (n_sweep - n))
        if d.image.ndim == 2:
            # the lifted z axis: its moments are 0 and no face lies along it
            mom, cmin, cmax = mom[:, _COLS_2D], cmin[:, 1:], cmax[:, 1:]
            pkey = pkey - 1
    return Finished(mom, cmin, cmax, pkey, ptotal)


def assemble_table(image: LabeledStack, fin: Finished) -> FeatureTable:
    """Read a :class:`Finished` back and assemble the table of ``image``
    (its ids, shape, voxel size and background)."""
    d, n = image.ndim, image.n_labels
    with timing.span("assemble"):
        with timing.stage("readback + host assemble"):
            with timing.wait("assemble.readback", syncs=5, name="readback") as w:
                host = [t.cpu().numpy() for t in fin]
                w.set(bytes=sum(a.nbytes for a in host))
            mom, cmin, cmax, pkey, ptotal = host
            cmin = cmin.astype(np.int64)
            cmax = cmax.astype(np.int64)
            pair_lo, pair_hi, counts = combine.decode_pairs(pkey, ptotal, n, d)
        count = mom[:, 0].copy()
        empty = count == 0
        cmin[empty] = 0
        cmax[empty] = 0
        return FeatureTable(
            ids=image.ids.copy(),
            shape=image.shape,
            voxelsize=image.voxelsize,
            background_segment=image.background_segment,
            count=count,
            s1=mom[:, 1:1 + d].copy(),
            s2=mom[:, 1 + d:].copy(),
            cmin=cmin,
            cmax=cmax,
            pair_lo=pair_lo,
            pair_hi=pair_hi,
            wall_face_counts=counts,
            margin=_margin_from_bbox(count, cmin, cmax, image.shape),
        )


def _margin_from_bbox(count, cmin, cmax, shape) -> np.ndarray:
    """A label touches an image face iff its bbox does (exact equivalence)."""
    present = count > 0
    lo = (cmin == 0).any(axis=1)
    hi = (cmax == (np.asarray(shape, dtype=np.int64) - 1)).any(axis=1)
    return present & (lo | hi)


def _lift_2d(stack: LabeledStack) -> LabeledStack:
    """[Y, X] stack → [1, Y, X] view, so 2D rides the 3D block sweep."""
    return dataclasses.replace(stack, dense=stack.dense[None],
                               voxelsize=(1.0,) + stack.voxelsize)


def analyze(
    image,
    voxelsize: Optional[Tuple[float, ...]] = None,
    background: Optional[int] = 1,
    device=None,
    engine: str = "auto",
    *,
    max_pairs: Optional[int] = None,
    chunk: Optional[int] = None,
) -> FeatureTable:
    """Analyze a labeled image (host array / SpatialImage) in one fused pass
    on ``device`` (default: the current CUDA device; ``"cpu"`` runs the
    plain engine on the CPU). ``max_pairs`` and ``chunk`` are
    :func:`analyze_stack`'s."""
    stack = LabeledStack.from_array(
        image, voxelsize=voxelsize, background=background, device=device
    )
    return analyze_stack(stack, engine=engine, max_pairs=max_pairs, chunk=chunk)


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
        raw = torch.from_numpy(_uploadable(arr)).to(dev)
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


def _uploadable(arr: np.ndarray) -> np.ndarray:
    """``arr`` as ``torch.from_numpy`` takes it: native byte order,
    C-contiguous and writable. An array that already is all three comes back
    as the same object (the upload stays a zero-copy view); a byte-swapped
    one, as a big-endian ``.npy`` file gives, costs one host pass."""
    if not arr.dtype.isnative:
        arr = arr.astype(arr.dtype.newbyteorder("="))
    return np.require(arr, requirements=["C", "W"])


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
