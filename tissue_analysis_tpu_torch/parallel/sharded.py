"""z-slab sharding of the fused analysis over several devices.

Counterpart of ``tissue_analysis_tpu/parallel/sharded.py``. One process
holds a :class:`Mesh`, a tuple of torch devices, and
:func:`analyze_sharded` turns one whole :class:`LabeledStack` into one
:class:`FeatureTable` equal to ``engine.analyze_stack(stack)`` field by
field:

1. the stack is split along axis 0 (z; y for a 2D image) into contiguous
   slabs whose depth is a multiple of the sweep block's extent on that
   axis, one per device; slabs that would start at or past the end are not
   swept, and nothing is padded (the sweep takes ragged blocks);
2. each slab is copied to its device and its sweep dispatched
   (``engine.dispatch_stack``) before any is finished, so the devices sweep
   at once;
3. on its own device each slab is finished (``engine.finish_stack``: the
   overflow reruns, combine and pair reduce), its tables are moved to its
   global offset in exact int64 (``ops.combine.shift_moments``), and the
   faces between its last plane and the next slab's first plane, which is
   copied over (the ring halo), are counted by ``ops.seam.seam_pairs``:
   the lower slab owns the seam, each face counts once, on axis 0;
4. the per-slab tables move to the mesh's first device and merge there:
   moments add, bboxes take min / max, pair keys are concatenated and
   summed by key. This takes the place of the reference's ``psum`` /
   ``pmin`` / ``pmax`` / ``all_gather``;
5. one readback and the host assembly that ``analyze_stack`` uses.

``engine="chunked"`` (:func:`analyze_sharded_chunked`) runs the flat
engine a slab instead: :func:`sharded_pipeline` sweeps each slab's moments
at its global flat offset (``ops.segred.moment_sweep``, no shift
afterwards) and its pairs (``ops.stencil.pair_sweep``) with the same
z-seam, and the same merge and assembly follow. ``engine="auto"`` goes
there too, before any sweep, for a stack whose labels a block are past
the block engine's capacity for one slab (``engine.auto_engine``), or one
slab of which no block sweep can take: every slab's blocks are counted on
its device before any slab is swept (``engine.fit_dictionary``), and one
slab past the count sends the whole stack there (a warning and one counted
reroute). Otherwise each slab sweeps once, at its counted L.

A mesh may name one card several times (``Mesh((cuda:0,) * 4)``): four
slabs, four sweeps, a real halo and merge, on one card. Nothing maps a
request for more cards than exist onto fewer, and a slab that fails
raises: there is no fallback to another engine or device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from tissue_analysis_tpu_torch.core.stack import LabeledStack, resolve_device
from tissue_analysis_tpu_torch.engine import (
    BLOCK_2D,
    Finished,
    _block_plan,
    _launch,
    _no_cfg,
    _reroute,
    assemble_table,
    auto_engine,
    block_engine,
    finish_stack,
    fit_dictionary,
    n_blocks,
    resolve_engine,
    sweep_bytes,
)
from tissue_analysis_tpu_torch.features.table import FeatureTable
from tissue_analysis_tpu_torch.ops import combine, segred, stencil
from tissue_analysis_tpu_torch.ops.block_sweep import DEFAULT_BLOCK
from tissue_analysis_tpu_torch.ops.seam import seam_pairs
from tissue_analysis_tpu_torch.utils import timing

__all__ = [
    "Mesh",
    "make_mesh",
    "sharded_pipeline",
    "analyze_sharded",
    "analyze_sharded_pallas",
    "analyze_sharded_blocked",
    "analyze_sharded_chunked",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices along one mesh axis; slab k goes to ``devices[k]``. A device
    may appear more than once."""

    devices: Tuple[torch.device, ...]
    axis: str = "z"

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    @property
    def shape(self) -> dict:
        """``{axis: device count}``, as the JAX mesh's ``shape`` reads."""
        return {self.axis: len(self.devices)}


def make_mesh(n_devices: Optional[int] = None, axis: str = "z", device=None) -> Mesh:
    """The first ``n_devices`` visible CUDA devices (all of them by
    default). ``device`` puts every one of the ``n_devices`` entries (one
    by default) on that device instead: ``device="cpu"`` is the CPU mesh
    the tests use."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be positive, got {n_devices}")
    if device is not None:
        return Mesh((resolve_device(device),) * (n_devices or 1), axis)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device was found (torch.cuda.is_available() is False); "
            'pass device="cpu" to build a mesh on the CPU'
        )
    visible = torch.cuda.device_count()
    n = visible if n_devices is None else n_devices
    if n > visible:
        raise ValueError(f"asked for {n} CUDA devices; {visible} are visible")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


def _plane(dense: torch.Tensor) -> torch.Tensor:
    """A one-deep slice along axis 0 as a 2D tensor ([1, X] for a row of a
    2D image), the shape ``seam_pairs`` takes."""
    return dense.flatten(0, -2)


def _merge(parts, dev: torch.device) -> Finished:
    """Per-slab tables (each in global coordinates, its pairs reduced) →
    one table on ``dev``."""
    keys = torch.cat([p[3].to(dev) for p in parts])
    totals = torch.cat([p[4].to(dev) for p in parts])
    # the first slab lies on ``dev``, where the partials are gathered
    mom, cmin, cmax = segred.combine_moment_partials([p[:3] for p in parts])
    return Finished(mom, cmin, cmax, *combine.sum_by_key(keys, totals))


def _slab_depth(shape, mesh: Mesh) -> int:
    """Depth of one slab of an image of ``shape`` along axis 0: a multiple
    of the sweep block's extent on that axis (y of a 2D image)."""
    b0 = BLOCK_2D[1] if len(shape) == 2 else DEFAULT_BLOCK[0]
    return -(-shape[0] // (len(mesh.devices) * b0)) * b0


def _split(dense: torch.Tensor, mesh: Mesh):
    """(start, slab on its mesh device) of the contiguous slabs of ``dense``
    along axis 0 (:func:`_slab_depth`); no slab starts past the end."""
    depth = dense.shape[0]
    slab = _slab_depth(dense.shape, mesh)
    return [
        (z0, dense[z0:z0 + slab].to(dev))
        for z0, dev in zip(range(0, depth, slab), mesh.devices)
    ]


def _with_seam(slabs, k: int, n: int, pkey, ptotal):
    """Slab k's pair table with the faces between its last plane and the
    next slab's first plane (copied over) added, on axis 0."""
    if k + 1 == len(slabs):
        return pkey, ptotal
    dense = slabs[k][1]
    first = slabs[k + 1][1][:1].to(dense.device)
    key, total = seam_pairs(_plane(dense[-1:]), _plane(first), n)
    return combine.sum_by_key(torch.cat([pkey, key]), torch.cat([ptotal, total]))


def analyze_sharded(
    stack: LabeledStack, mesh: Optional[Mesh] = None, engine: str = "auto",
    L: int = 32, *, max_pairs: Optional[int] = None, chunk: Optional[int] = None,
) -> FeatureTable:
    """Multi-device counterpart of ``engine.analyze_stack``, equal to it
    field by field (see the module docstring for the steps).

    ``mesh`` defaults to :func:`make_mesh`'s (every visible CUDA device).
    The stack may live on any device; each slab is copied to its mesh
    device. ``engine`` takes the port's and the JAX package's names
    (``pallas`` → ``cuda``, ``blocked`` → ``torch``, ``chunked`` →
    :func:`analyze_sharded_chunked`, which takes ``max_pairs`` and
    ``chunk``); ``cuda`` needs every slab on a CUDA device. ``L`` is the
    starting dictionary size; slabs of one shape share the converged size
    across calls."""
    if mesh is None:
        mesh = make_mesh()
    engine = resolve_engine(engine)
    if engine == "chunked":
        return analyze_sharded_chunked(stack, mesh, max_pairs, chunk)
    if stack.ndim not in (2, 3):
        raise ValueError(f"expected a 2D or 3D stack, got shape {stack.shape}")
    n = stack.n_labels
    if engine == "auto":
        # the whole stack's test: a slab does not hold every label
        part = (min(_slab_depth(stack.shape, mesh), stack.shape[0]),) + stack.shape[1:]
        if auto_engine(stack, mesh.devices[0], part) == "chunked":
            return analyze_sharded_chunked(stack, mesh, max_pairs, chunk)

    pid = timing.new_pass()
    with timing.span("dispatch", pass_id=pid):
        launched = _launch_slabs(stack, mesh, engine, L)
    if launched is None:
        return _flat_pass(stack, mesh, max_pairs, chunk, pid)
    slabs, handles = launched
    with timing.span("collect", pass_id=pid):
        parts = []
        for k, ((z0, dense), h) in enumerate(zip(slabs, handles)):
            fin = finish_stack(h)
            with timing.stage("shard: shift + z-seam", None, dense.device):
                mom, cmin, cmax = combine.shift_moments(fin.mom, fin.cmin, fin.cmax, z0)
                pkey, ptotal = _with_seam(slabs, k, n, fin.pkey, fin.ptotal)
            parts.append((mom, cmin, cmax, pkey, ptotal))
        dev0 = mesh.devices[0]
        with timing.stage("shard: merge", None, dev0):
            merged = _merge(parts, dev0)
        return assemble_table(stack, merged)


def _launch_slabs(stack: LabeledStack, mesh: Mesh, engine: str, L: int):
    """(slabs, handles): every slab of ``stack`` copied to its mesh device
    and its block sweep launched, under ``"auto"`` after every slab is
    counted; None where a count says no block sweep can take a slab (a
    warning and one more reroute)."""
    with timing.stage("shard: slab copy", int(stack.dense.numel())):
        slabs = _split(stack.dense, mesh)
    plans = [
        _block_plan(dataclasses.replace(stack, dense=dense), block_engine(engine, dense.device), L)
        for _, dense in slabs
    ]
    if engine == "auto":
        # every slab counted before any sweep; the sweeps of one device
        # hold their outputs at once
        held: dict = {}
        for p in plans:
            dev = p.stack.device
            why = fit_dictionary(p, held.get(dev, 0))
            if why is not None:
                _reroute(why)
                return None
            held[dev] = held.get(dev, 0) + sweep_bytes(n_blocks(p.stack.shape, p.block), p.L)
    return slabs, [_launch(p) for p in plans]


def sharded_pipeline(
    dense: torch.Tensor, n_labels: int, chunk: Optional[int] = None,
    max_pairs: Optional[int] = None, mesh: Optional[Mesh] = None,
    orig_z: Optional[int] = None,
) -> list:
    """The flat engine over the slabs of ``dense`` (segment ids, 2D or 3D),
    one slab a mesh device: the per-slab partial tables, for callers that
    merge themselves.

    Returns one ``(mom, cmin, cmax, pkey, ptotal)`` a slab, on the slab's
    device, in ``engine.Finished``'s layout and in GLOBAL coordinates: the
    moments are swept at the slab's flat offset, and the pairs hold the
    seam to the next slab. Sums and pair totals add across slabs, the bbox
    takes min / max (``ops.segred.combine_moment_partials``,
    ``ops.combine.sum_by_key``).

    The reference wants ``dense`` padded along axis 0 to a multiple of the
    mesh size, with ``orig_z`` the extent before padding. The port pads
    nothing: planes at or past ``orig_z`` (default: all of ``dense``) are
    not swept. ``max_pairs`` sizes the reference's pair buffers; the port's
    tables have the size of their content and ignore it."""
    if mesh is None:
        mesh = make_mesh()
    if dense.dim() not in (2, 3):
        raise ValueError(f"expected a 2D or 3D stack, got shape {tuple(dense.shape)}")
    if orig_z is not None:
        dense = dense[:int(orig_z)]
    shape, n = tuple(dense.shape), int(n_labels)
    plane = dense[0].numel()
    with timing.stage("shard: slab copy", int(dense.numel())):
        slabs = _split(dense, mesh)
    parts = []
    for k, (z0, slab) in enumerate(slabs):
        voxels = int(slab.numel())
        with timing.stage("device sweep (flat moments)", voxels, slab.device,
                          span="flat.moments"):
            mom, cmin, cmax = segred.moment_sweep(slab, n, chunk, z0 * plane, shape)
        with timing.stage("device sweep (flat pairs)", voxels, slab.device,
                          span="flat.pairs"):
            pkey, ptotal = stencil.pair_sweep(slab, n, chunk)
        with timing.stage("shard: shift + z-seam", None, slab.device):
            pkey, ptotal = _with_seam(slabs, k, n, pkey, ptotal)
        parts.append((mom, cmin, cmax, pkey, ptotal))
    return parts


def analyze_sharded_pallas(
    stack: LabeledStack, mesh: Optional[Mesh] = None, L: int = 32, *, cfg=None
) -> FeatureTable:
    """:func:`analyze_sharded` through the CUDA kernel (the counterpart of
    the reference's sharded Pallas engine); 3D stacks only. ``cfg`` is the
    reference's (None only)."""
    _no_cfg(cfg)
    if stack.ndim != 3:
        raise ValueError("pallas sharded engine requires a 3D stack")
    return analyze_sharded(stack, mesh, "cuda", L)


def analyze_sharded_blocked(
    stack: LabeledStack, mesh: Optional[Mesh] = None, L: int = 32, *, cfg=None
) -> FeatureTable:
    """:func:`analyze_sharded` through the plain PyTorch sweep (the
    counterpart of the reference's sharded blocked engine); 3D stacks
    only. ``cfg`` is the reference's (None only)."""
    _no_cfg(cfg)
    if stack.ndim != 3:
        raise ValueError("blocked sharded engine requires a 3D stack")
    return analyze_sharded(stack, mesh, "torch", L)


def analyze_sharded_chunked(
    stack: LabeledStack, mesh: Optional[Mesh] = None,
    max_pairs: Optional[int] = None, chunk: Optional[int] = None,
) -> FeatureTable:
    """:func:`analyze_sharded` through the flat engine (the counterpart of
    the reference's sharded chunked engine; 2D images too, split along y):
    :func:`sharded_pipeline`, the merge on the mesh's first device, and the
    host assembly. ``max_pairs`` is accepted and ignored."""
    if mesh is None:
        mesh = make_mesh()
    return _flat_pass(stack, mesh, max_pairs, chunk, timing.new_pass())


def _flat_pass(stack: LabeledStack, mesh: Mesh, max_pairs: Optional[int],
               chunk: Optional[int], pid: int) -> FeatureTable:
    """:func:`analyze_sharded_chunked`'s work, as pass ``pid`` (that of a
    stack rerouted after its count)."""
    with timing.span("dispatch", pass_id=pid):
        parts = sharded_pipeline(stack.dense, stack.n_labels, chunk, max_pairs, mesh)
    with timing.span("collect", pass_id=pid):
        dev0 = mesh.devices[0]
        with timing.stage("shard: merge", None, dev0):
            merged = _merge(parts, dev0)
        return assemble_table(stack, merged)
