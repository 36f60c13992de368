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
    assemble_table,
    dispatch_stack,
    finish_stack,
    resolve_engine,
)
from tissue_analysis_tpu_torch.features.table import FeatureTable
from tissue_analysis_tpu_torch.ops import combine
from tissue_analysis_tpu_torch.ops.block_sweep import DEFAULT_BLOCK
from tissue_analysis_tpu_torch.ops.seam import seam_pairs
from tissue_analysis_tpu_torch.utils import timing

__all__ = [
    "Mesh",
    "make_mesh",
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
    """Per-slab tables (each already shifted, its pairs reduced) → one
    table on ``dev``."""
    moms, cmins, cmaxs, keys, totals = zip(
        *[[t.to(dev) for t in part] for part in parts]
    )
    pkey, ptotal = combine.sum_by_key(torch.cat(keys), torch.cat(totals))
    return Finished(
        mom=torch.stack(moms).sum(0),
        cmin=torch.stack(cmins).amin(0),
        cmax=torch.stack(cmaxs).amax(0),
        pkey=pkey,
        ptotal=ptotal,
    )


def analyze_sharded(
    stack: LabeledStack, mesh: Optional[Mesh] = None, engine: str = "auto",
    L: int = 32,
) -> FeatureTable:
    """Multi-device counterpart of ``engine.analyze_stack``, equal to it
    field by field (see the module docstring for the steps).

    ``mesh`` defaults to :func:`make_mesh`'s (every visible CUDA device).
    The stack may live on any device; each slab is copied to its mesh
    device. ``engine`` takes the port's and the JAX package's names
    (``pallas`` → ``cuda``, ``blocked`` / ``chunked`` → ``torch``); ``cuda``
    needs every slab on a CUDA device. ``L`` is the starting dictionary
    size; slabs of one shape share the converged size across calls."""
    if mesh is None:
        mesh = make_mesh()
    engine = resolve_engine(engine)
    if stack.ndim not in (2, 3):
        raise ValueError(f"expected a 2D or 3D stack, got shape {stack.shape}")
    # the sweep block's extent along the split axis (y of a 2D image)
    b0 = BLOCK_2D[1] if stack.ndim == 2 else DEFAULT_BLOCK[0]
    depth, n = stack.shape[0], stack.n_labels
    slab = -(-depth // (len(mesh.devices) * b0)) * b0
    starts = range(0, depth, slab)

    with timing.stage("shard: slab copy", int(stack.dense.numel())):
        slabs = [
            LabeledStack(
                dense=stack.dense[z0:z0 + slab].to(dev),
                ids=stack.ids,
                voxelsize=stack.voxelsize,
                background_segment=stack.background_segment,
            )
            for z0, dev in zip(starts, mesh.devices)
        ]
    handles = [dispatch_stack(s, engine, L) for s in slabs]

    parts = []
    for k, (z0, s, h) in enumerate(zip(starts, slabs, handles)):
        fin = finish_stack(h)
        keys, totals = [fin.pkey], [fin.ptotal]
        with timing.stage("shard: shift + z-seam", None, s.device):
            mom, cmin, cmax = combine.shift_moments(fin.mom, fin.cmin, fin.cmax, z0)
            if k + 1 < len(slabs):
                first = slabs[k + 1].dense[:1].to(s.device)
                key, total = seam_pairs(_plane(s.dense[-1:]), _plane(first), n)
                keys.append(key)
                totals.append(total)
            pkey, ptotal = combine.sum_by_key(torch.cat(keys), torch.cat(totals))
        parts.append((mom, cmin, cmax, pkey, ptotal))
    dev0 = mesh.devices[0]
    with timing.stage("shard: merge", None, dev0):
        merged = _merge(parts, dev0)
    return assemble_table(stack, merged)


def analyze_sharded_pallas(
    stack: LabeledStack, mesh: Optional[Mesh] = None, L: int = 32
) -> FeatureTable:
    """:func:`analyze_sharded` through the CUDA kernel (the counterpart of
    the reference's sharded Pallas engine); 3D stacks only."""
    if stack.ndim != 3:
        raise ValueError("pallas sharded engine requires a 3D stack")
    return analyze_sharded(stack, mesh, "cuda", L)


def analyze_sharded_blocked(
    stack: LabeledStack, mesh: Optional[Mesh] = None, L: int = 32
) -> FeatureTable:
    """:func:`analyze_sharded` through the plain PyTorch sweep (the
    counterpart of the reference's sharded blocked engine); 3D stacks
    only."""
    if stack.ndim != 3:
        raise ValueError("blocked sharded engine requires a 3D stack")
    return analyze_sharded(stack, mesh, "torch", L)


def analyze_sharded_chunked(
    stack: LabeledStack, mesh: Optional[Mesh] = None, L: int = 32
) -> FeatureTable:
    """:func:`analyze_sharded` through the plain PyTorch sweep (the
    counterpart of the reference's sharded chunked engine, which takes 2D
    images too)."""
    return analyze_sharded(stack, mesh, "torch", L)
