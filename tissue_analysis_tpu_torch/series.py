"""Time-series batch analysis (BASELINE config 5).

A confocal time series is a first-class batch:

- :func:`analyze_series`: per-timepoint FeatureTables. Frames go round-robin
  over ``devices``; each frame is relabeled on the host and its sweep
  dispatched to its device without waiting, and a frame is collected once
  ``len(devices)`` later frames have been dispatched. On one card the host
  relabel of frame k+1 overlaps the sweep of frame k; on several, the
  frames' sweeps run at once. At most ``len(devices) + 1`` frames hold
  device memory at a time, whatever the series' length.
- :func:`graph_series`: the per-timepoint cell PropertyGraphs.
- :func:`temporal_graph_from_images`: per-frame graphs + lineage mappings →
  one :class:`TemporalPropertyGraph` (the reference's
  ``TemporalPropertyGraph.extend`` flow).

Counterpart of ``tissue_analysis_tpu/series.py``. Each frame goes through
``dispatch_stack``'s ``engine="auto"``: the blocks of a frame that no block
sweep can take (past the dictionary, found by the count before its sweep)
go to the flat engine beside the frame's block sweep, or the whole frame
with a warning where that does not pay. A frame that fails raises: nothing
is rerouted after a launch.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence

from tissue_analysis_tpu_torch.core.stack import LabeledStack, resolve_device
from tissue_analysis_tpu_torch.engine import collect_stack, dispatch_stack
from tissue_analysis_tpu_torch.features.table import FeatureTable
from tissue_analysis_tpu_torch.graph.from_image import graph_from_table
from tissue_analysis_tpu_torch.graph.property_graph import (
    PropertyGraph,
    TemporalPropertyGraph,
)

__all__ = [
    "analyze_series",
    "graph_series",
    "temporal_graph_from_images",
    "read_lineage",
    "write_lineage",
]


def read_lineage(path: str) -> Dict[int, List[int]]:
    """Read a lineage mapping file: ``mother: d1 d2 ...`` or ``mother d1 d2``
    per line (the MARS-ALT tracking output convention); '#' comments."""
    out: Dict[int, List[int]] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            head, _, rest = line.partition(":")
            parts = (head + " " + rest).split()
            ids = [int(p) for p in parts]
            if len(ids) < 2:
                continue
            out.setdefault(ids[0], []).extend(ids[1:])
    return out


def write_lineage(path: str, lineage: Dict[int, List[int]]) -> None:
    with open(path, "w") as f:
        for mother in sorted(lineage):
            ds = lineage[mother]
            if not isinstance(ds, (list, tuple, set)):
                ds = [ds]
            f.write(f"{int(mother)}: {' '.join(str(int(d)) for d in ds)}\n")


def _bucket(n: int) -> int:
    b = 64
    while b < n:
        b <<= 1
    return b


def analyze_series(
    images: Sequence,
    background: Optional[int] = 1,
    voxelsize=None,
    devices: Optional[Sequence] = None,
) -> List[FeatureTable]:
    """Per-timepoint FeatureTables, each equal to ``analyze_stack`` of its
    frame.

    ``devices``: torch devices (default: the current CUDA device;
    ``["cpu"]`` for the CPU); frames are round-robined
    across them. Frames of one shape sweep a bucketed label count (the
    next power of two ≥ 64 above the largest seen so far), which keeps the
    reference's ``n_bucket`` contract and lets them share one converged
    dictionary size."""
    devs = [resolve_device(d) for d in devices] if devices else [resolve_device(None)]
    bucket_by_shape: Dict[tuple, int] = {}
    pending: deque = deque()
    tables: List[FeatureTable] = []
    for i, img in enumerate(images):
        stack = LabeledStack.from_array(
            img, voxelsize=voxelsize or getattr(img, "voxelsize", None),
            background=background, device=devs[i % len(devs)],
        )
        bucket = max(bucket_by_shape.get(stack.shape, 0), _bucket(stack.n_labels))
        bucket_by_shape[stack.shape] = bucket
        pending.append(dispatch_stack(stack, n_bucket=bucket))
        if len(pending) > len(devs):
            tables.append(collect_stack(pending.popleft()))
    tables.extend(collect_stack(h) for h in pending)
    return tables


def graph_series(
    images: Sequence,
    background: int = 1,
    voxelsize=None,
    devices: Optional[Sequence] = None,
    **graph_kwargs,
) -> List[PropertyGraph]:
    """Per-timepoint cell property graphs (one fused pass per frame)."""
    tables = analyze_series(
        images, background=background, voxelsize=voxelsize, devices=devices
    )
    return [
        graph_from_table(t, background=background, **graph_kwargs)
        for t in tables
    ]


def temporal_graph_from_images(
    images: Sequence,
    lineages: Optional[Sequence[Dict]] = None,
    background: int = 1,
    voxelsize=None,
    devices: Optional[Sequence] = None,
    **graph_kwargs,
) -> TemporalPropertyGraph:
    """Full temporal pipeline: images + lineage maps → lineage-linked graph.

    ``lineages[t]`` maps a mother label at timepoint t to its daughter
    label(s) at t+1 (the MARS-ALT lineage format the reference consumes).
    """
    graphs = graph_series(
        images,
        background=background,
        voxelsize=voxelsize,
        devices=devices,
        **graph_kwargs,
    )
    tpg = TemporalPropertyGraph()
    tpg.extend(graphs, lineages)
    return tpg
