"""Temporal (lineage) analysis over TemporalPropertyGraph.

Parity targets: ``temporal_graph_analysis.py`` (SURVEY.md §2.1 row 8, §3.6
— ~700 LoC upstream): ``temporal_change(g, prop, vids, rank)`` (forward AND
backward rank), ``relative_temporal_change``, ``temporal_rate``,
``exist_relative_at_rank`` / ``exist_all_relative_at_rank``, division
statistics (``dividing_cells``, ``division_events``, ``nb_descendants``,
``division_rate``, ``division_asymmetry``) and per-lineage aggregates
(``lineage_vertices``, ``per_lineage_aggregate``, ``lineage_volumes``).
All host-side and small — the per-timepoint feature extraction upstream is
the device-heavy part.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from tissue_analysis_tpu_torch.graph.property_graph import TemporalPropertyGraph

__all__ = [
    "exist_relative_at_rank",
    "exist_all_relative_at_rank",
    "temporal_change",
    "relative_temporal_change",
    "temporal_rate",
    "lineage_volumes",
    "lineage_vertices",
    "per_lineage_aggregate",
    "dividing_cells",
    "division_events",
    "nb_descendants",
    "division_rate",
    "division_asymmetry",
    "time_point_property",
    "sibling_cells",
]


def exist_relative_at_rank(g: TemporalPropertyGraph, vid: int, rank: int) -> bool:
    """True if the vertex has descendants (rank>0) / an ancestor (rank<0)."""
    if rank == 0:
        return True
    if rank > 0:
        return len(g.descendants_at_rank(vid, rank)) > 0
    return g.ancestor_at_rank(vid, -rank) is not None


def exist_all_relative_at_rank(
    g: TemporalPropertyGraph, vids: Sequence[int], rank: int
) -> bool:
    """True if EVERY requested vertex has a relative at the rank."""
    return all(exist_relative_at_rank(g, v, rank) for v in vids)


def _descendant_property_sum(g, name: str, vid: int, rank: int) -> Optional[float]:
    """Σ property over rank-descendants (division splits a mother's quantity)."""
    desc = g.descendants_at_rank(vid, rank)
    if not desc:
        return None
    prop = g.vertex_property(name)
    vals = [prop[d] for d in desc if d in prop]
    if len(vals) != len(desc):
        return None
    return float(np.sum(vals))


def temporal_change(
    g: TemporalPropertyGraph,
    name: str,
    vids: Optional[Sequence[int]] = None,
    rank: int = 1,
) -> Dict[int, float]:
    """Absolute property change across ``rank`` timepoints
    (``:: temporal_change``).

    rank > 0 (forward): Σ property(descendants at t+rank) − property(vid).
    rank < 0 (backward): the same quantity anchored at the rank-ancestor and
    reported per living cell — Σ property(the ancestor's |rank|-descendants,
    i.e. vid and its generation cousins from the same lineage) − property
    (ancestor). Cells whose relative is missing are omitted (dict
    semantics: only computable vids appear).
    """
    prop = g.vertex_property(name)
    if rank == 0:
        vids = list(g.vertices()) if vids is None else vids
        return {v: 0.0 for v in vids if v in prop}
    if vids is None:
        vids = [v for v in g.vertices() if exist_relative_at_rank(g, v, rank)]
    out: Dict[int, float] = {}
    for v in vids:
        if rank > 0:
            if v not in prop:
                continue
            after = _descendant_property_sum(g, name, v, rank)
            if after is None:
                continue
            out[v] = after - float(prop[v])
        else:
            anc = g.ancestor_at_rank(v, -rank)
            if anc is None or anc not in prop:
                continue
            after = _descendant_property_sum(g, name, anc, -rank)
            if after is None:
                continue
            out[v] = after - float(prop[anc])
    return out


def _initial_value(g, name: str, vid: int, rank: int) -> Optional[float]:
    """The denominator of a relative change: the vid's own value for
    forward ranks, the ancestor's for backward ranks."""
    prop = g.vertex_property(name)
    if rank >= 0:
        return float(prop[vid]) if vid in prop else None
    anc = g.ancestor_at_rank(vid, -rank)
    if anc is None or anc not in prop:
        return None
    return float(prop[anc])


def relative_temporal_change(
    g: TemporalPropertyGraph,
    name: str,
    vids: Optional[Sequence[int]] = None,
    rank: int = 1,
) -> Dict[int, float]:
    """Change divided by the initial value (``:: relative_temporal_change``);
    supports backward ranks like :func:`temporal_change`."""
    abs_change = temporal_change(g, name, vids, rank)
    out: Dict[int, float] = {}
    for v, c in abs_change.items():
        base = _initial_value(g, name, v, rank)
        if base:
            out[v] = c / base
    return out


def temporal_rate(
    g: TemporalPropertyGraph,
    name: str,
    vids: Optional[Sequence[int]] = None,
    rank: int = 1,
    delta_t: float = 1.0,
) -> Dict[int, float]:
    """Per-unit-time relative growth: (Σafter/before)^(1/Δt) − 1."""
    prop = g.vertex_property(name)
    if vids is None:
        vids = [v for v in g.vertices() if exist_relative_at_rank(g, v, rank)]
    out: Dict[int, float] = {}
    for v in vids:
        if rank > 0:
            if v not in prop or float(prop[v]) == 0.0:
                continue
            after = _descendant_property_sum(g, name, v, rank)
            base = float(prop[v])
        else:
            anc = g.ancestor_at_rank(v, -rank)
            if anc is None or anc not in prop or float(prop[anc]) == 0.0:
                continue
            after = _descendant_property_sum(g, name, anc, -rank)
            base = float(prop[anc])
        if after is None:
            continue
        out[v] = (after / base) ** (1.0 / delta_t) - 1.0
    return out


# --------------------------------------------------------------- divisions
def dividing_cells(g: TemporalPropertyGraph, time_point: Optional[int] = None) -> List[int]:
    """Vertices with ≥ 2 children (division between t and t+1)."""
    vids = g.vertex_at_time(time_point) if time_point is not None else g.vertices()
    return sorted(v for v in vids if len(g.children(v)) >= 2)


def division_events(
    g: TemporalPropertyGraph, time_point: Optional[int] = None
) -> List[Tuple[int, List[int]]]:
    """(mother, daughters) for every division."""
    return [(v, g.children(v)) for v in dividing_cells(g, time_point)]


def nb_descendants(
    g: TemporalPropertyGraph,
    vids: Optional[Sequence[int]] = None,
    rank: int = 1,
) -> Dict[int, int]:
    """Daughter counts per cell at the given rank (1 = no division)."""
    if vids is None:
        vids = [v for v in g.vertices() if exist_relative_at_rank(g, v, rank)]
    return {v: len(g.descendants_at_rank(v, rank)) for v in vids}


def division_rate(g: TemporalPropertyGraph, time_point: int) -> float:
    """Fraction of time-``t`` cells with lineage data that divide by t+1."""
    vids = [v for v in g.vertex_at_time(time_point) if g.children(v)]
    if not vids:
        return 0.0
    return sum(1 for v in vids if len(g.children(v)) >= 2) / len(vids)


def division_asymmetry(
    g: TemporalPropertyGraph, mother: int, name: str = "volume"
) -> Optional[float]:
    """min/max property ratio between daughters (1 = symmetric division);
    None for non-dividing cells or missing values."""
    kids = g.children(mother)
    if len(kids) < 2:
        return None
    prop = g.vertex_property(name)
    vals = [float(prop[k]) for k in kids if k in prop]
    if len(vals) != len(kids) or max(vals) == 0.0:
        return None
    return min(vals) / max(vals)


# ---------------------------------------------------------------- lineages
def lineage_vertices(g: TemporalPropertyGraph, vid: int) -> List[int]:
    """The vertex and ALL its descendants (the lineage subtree)."""
    out = [vid]
    cur = [vid]
    while cur:
        nxt: List[int] = []
        for v in cur:
            nxt.extend(g.children(v))
        out.extend(nxt)
        cur = nxt
    return sorted(set(out))


def per_lineage_aggregate(
    g: TemporalPropertyGraph,
    name: str,
    func: Callable = np.sum,
    roots: Optional[Sequence[int]] = None,
) -> Dict[int, float]:
    """{root: func(property over the root's lineage subtree)}.

    ``roots`` defaults to every time-0 vertex. Lineage-wide statistics
    (total produced volume, mean cell size of a clone, …) in one call.
    """
    if roots is None:
        roots = g.vertex_at_time(0)
    prop = g.vertex_property(name)
    out: Dict[int, float] = {}
    for r in roots:
        vals = [float(prop[v]) for v in lineage_vertices(g, r) if v in prop]
        if vals:
            out[r] = float(func(vals))
    return out


def lineage_volumes(g: TemporalPropertyGraph, vid: int) -> List[float]:
    """Volume trajectory of a cell lineage (sums over daughters after division)."""
    prop = g.vertex_property("volume")
    out = [float(prop[vid])]
    cur = [vid]
    while True:
        nxt: List[int] = []
        for v in cur:
            nxt.extend(g.children(v))
        if not nxt:
            break
        out.append(float(np.sum([prop[v] for v in nxt])))
        cur = nxt
    return out


# ------------------------------------------------------------- convenience
def time_point_property(
    g: TemporalPropertyGraph, name: str, time_point: int
) -> Dict:
    """{original label: value} for one timepoint (the reference's per-frame
    dict view of a temporal property)."""
    prop = g.vertex_property(name)
    old = g.vertex_property("old_label")
    return {
        old[v]: prop[v]
        for v in g.vertex_at_time(time_point)
        if v in prop
    }


def sibling_cells(g: TemporalPropertyGraph, vid: int) -> List[int]:
    """Other daughters of the same mother (empty without lineage data)."""
    p = g.parent(vid)
    if p is None:
        return []
    return [k for k in g.children(p) if k != vid]
