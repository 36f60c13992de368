"""graph_from_image — labeled image → cell PropertyGraph.

Parity target: ``graphs_from_image.py :: graph_from_image`` (SURVEY.md §2.1
row 7, §3.5): vertices = cells, edges = shared walls; vertex properties
``volume, barycenter, boundingbox, border, L1, inertia_axis,
epidermis_surface`` (the last for L1 cells only); edge property
``wall_surface``; ``label2vertex``/``vertex2label`` maps stored as graph
properties. Here the whole thing is served from ONE fused device pass
instead of one full-image pass per property.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

from tissue_analysis_tpu_torch.core.stack import LabeledStack
from tissue_analysis_tpu_torch.engine import analyze_stack
from tissue_analysis_tpu_torch.features.table import FeatureTable
from tissue_analysis_tpu_torch.graph.property_graph import PropertyGraph

__all__ = [
    "graph_from_image",
    "graph_from_table",
    "generate_graph_topology",
    "DEFAULT_PROPERTIES",
]

def _isin_ids(a: np.ndarray, values: np.ndarray) -> np.ndarray:
    """`np.isin(a, values)` for nonnegative label ids.

    np.isin is sort-based (~ms per call at 512³ scale); when the id range
    is modest a boolean lookup table answers in O(len(a)) gathers. Falls
    back to np.isin for huge/negative ids.
    """
    a = np.asarray(a)
    values = np.asarray(values)
    if a.size == 0 or values.size == 0:
        return np.zeros(a.shape, dtype=bool)
    vmax = int(values.max())
    if int(values.min()) < 0 or int(a.min()) < 0 or vmax >= (1 << 22):
        return np.isin(a, values)
    table = np.zeros(vmax + 2, dtype=bool)
    table[values] = True
    return table[np.minimum(a, vmax + 1)]


DEFAULT_PROPERTIES = (
    "volume",
    "barycenter",
    "boundingbox",
    "border",
    "L1",
    "inertia_axis",
    "epidermis_surface",
    "wall_surface",
)


def _bulk_topology(labels: Sequence[int], edge_pairs) -> PropertyGraph:
    """Topology from explicit (smaller label, larger label) edge pairs.

    Same graph as :func:`generate_graph_topology` (vertices numbered in
    label order, edges in ascending (l, nb) order) built without the
    per-label adjacency dict. ``edge_pairs`` may be a [E, 2] ndarray
    ALREADY sorted ascending and unique (the vectorized COO path), or any
    iterable of pairs (deduped and sorted here). Edge ids are sequential in
    that order — callers may rely on eid i == row i.
    """
    graph = PropertyGraph()
    label2vertex = {int(l): i for i, l in enumerate(labels)}
    if isinstance(edge_pairs, np.ndarray):
        # the eid==row contract requires sorted+unique rows; the COO caller
        # guarantees it, but verify cheaply (one vectorized diff) so an
        # unsorted/duplicated ndarray from a future caller cannot silently
        # attach wall_surface values to the wrong edges (ADVICE r2)
        if edge_pairs.shape[0] > 1:
            d0 = np.diff(edge_pairs[:, 0])
            d1 = np.diff(edge_pairs[:, 1])
            if not np.all((d0 > 0) | ((d0 == 0) & (d1 > 0))):
                raise ValueError(
                    "_bulk_topology: ndarray edge_pairs must be "
                    "lexicographically sorted and unique"
                )
        # vectorized label→vertex mapping (vertex i = labels[i]); bounded
        # nonnegative label spaces take an O(1)-gather lookup table — the
        # binary-search mapping costs ~2 ms per export at bench scale
        lab_arr = np.asarray(labels, dtype=np.int64)
        if lab_arr.size and lab_arr.min() >= 0 and lab_arr.max() < (1 << 22):
            lut = np.zeros(int(lab_arr.max()) + 1, dtype=np.int64)
            lut[lab_arr] = np.arange(lab_arr.size)
            vpairs = lut[edge_pairs]
        else:
            lorder = np.argsort(lab_arr, kind="stable")
            vpairs = lorder[np.searchsorted(lab_arr[lorder], edge_pairs)]
        graph._bulk_fill(len(labels), vpairs)
    else:
        pairs = sorted(set(edge_pairs))
        graph._bulk_fill(
            len(labels), [(label2vertex[a], label2vertex[b]) for a, b in pairs]
        )
    graph.add_graph_property("label2vertex", label2vertex)
    graph.add_graph_property(
        "vertex2label", {v: k for k, v in label2vertex.items()}
    )
    return graph


def generate_graph_topology(labels: Sequence[int], neighborhood) -> PropertyGraph:
    """Topology only: one vertex per label, one edge per unordered neighbor
    pair (``:: generate_graph_topology`` [M])."""
    graph = PropertyGraph()
    label2vertex = {}
    for l in labels:
        label2vertex[l] = graph.add_vertex()
    labelset = set(labels)
    for l in labels:
        for nb in neighborhood.get(l, []):
            if nb in labelset and l < nb:
                graph.add_edge(label2vertex[l], label2vertex[nb])
    graph.add_graph_property("label2vertex", label2vertex)
    graph.add_graph_property(
        "vertex2label", {v: k for k, v in label2vertex.items()}
    )
    return graph


def graph_from_image(
    image,
    labels: Optional[Sequence[int]] = None,
    background: int = 1,
    default_properties: Iterable[str] = DEFAULT_PROPERTIES,
    default_real_property: bool = True,
    bbox_as_real: bool = False,
    min_contact_area: Optional[float] = None,
    ignoredlabels: Iterable[int] = (),
    remove_stack_margins_cells: bool = False,
    device=None,
) -> PropertyGraph:
    stack = LabeledStack.from_array(
        image,
        voxelsize=getattr(image, "voxelsize", None),
        background=background,
        device=device,
    )
    table = analyze_stack(stack)
    return graph_from_table(
        table,
        labels=labels,
        background=background,
        default_properties=default_properties,
        default_real_property=default_real_property,
        bbox_as_real=bbox_as_real,
        min_contact_area=min_contact_area,
        ignoredlabels=ignoredlabels,
        remove_stack_margins_cells=remove_stack_margins_cells,
    )


def graph_from_table(
    table: FeatureTable,
    labels: Optional[Sequence[int]] = None,
    background: Optional[int] = None,
    default_properties: Iterable[str] = DEFAULT_PROPERTIES,
    default_real_property: bool = True,
    bbox_as_real: bool = False,
    min_contact_area: Optional[float] = None,
    ignoredlabels: Iterable[int] = (),
    remove_stack_margins_cells: bool = False,
) -> PropertyGraph:
    """Build the cell PropertyGraph from an already-computed FeatureTable."""
    from tissue_analysis_tpu_torch.utils import timing

    with timing.stage("graph: property-graph build"):
        return _graph_from_table_impl(
            table, labels, background, default_properties, default_real_property,
            bbox_as_real, min_contact_area, ignoredlabels,
            remove_stack_margins_cells,
        )


def _graph_from_table_impl(
    table, labels, background, default_properties, default_real_property,
    bbox_as_real, min_contact_area, ignoredlabels, remove_stack_margins_cells,
) -> PropertyGraph:
    if background is None:
        background = table.background_id
    ignored = set(int(i) for i in ignoredlabels) | {background}

    if remove_stack_margins_cells:
        ignored |= set(table.margin_labels()) - {background}

    ig_arr = np.asarray(
        sorted(i for i in ignored if i is not None), dtype=np.int64
    )
    if labels is None:
        ids_sorted = np.sort(table.ids)
        if ig_arr.size:
            ids_sorted = ids_sorted[~np.isin(ids_sorted, ig_arr)]
        labels = ids_sorted.tolist()
    else:
        lab = np.asarray([int(l) for l in labels], dtype=np.int64)
        if ig_arr.size:
            lab = lab[~np.isin(lab, ig_arr)]
        labels = lab.tolist()

    # topology straight from the COO pair arrays (vectorized — the
    # per-label adjacency dict would cost a host sort + python loops)
    la = table.ids[table.pair_lo]
    lb = table.ids[table.pair_hi]
    keep = np.ones(la.shape[0], dtype=bool)
    if min_contact_area is not None:
        keep &= table.wall_areas() >= min_contact_area
    lab_arr = np.asarray(labels, dtype=np.int64)
    keep &= _isin_ids(la, lab_arr) & _isin_ids(lb, lab_arr)
    # unordered pairs, lexicographically sorted + deduped in numpy (the
    # python sorted(set(...)) over ~10⁴ tuples costs real milliseconds);
    # `inv` maps each kept COO entry to its unique-pair row = its edge id
    amin = np.minimum(la[keep], lb[keep]).astype(np.int64)
    amax = np.maximum(la[keep], lb[keep]).astype(np.int64)
    # The device COO arrives lexicographically sorted and unique in segment
    # space; a monotone segment→label map preserves that. The standard ids
    # convention is monotone except the background swap at segment 0 —
    # whose pairs the `keep` filter drops — so in practice the kept pairs
    # are already sorted+unique: detect it (two diffs) and skip the
    # lexsort/dedup, which costs ~3 ms per export at bench scale.
    if amin.shape[0] > 1:
        d0 = np.diff(amin)
        d1 = np.diff(amax)
        presorted = bool(np.all((d0 > 0) | ((d0 == 0) & (d1 > 0))))
    else:
        presorted = True
    if presorted:
        uniq = np.stack([amin, amax], axis=1)
        inv = np.arange(amin.shape[0], dtype=np.int64)
    else:
        order = np.lexsort((amax, amin))
        ps, pl = amin[order], amax[order]
        if ps.shape[0]:
            new = np.empty(ps.shape[0], dtype=bool)
            new[0] = True
            new[1:] = (ps[1:] != ps[:-1]) | (pl[1:] != pl[:-1])
        else:
            new = np.zeros(0, dtype=bool)
        uniq = np.stack([ps[new], pl[new]], axis=1)
        inv = np.empty(ps.shape[0], dtype=np.int64)
        inv[order] = np.cumsum(new) - 1
    graph = _bulk_topology(labels, uniq)
    label2vertex = graph.graph_property("label2vertex")

    real = default_real_property
    props = set(default_properties)
    # vertex i == position of labels[i] (the _bulk_topology numbering), so
    # every per-vertex property dict is dict(enumerate(gathered values)) —
    # no per-label Python loop survives at 10⁵-label scale (VERDICT r2
    # weak #1). Segment lookup is one argsort+searchsorted gather.
    lab_q = np.asarray(labels, dtype=np.int64)
    ids_all = np.asarray(table.ids)
    if (
        lab_q.size
        and ids_all.size
        and lab_q.min() >= 0
        and ids_all.min() >= 0
        and ids_all.max() < (1 << 22)
    ):
        # O(1)-gather segment lookup with a -1 sentinel for absent labels
        lut = np.full(int(ids_all.max()) + 2, -1, dtype=np.int64)
        lut[ids_all] = np.arange(ids_all.shape[0])
        seg_arr = lut[np.minimum(lab_q, ids_all.max() + 1)]
        if np.any(seg_arr < 0):
            missing = lab_q[seg_arr < 0]
            raise KeyError(f"labels not present in table: {missing[:10].tolist()}")
    else:
        ids_order = np.argsort(ids_all, kind="stable")
        ids_sorted_all = ids_all[ids_order]
        pos = np.searchsorted(ids_sorted_all, lab_q)
        if lab_q.size:
            pos_c = np.minimum(pos, ids_sorted_all.shape[0] - 1)
            if not np.all(ids_sorted_all[pos_c] == lab_q):
                missing = lab_q[ids_sorted_all[pos_c] != lab_q]
                raise KeyError(
                    f"labels not present in table: {missing[:10].tolist()}"
                )
        seg_arr = ids_order[pos]
    seg_list = seg_arr.tolist()
    l1_arr = np.asarray(table.l1_labels(), dtype=np.int64)
    margins_arr = np.asarray(table.margin_labels(), dtype=np.int64)

    if "volume" in props:
        vol = table.volume(real=real)
        graph.add_vertex_property(
            "volume", dict(enumerate(vol[seg_arr].astype(np.float64).tolist()))
        )
    if "barycenter" in props:
        bary = table.barycenter(real=real)
        graph.add_vertex_property("barycenter", dict(enumerate(bary[seg_arr])))
    if "boundingbox" in props:
        if bbox_as_real:
            v = np.asarray(table.voxelsize, np.float64)
            starts = table.cmin[seg_arr] * v
            stops = (table.cmax[seg_arr] + 1) * v
            bb = {
                i: tuple(zip(s, e))
                for i, (s, e) in enumerate(
                    zip(starts.tolist(), stops.tolist())
                )
            }
        else:
            slices = table.bounding_slices()
            bb = {i: slices[s] for i, s in enumerate(seg_list)}
        graph.add_vertex_property("boundingbox", bb)
    if "border" in props:
        graph.add_vertex_property(
            "border", dict(enumerate(_isin_ids(lab_q, margins_arr).tolist()))
        )
    if "L1" in props:
        graph.add_vertex_property(
            "L1", dict(enumerate(_isin_ids(lab_q, l1_arr).tolist()))
        )
    if "inertia_axis" in props:
        evals, evecs = table.inertia_axes(real=real)
        ev_g, ec_g = evals[seg_arr], evecs[seg_arr]
        # zip iterates the arrays' first axes at C speed (row views) —
        # the indexed dict comp pays ~2 numpy __getitem__ calls per label
        graph.add_vertex_property(
            "inertia_axis", dict(enumerate(zip(ec_g, ev_g)))
        )
    if "epidermis_surface" in props:
        epi = table.epidermis_wall_area()
        in_l1 = _isin_ids(lab_q, l1_arr)
        vidx = np.nonzero(in_l1)[0].tolist()
        vvals = epi[seg_arr[in_l1]].tolist()
        graph.add_vertex_property("epidermis_surface", dict(zip(vidx, vvals)))
    if "wall_surface" in props:
        vals = (
            table.wall_areas()
            if real
            else table.wall_voxel_face_totals()
        )
        # accumulate per unique unordered pair (eid i == uniq row i by
        # _bulk_topology's contract), vectorized; on the presorted path inv
        # is the identity and np.add.at (slow buffered scatter) is skipped
        if presorted:
            sums = np.ascontiguousarray(vals[keep])
        else:
            sums = np.zeros(uniq.shape[0], dtype=vals.dtype)
            np.add.at(sums, inv, vals[keep])
        wall_prop = graph.add_edge_property("wall_surface")
        if real:
            wall_prop.update(enumerate(sums.astype(np.float64).tolist()))
        else:
            wall_prop.update(enumerate(sums.astype(np.int64).tolist()))

    graph.add_graph_property("voxelsize", tuple(table.voxelsize))
    graph.add_graph_property("background", background)
    graph.add_graph_property("shape", tuple(table.shape))
    return graph
