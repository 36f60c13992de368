"""PropertyGraph / TemporalPropertyGraph.

Equivalent capability to the reference's external dependency
``openalea.container`` (SURVEY.md §1, §2.1 rows 7–8): a vertex/edge graph
with named property maps, and its temporal extension linking per-timepoint
cell graphs through lineage mappings. Freshly implemented (dict-of-dicts,
networkx-exportable) — small host-side data structures; the voxel-heavy work
happens upstream on device.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["PropertyGraph", "TemporalPropertyGraph"]


class PropertyGraph:
    """Undirected graph with vertex / edge / graph property maps."""

    def __init__(self):
        self.__v: Dict[int, set] = {}  # vid -> set of eids
        self.__e: Dict[int, Tuple[int, int]] = {}  # eid -> (vid_a, vid_b)
        self.__lazy = None  # pending bulk topology: (n_vertices, [E,2] arr)
        self._vertex_properties: Dict[str, Dict[int, object]] = {}
        self._edge_properties: Dict[str, Dict[int, object]] = {}
        self._graph_properties: Dict[str, object] = {}
        self._next_vid = 0
        self._next_eid = 0

    # The dict-of-sets topology view is LAZY after a `_bulk_fill`: building
    # ~2k Python sets + ~28k int payloads costs ~20-35 ms at 512³ — a
    # measurable slice of the whole pass — and counting/iteration/property
    # consumers never need it. Every dict access goes through these
    # properties, so the first access that truly needs dicts (add_vertex,
    # neighbors, save, ...) materializes once; counts, iteration and
    # edge_vertices answer straight from the array.
    @property
    def _vertices(self) -> Dict[int, set]:
        if self.__lazy is not None:
            self._materialize_topology()
        return self.__v

    @_vertices.setter
    def _vertices(self, val):
        self.__v = val

    @property
    def _edges(self) -> Dict[int, Tuple[int, int]]:
        if self.__lazy is not None:
            self._materialize_topology()
        return self.__e

    @_edges.setter
    def _edges(self, val):
        self.__e = val

    # ------------------------------------------------------------ topology
    def add_vertex(self, vid: Optional[int] = None) -> int:
        if vid is None:
            vid = self._next_vid
        if vid in self._vertices:
            raise ValueError(f"vertex {vid} already exists")
        self._vertices[vid] = set()
        self._next_vid = max(self._next_vid, vid + 1)
        return vid

    def add_edge(self, vid_a: int, vid_b: int, eid: Optional[int] = None) -> int:
        if vid_a not in self._vertices or vid_b not in self._vertices:
            raise ValueError(f"edge endpoints must exist: ({vid_a}, {vid_b})")
        if eid is None:
            eid = self._next_eid
        if eid in self._edges:
            raise ValueError(f"edge {eid} already exists")
        self._edges[eid] = (vid_a, vid_b)
        self._vertices[vid_a].add(eid)
        self._vertices[vid_b].add(eid)
        self._next_eid = max(self._next_eid, eid + 1)
        return eid

    def _bulk_fill(self, n_vertices: int, edges) -> None:
        """Fast-path topology fill: vertices 0..n-1, sequential edge ids.

        Equivalent to n_vertices × add_vertex() + add_edge(a, b) per edge
        (same ids, same incidence sets) without the per-call validation —
        the property-graph build is host-side Python and these loops were
        a measurable slice of the 512³ pass.
        """
        arr = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        self.__lazy = (int(n_vertices), arr)
        self._next_vid = int(n_vertices)
        self._next_eid = int(arr.shape[0])

    def _materialize_topology(self) -> None:
        """Build the dict-of-sets view from a pending `_bulk_fill` array.

        Python-int payloads via ONE bulk .tolist(); per-edge tuple(row)
        over numpy rows plus 2E set.add calls with numpy-int hashing
        cost ~22 ms at 512³ — grouping incidence with a vectorized sort
        and building each set from a list slice is C-speed throughout.
        """
        n_vertices, arr = self.__lazy
        self.__lazy = None
        self.__e = {
            i: (a, b) for i, (a, b) in enumerate(arr.tolist())
        }
        E = arr.shape[0]
        both_v = np.concatenate([arr[:, 0], arr[:, 1]])
        both_e = np.concatenate([np.arange(E), np.arange(E)])
        order = np.argsort(both_v, kind="stable")
        sv = both_v[order]
        se = both_e[order].tolist()
        bounds = np.searchsorted(
            sv, np.arange(n_vertices + 1)
        ).tolist()
        self.__v = {
            v: set(se[bounds[v]:bounds[v + 1]]) for v in range(n_vertices)
        }

    def vertices(self) -> Iterable[int]:
        if self.__lazy is not None:
            return iter(range(self.__lazy[0]))
        return iter(self.__v)

    def edges(self) -> Iterable[int]:
        if self.__lazy is not None:
            return iter(range(self.__lazy[1].shape[0]))
        return iter(self.__e)

    def nb_vertices(self) -> int:
        if self.__lazy is not None:
            return self.__lazy[0]
        return len(self.__v)

    def nb_edges(self) -> int:
        if self.__lazy is not None:
            return int(self.__lazy[1].shape[0])
        return len(self.__e)

    def edge_vertices(self, eid: int) -> Tuple[int, int]:
        if self.__lazy is not None:
            arr = self.__lazy[1]
            if isinstance(eid, (int, np.integer)) and 0 <= eid < arr.shape[0]:
                return (int(arr[eid, 0]), int(arr[eid, 1]))
            raise KeyError(eid)
        return self.__e[eid]

    def edge_id(self, vid_a: int, vid_b: int) -> Optional[int]:
        for eid in self._vertices.get(vid_a, ()):
            if set(self._edges[eid]) == {vid_a, vid_b} or self._edges[eid] == (
                vid_a,
                vid_b,
            ):
                return eid
        return None

    def neighbors(self, vid: int) -> List[int]:
        out = set()
        for eid in self._vertices[vid]:
            a, b = self._edges[eid]
            out.add(b if a == vid else a)
        return sorted(out)

    # ----------------------------------------------------------- properties
    def add_vertex_property(self, name: str, values: Optional[Dict] = None):
        self._vertex_properties.setdefault(name, {})
        if values:
            self._vertex_properties[name].update(values)
        return self._vertex_properties[name]

    def vertex_property(self, name: str) -> Dict[int, object]:
        return self._vertex_properties[name]

    def vertex_property_names(self) -> List[str]:
        return sorted(self._vertex_properties)

    def add_edge_property(self, name: str, values: Optional[Dict] = None):
        self._edge_properties.setdefault(name, {})
        if values:
            self._edge_properties[name].update(values)
        return self._edge_properties[name]

    def edge_property(self, name: str) -> Dict[int, object]:
        return self._edge_properties[name]

    def edge_property_names(self) -> List[str]:
        return sorted(self._edge_properties)

    def add_graph_property(self, name: str, value=None):
        self._graph_properties[name] = value
        return value

    def graph_property(self, name: str):
        return self._graph_properties[name]

    def graph_property_names(self) -> List[str]:
        return sorted(self._graph_properties)

    # -------------------------------------------------------------- export
    def to_networkx(self):
        """Export to networkx.Graph with properties as attributes."""
        import networkx as nx

        g = nx.Graph()
        for vid in self._vertices:
            attrs = {
                name: vals[vid]
                for name, vals in self._vertex_properties.items()
                if vid in vals
            }
            g.add_node(vid, **attrs)
        for eid, (a, b) in self._edges.items():
            attrs = {
                name: vals[eid]
                for name, vals in self._edge_properties.items()
                if eid in vals
            }
            g.add_edge(a, b, eid=eid, **attrs)
        g.graph.update(self._graph_properties)
        return g

    def to_dict(self) -> Dict:
        """Plain serializable dict (the durable artifact, SURVEY.md §5)."""
        return {
            "vertices": sorted(self._vertices),
            "edges": {eid: list(vs) for eid, vs in self._edges.items()},
            "vertex_properties": self._vertex_properties,
            "edge_properties": self._edge_properties,
            "graph_properties": self._graph_properties,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "PropertyGraph":
        g = cls()  # subclass __init__ seeds its base properties; merged below
        for vid in d["vertices"]:
            g.add_vertex(int(vid))
        for eid, (a, b) in d["edges"].items():
            g.add_edge(int(a), int(b), eid=int(eid))
        for name, vals in d["vertex_properties"].items():
            g.add_vertex_property(name, dict(vals))
        for name, vals in d["edge_properties"].items():
            g.add_edge_property(name, dict(vals))
        for name, val in d["graph_properties"].items():
            g.add_graph_property(name, val)
        return g

    def save(self, path: str) -> None:
        """Pickle the graph (matches the reference's pickle persistence of
        PropertyGraphs, SURVEY.md §5 checkpoint row)."""
        import pickle

        with open(path, "wb") as f:
            pickle.dump(self.to_dict(), f)

    @classmethod
    def load(cls, path: str) -> "PropertyGraph":
        import pickle

        with open(path, "rb") as f:
            return cls.from_dict(pickle.load(f))


class TemporalPropertyGraph(PropertyGraph):
    """Lineage-linked sequence of per-timepoint cell graphs (SURVEY.md §3.6).

    ``extend(graphs, mappings)`` appends timepoint graphs; ``mappings[t]``
    maps a mother label at t to its daughter label list at t+1. Structural
    edges keep the per-timepoint topology; temporal edges (``edge_type`` 't')
    realize the lineage. Vertex property ``index`` holds the timepoint.
    """

    STRUCTURAL = "s"
    TEMPORAL = "t"

    def __init__(self):
        super().__init__()
        self.add_vertex_property("index")
        self.add_vertex_property("old_label")
        self.add_edge_property("edge_type")
        self.add_graph_property("nb_time_points", 0)
        # per timepoint: {original label -> vid}
        self._label2vertex_per_time: List[Dict[Hashable, int]] = []

    def extend(
        self,
        graphs: Sequence[PropertyGraph],
        mappings: Optional[Sequence[Dict]] = None,
    ) -> "TemporalPropertyGraph":
        if mappings is not None and len(mappings) != len(graphs) - 1:
            raise ValueError("need one lineage mapping per consecutive graph pair")
        start_t = self.graph_property("nb_time_points")
        for ti, g in enumerate(graphs):
            t = start_t + ti
            label2vertex = {}
            g_l2v = {}
            try:
                g_l2v = g.graph_property("label2vertex")
            except KeyError:
                pass
            vertex2label = {v: k for k, v in g_l2v.items()}
            relabel = {}
            for vid in g.vertices():
                new_vid = self.add_vertex()
                relabel[vid] = new_vid
                self.vertex_property("index")[new_vid] = t
                old = vertex2label.get(vid, vid)
                self.vertex_property("old_label")[new_vid] = old
                label2vertex[old] = new_vid
            for name in g.vertex_property_names():
                dst = self.add_vertex_property(name)
                for vid, val in g.vertex_property(name).items():
                    dst[relabel[vid]] = val
            for eid in g.edges():
                a, b = g.edge_vertices(eid)
                new_eid = self.add_edge(relabel[a], relabel[b])
                self.edge_property("edge_type")[new_eid] = self.STRUCTURAL
                for name in g.edge_property_names():
                    dst = self.add_edge_property(name)
                    if eid in g.edge_property(name):
                        dst[new_eid] = g.edge_property(name)[eid]
            self._label2vertex_per_time.append(label2vertex)
        # temporal lineage edges
        if mappings is not None:
            for ti, mapping in enumerate(mappings):
                t = start_t + ti
                l2v_m = self._label2vertex_per_time[t]
                l2v_d = self._label2vertex_per_time[t + 1]
                for mother, daughters in mapping.items():
                    if mother not in l2v_m:
                        continue
                    if not isinstance(daughters, (list, tuple, set)):
                        daughters = [daughters]
                    for d in daughters:
                        if d in l2v_d:
                            eid = self.add_edge(l2v_m[mother], l2v_d[d])
                            self.edge_property("edge_type")[eid] = self.TEMPORAL
        self.add_graph_property("nb_time_points", start_t + len(graphs))
        return self

    # --------------------------------------------------------- navigation
    def vertex_at_time(self, t: int) -> List[int]:
        idx = self.vertex_property("index")
        return sorted(v for v, ti in idx.items() if ti == t)

    def children(self, vid: int) -> List[int]:
        idx = self.vertex_property("index")
        et = self.edge_property("edge_type")
        out = []
        for eid in self._vertices[vid]:
            if et.get(eid) != self.TEMPORAL:
                continue
            a, b = self._edges[eid]
            other = b if a == vid else a
            if idx[other] == idx[vid] + 1:
                out.append(other)
        return sorted(out)

    def parent(self, vid: int) -> Optional[int]:
        idx = self.vertex_property("index")
        et = self.edge_property("edge_type")
        for eid in self._vertices[vid]:
            if et.get(eid) != self.TEMPORAL:
                continue
            a, b = self._edges[eid]
            other = b if a == vid else a
            if idx[other] == idx[vid] - 1:
                return other
        return None

    def descendants_at_rank(self, vid: int, rank: int) -> List[int]:
        cur = [vid]
        for _ in range(rank):
            nxt: List[int] = []
            for v in cur:
                nxt.extend(self.children(v))
            cur = nxt
        return sorted(set(cur))

    def ancestor_at_rank(self, vid: int, rank: int) -> Optional[int]:
        cur: Optional[int] = vid
        for _ in range(rank):
            if cur is None:
                return None
            cur = self.parent(cur)
        return cur
