"""Homogeneous padded-COO graph container (host numpy).

Counterpart of ``sgl_tpu/graph/graph.py::Graph`` with the same layout and
padding convention, so both packages build identical arrays from the same
edges:

* edges are sorted by ``dst``, three flat arrays ``(src, dst, val)``: up
  to :data:`NATIVE_SORT_EDGES` edges by ``(dst, src)`` (numpy
  ``lexsort``), above it by ``dst`` alone with the input order kept within
  a row (the native OpenMP counting sort of ``graph/native.py``, or its
  stable numpy fallback), as ``sgl_tpu`` sorts;
* padding edges are ``src=0, dst=num_nodes-1, val=0``: they contribute
  zero to degrees and products and keep ``dst`` sorted.

The graph stays in host memory; the graph ops build device tensors from it.

``Node``, ``Edge`` and :class:`HeteroGraph` are the heterogeneous
containers of ``sgl_tpu/graph/graph.py``: typed node sets with global id
offsets per type, typed COO edge sets, and the relation-subset subgraph
that NARS samples from them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sgl_tpu_torch.graph import native

#: Above this many edges :meth:`Graph.from_coo` sorts with the native
#: stable sort by dst instead of ``lexsort`` (``sgl_tpu``'s threshold).
NATIVE_SORT_EDGES = 1_000_000


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_amount(num_edges: int, multiple: int) -> int:
    """Edges are padded to a bucket multiple (same buckets as ``sgl_tpu``)."""
    return max(_round_up(max(num_edges, 1), multiple) - num_edges, 0)


@dataclasses.dataclass(frozen=True)
class Graph:
    """Padded-COO homogeneous graph.

    ``src``/``dst``/``val`` have length ``num_edges_padded``; entries past
    ``num_edges`` are zero-valued padding.  Messages flow ``src -> dst``.
    """

    src: np.ndarray  # [E_pad] int32
    dst: np.ndarray  # [E_pad] int32
    val: np.ndarray  # [E_pad] float32, 0 on padding
    x: Optional[np.ndarray]  # [N, D] node features
    y: Optional[np.ndarray]  # [N] or [N, C] node labels
    num_nodes: int
    num_edges: int  # real (un-padded) edge count

    @staticmethod
    def from_coo(
        src,
        dst,
        val=None,
        *,
        num_nodes: int,
        x=None,
        y=None,
        pad_multiple: int = 1024,
        sort: bool = True,
    ) -> "Graph":
        src = np.asarray(src, dtype=np.int32).reshape(-1)
        dst = np.asarray(dst, dtype=np.int32).reshape(-1)
        if val is None:
            val = np.ones(src.shape[0], dtype=np.float32)
        else:
            val = np.asarray(val, dtype=np.float32).reshape(-1)
        if not (src.shape == dst.shape == val.shape):
            raise ValueError("src/dst/val must have identical 1-D shapes")
        if src.size and (src.min() < 0 or src.max() >= num_nodes):
            raise ValueError("src indices out of range")
        if dst.size and (dst.min() < 0 or dst.max() >= num_nodes):
            raise ValueError("dst indices out of range")
        num_edges = int(src.shape[0])
        if sort and num_edges:
            if num_edges > NATIVE_SORT_EDGES:
                src, dst, val = native.sort_edges_by_dst(src, dst, val, num_nodes)
            else:
                order = np.lexsort((src, dst))
                src, dst, val = src[order], dst[order], val[order]
        pad = pad_amount(num_edges, pad_multiple)
        if pad:
            src = np.concatenate([src, np.zeros(pad, np.int32)])
            dst = np.concatenate([dst, np.full(pad, max(num_nodes - 1, 0), np.int32)])
            val = np.concatenate([val, np.zeros(pad, np.float32)])
        if x is not None:
            x = np.asarray(x, dtype=np.float32)
            if x.shape[0] != num_nodes:
                raise ValueError("feature row count != num_nodes")
        if y is not None:
            y = np.asarray(y)
        return Graph(src, dst, val, x, y, num_nodes, num_edges)

    @property
    def num_edges_padded(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_features(self) -> int:
        if self.x is None:
            raise ValueError("graph has no node features")
        return int(self.x.shape[1])

    @property
    def num_classes(self) -> int:
        if self.y is None:
            raise ValueError("graph has no labels")
        y = np.asarray(self.y)
        if y.ndim > 1 and y.shape[-1] > 1:
            return int(y.shape[-1])
        return int(y.max()) + 1

    def node_degrees(self) -> np.ndarray:
        """Weighted out-degree (row sums of the stored adjacency)."""
        deg = np.zeros(self.num_nodes, dtype=np.float32)
        np.add.at(deg, np.asarray(self.src), np.asarray(self.val))
        return deg

    def in_degrees(self) -> np.ndarray:
        """Weighted in-degree (column sums of the stored adjacency)."""
        deg = np.zeros(self.num_nodes, dtype=np.float32)
        np.add.at(deg, np.asarray(self.dst), np.asarray(self.val))
        return deg

    def replace(self, **kw) -> "Graph":
        return dataclasses.replace(self, **kw)

    def edges(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Real (un-padded) edges as numpy arrays."""
        e = self.num_edges
        return self.src[:e], self.dst[:e], self.val[:e]


@dataclasses.dataclass
class Node:
    """A typed node set: features ``x``, labels ``y``, global ids."""

    node_type: str
    node_ids: np.ndarray
    x: Optional[np.ndarray] = None
    y: Optional[np.ndarray] = None

    @property
    def num_nodes(self) -> int:
        return int(len(self.node_ids))


@dataclasses.dataclass
class Edge:
    """A typed edge set in COO form (global node ids)."""

    edge_type: str
    src: np.ndarray
    dst: np.ndarray
    val: Optional[np.ndarray] = None

    def __post_init__(self):
        self.src = np.asarray(self.src, dtype=np.int64).reshape(-1)
        self.dst = np.asarray(self.dst, dtype=np.int64).reshape(-1)
        if self.val is None:
            self.val = np.ones(self.src.shape[0], dtype=np.float32)

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


class HeteroGraph:
    """Heterogeneous graph: typed node sets and typed edge sets.

    Node ids are globally unique: type ``t`` occupies the contiguous range
    ``[offset[t], offset[t] + num_node[t])``, types in insertion order.
    """

    def __init__(self, nodes: Dict[str, Node], edges: Dict[str, Edge]):
        self.nodes = dict(nodes)
        self.edges = dict(edges)
        self.node_types = list(self.nodes.keys())
        self.edge_types = list(self.edges.keys())
        self.num_node = {t: n.num_nodes for t, n in self.nodes.items()}
        self.offset: Dict[str, int] = {}
        acc = 0
        for t in self.node_types:
            self.offset[t] = acc
            acc += self.num_node[t]
        self.total_num_nodes = acc
        self.node_id_dict = {
            t: np.arange(self.offset[t], self.offset[t] + self.num_node[t]) for t in self.node_types
        }

    @staticmethod
    def build(
        node_counts: Dict[str, int],
        edge_index_dict: Dict[Tuple[str, str, str], Tuple[np.ndarray, np.ndarray]],
        x_dict: Optional[Dict[str, np.ndarray]] = None,
        y_dict: Optional[Dict[str, np.ndarray]] = None,
        edge_val_dict: Optional[Dict[Tuple[str, str, str], np.ndarray]] = None,
    ) -> "HeteroGraph":
        """Build from per-type counts and local-id COO edge dicts.

        Edge keys are ``(src_type, relation, dst_type)`` and become the edge
        type ``"src_type__relation__dst_type"``; local ids are shifted to
        global ids by the per-type offsets.
        """
        x_dict = x_dict or {}
        y_dict = y_dict or {}
        edge_val_dict = edge_val_dict or {}
        offsets: Dict[str, int] = {}
        acc = 0
        for t, n in node_counts.items():
            offsets[t] = acc
            acc += n
        nodes = {
            t: Node(t, np.arange(offsets[t], offsets[t] + n), x_dict.get(t), y_dict.get(t))
            for t, n in node_counts.items()
        }
        edges = {}
        for (st, rel, dt), (s, d) in edge_index_dict.items():
            name = f"{st}__{rel}__{dt}"
            s = np.asarray(s, dtype=np.int64) + offsets[st]
            d = np.asarray(d, dtype=np.int64) + offsets[dt]
            edges[name] = Edge(name, s, d, edge_val_dict.get((st, rel, dt)))
        return HeteroGraph(nodes, edges)

    def __getitem__(self, node_type: str) -> Node:
        return self.nodes[node_type]

    def edge_type_parts(self, edge_type: str) -> Tuple[str, str, str]:
        st, rel, dt = edge_type.split("__")
        return st, rel, dt

    def sample_by_edge_type(
        self, edge_types: Sequence[str], pad_multiple: int = 1024
    ) -> Tuple[Graph, np.ndarray]:
        """Union subgraph over a relation subset, re-indexed to local ids,
        made undirected and deduplicated.

        Returns ``(graph, node_id)`` where ``node_id[i]`` is the global id of
        local node ``i``.  Every node of every participating type is kept,
        ordered by global id, so each type is a contiguous local-id block.
        The pairs are deduplicated on the sorted key ``src * N + dst``, which
        orders them by ``(src, dst)`` as ``sgl_tpu``'s ``np.unique(axis=0)``
        does.
        """
        srcs: List[np.ndarray] = []
        dsts: List[np.ndarray] = []
        types_in = set()
        for et in edge_types:
            e = self.edges[et]
            st, _, dt = self.edge_type_parts(et)
            types_in.update((st, dt))
            srcs.append(e.src)
            dsts.append(e.dst)
        src = np.concatenate(srcs)
        dst = np.concatenate(dsts)
        node_id = np.sort(
            np.concatenate([self.node_id_dict[t] for t in self.node_types if t in types_in])
        )
        n = int(node_id.shape[0])
        remap = -np.ones(self.total_num_nodes, dtype=np.int64)
        remap[node_id] = np.arange(n)
        ls, ld = remap[src], remap[dst]
        key = np.sort(np.concatenate([ls * n + ld, ld * n + ls]))
        # np.unique's result, by sort: numpy 2.3's np.unique hashes integer
        # keys first, ~75x slower than the sort at 10M keys
        key = key[np.concatenate(([True], key[1:] != key[:-1]))]
        g = Graph.from_coo(key // n, key % n, num_nodes=n, pad_multiple=pad_multiple)
        return g, node_id


def from_scipy(adj, x=None, y=None, pad_multiple: int = 1024) -> Graph:
    """A :class:`Graph` from any scipy sparse matrix (row = src, col = dst)."""
    coo = adj.tocoo()
    return Graph.from_coo(
        coo.row, coo.col, coo.data, num_nodes=int(adj.shape[0]), x=x, y=y,
        pad_multiple=pad_multiple,
    )


def to_scipy(graph: Graph):
    """The real edges as a scipy CSR matrix (row = src, col = dst)."""
    import scipy.sparse as sp

    s, d, v = graph.edges()
    return sp.csr_matrix((v, (s, d)), shape=(graph.num_nodes, graph.num_nodes))
