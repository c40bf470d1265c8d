"""Block-diagonal graph batching — counterpart of ``sgl_tpu/graph/batch.py``.

A batch of graphs is one big :class:`~sgl_tpu_torch.graph.Graph` whose
adjacency is block-diagonal, so the propagation stack (normalization, the
CSR kernel, the hop loop) runs over the whole batch with one launch a hop,
and a per-graph readout is one segment reduction over ``graph_ids``.  The
concatenated edges go through :meth:`Graph.from_coo`'s sort, so the batch
has ``sgl_tpu``'s edge order, above :data:`NATIVE_SORT_EDGES` edges too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from sgl_tpu_torch.graph.graph import Graph


@dataclasses.dataclass
class GraphBatch:
    """A set of graphs packed as one block-diagonal :class:`Graph`.

    ``graph_ids[i]`` is the graph owning node row ``i``; ``node_counts``
    holds each graph's real node count (a mean readout divides by it).
    """

    graph: Graph
    graph_ids: np.ndarray  # (N_total,) int32
    node_counts: np.ndarray  # (num_graphs,) int32
    num_graphs: int
    y: Optional[np.ndarray] = None  # (num_graphs,) graph labels

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    @property
    def num_features(self) -> int:
        return self.graph.num_features


def batch_graphs(graphs: Sequence[Graph], y=None, pad_multiple: int = 1024) -> GraphBatch:
    """Pack ``graphs`` into one block-diagonal :class:`GraphBatch`.

    Node ids of graph ``g`` shift by the cumulative node count; edge values
    are kept.  Features are concatenated (all graphs have features, or
    none has).
    """
    if not graphs:
        raise ValueError("batch_graphs needs at least one graph")
    counts = np.asarray([g.num_nodes for g in graphs], np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    n_total = int(offsets[-1])

    srcs, dsts, vals = [], [], []
    for g, off in zip(graphs, offsets[:-1]):
        s, d, v = g.edges()
        srcs.append(s.astype(np.int64) + off)
        dsts.append(d.astype(np.int64) + off)
        vals.append(v)

    has_x = graphs[0].x is not None
    if any((g.x is not None) != has_x for g in graphs):
        raise ValueError("either all graphs have features or none do")
    x = np.concatenate([np.asarray(g.x) for g in graphs]) if has_x else None

    graph_ids = np.repeat(np.arange(len(graphs), dtype=np.int32), counts)
    batched = Graph.from_coo(
        np.concatenate(srcs), np.concatenate(dsts), np.concatenate(vals),
        num_nodes=n_total, x=x, pad_multiple=pad_multiple,
    )
    return GraphBatch(
        graph=batched,
        graph_ids=graph_ids,
        node_counts=counts.astype(np.int32),
        num_graphs=len(graphs),
        y=None if y is None else np.asarray(y),
    )
