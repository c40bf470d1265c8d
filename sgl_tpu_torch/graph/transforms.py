"""Structural graph transforms as pure functions ``Graph -> Graph``.

Counterpart of ``sgl_tpu/graph/transforms.py``: transforms return new
``Graph`` values and run on the host in numpy; they prepare datasets and
are not on the hot path.  Randomness is explicit: each random transform
takes a seed or a ``numpy.random.Generator``, and draws what ``sgl_tpu``
draws from it, so both packages drop the same edges and nodes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from sgl_tpu_torch.graph.graph import Graph


def _rng(seed) -> np.random.Generator:
    if isinstance(seed, np.random.Generator):
        return seed
    return np.random.default_rng(seed)


def _rebuild(graph: Graph, src, dst, val, num_nodes=None, x=None, y=None) -> Graph:
    return Graph.from_coo(
        src,
        dst,
        val,
        num_nodes=graph.num_nodes if num_nodes is None else num_nodes,
        x=graph.x if x is None else x,
        y=graph.y if y is None else y,
    )


def drop_edges(
    graph: Graph, edge_mask: np.ndarray, force_undirected: bool = False
) -> Graph:
    """Keep edges where ``edge_mask`` is True.

    With ``force_undirected`` the upper-triangle copies are dropped and the
    surviving lower-triangle edges are mirrored, so the result stays symmetric.
    """
    src, dst, val = graph.edges()
    edge_mask = np.asarray(edge_mask, dtype=bool).reshape(-1)
    if edge_mask.shape[0] != graph.num_edges:
        raise ValueError("edge mask length != num_edges")
    if force_undirected:
        edge_mask = edge_mask & ~(src > dst)
    src, dst, val = src[edge_mask], dst[edge_mask], val[edge_mask]
    if force_undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        val = np.concatenate([val, val])
    return _rebuild(graph, src, dst, val)


def random_drop_edges(
    graph: Graph, p: float = 0.5, force_undirected: bool = True, seed=0
) -> Graph:
    """Randomly drop edges with probability ``p``."""
    if not 0.0 <= p <= 1.0:
        raise ValueError("drop probability must be within [0, 1]")
    if p == 0.0:
        return graph
    keep = _rng(seed).random(graph.num_edges) >= p
    return drop_edges(graph, keep, force_undirected=force_undirected)


def biased_drop_edges(graph: Graph, edge_mask: np.ndarray) -> Graph:
    """Drop edge i where ``edge_mask[i]`` is False."""
    return drop_edges(graph, edge_mask)


def add_edges(
    graph: Graph,
    add_src,
    add_dst,
    add_val=None,
    del_repeated: bool = False,
) -> Graph:
    """Append edges."""
    add_src = np.asarray(add_src, dtype=np.int32).reshape(-1)
    add_dst = np.asarray(add_dst, dtype=np.int32).reshape(-1)
    if add_src.size and (
        add_src.min() < 0
        or add_dst.min() < 0
        or add_src.max() >= graph.num_nodes
        or add_dst.max() >= graph.num_nodes
    ):
        raise ValueError("indices must be in range of [0, num_node)")
    if add_val is None:
        add_val = np.ones_like(add_src, dtype=np.float32)
    src, dst, val = graph.edges()
    g = _rebuild(
        graph,
        np.concatenate([src, add_src]),
        np.concatenate([dst, add_dst]),
        np.concatenate([val, np.asarray(add_val, np.float32)]),
    )
    return delete_repeated_edges(g) if del_repeated else g


def delete_repeated_edges(graph: Graph) -> Graph:
    """Deduplicate (src, dst) pairs, keeping the first occurrence in
    (src, dst)-sorted order."""
    src, dst, val = graph.edges()
    key = src.astype(np.int64) * graph.num_nodes + dst.astype(np.int64)
    _, idx = np.unique(key, return_index=True)
    return _rebuild(graph, src[idx], dst[idx], val[idx])


def sort_edges(graph: Graph, by_src: bool = True) -> Graph:
    """Sort edges by (src, dst) or (dst, src).

    The canonical ``Graph`` layout is already dst-sorted; this builds other
    layouts, so the result is constructed with ``sort=False`` to keep the
    requested order (normalization re-sorts by dst for the SpMM).
    """
    src, dst, val = graph.edges()
    order = np.lexsort((dst, src)) if by_src else np.lexsort((src, dst))
    return Graph.from_coo(
        src[order],
        dst[order],
        val[order],
        num_nodes=graph.num_nodes,
        x=graph.x,
        y=graph.y,
        sort=False,
    )


def add_self_loops(graph: Graph, loop_val=None) -> Graph:
    """Append (i, i) edges for every node."""
    n = graph.num_nodes
    loop = np.arange(n, dtype=np.int32)
    if loop_val is not None and np.asarray(loop_val).shape[0] != n:
        raise ValueError("loop weights must have shape [num_node]")
    return add_edges(graph, loop, loop, loop_val)


def remove_self_loops(graph: Graph) -> Graph:
    """Drop all (i, i) edges."""
    src, dst, _ = graph.edges()
    return drop_edges(graph, src != dst)


def mask_features(
    x: np.ndarray, feature_mask: np.ndarray, kind: int = 0
) -> np.ndarray:
    """Zero features by row (kind=0), column (1), or element (2)."""
    x = np.array(x, copy=True)
    feature_mask = np.asarray(feature_mask, dtype=bool)
    n, f = x.shape
    if kind == 0:
        if feature_mask.shape[0] != n:
            raise ValueError("row mask dimension mismatch")
        x[feature_mask, :] = 0
    elif kind == 1:
        if feature_mask.shape[0] != f:
            raise ValueError("column mask dimension mismatch")
        x[:, feature_mask] = 0
    elif kind == 2:
        if feature_mask.shape != (n, f):
            raise ValueError("element mask dimension mismatch")
        x[feature_mask] = 0
    else:
        raise ValueError("mask kind must be 0, 1, or 2")
    return x


def get_subgraph(
    graph: Graph, node_mask: np.ndarray, keep_ids: bool = False
) -> Graph:
    """Induced subgraph over masked-in nodes.

    ``keep_ids=True`` keeps node numbering (dropped nodes become isolated and
    zero-featured); otherwise nodes are re-indexed compactly.
    """
    node_mask = np.asarray(node_mask, dtype=bool).reshape(-1)
    if node_mask.shape[0] != graph.num_nodes:
        raise ValueError("node mask length != num_nodes")
    src, dst, val = graph.edges()
    edge_mask = node_mask[src] & node_mask[dst]
    if keep_ids:
        x = graph.x
        if x is not None:
            x = np.array(x, copy=True)
            x[~node_mask, :] = 0
        return _rebuild(graph, src[edge_mask], dst[edge_mask], val[edge_mask], x=x)
    remap = -np.ones(graph.num_nodes, dtype=np.int64)
    kept = np.flatnonzero(node_mask)
    remap[kept] = np.arange(kept.shape[0])
    x = graph.x[kept] if graph.x is not None else None
    y = graph.y[kept] if graph.y is not None else None
    return Graph.from_coo(
        remap[src[edge_mask]],
        remap[dst[edge_mask]],
        val[edge_mask],
        num_nodes=int(kept.shape[0]),
        x=x,
        y=y,
    )


def random_drop_nodes(
    graph: Graph, p: float = 0.5, seed=0
) -> Tuple[Graph, np.ndarray]:
    """Randomly drop nodes; returns the new
    graph and the keep-mask."""
    if not 0.0 <= p <= 1.0:
        raise ValueError("drop probability must be within [0, 1]")
    keep = _rng(seed).random(graph.num_nodes) >= p
    return get_subgraph(graph, keep), keep


def to_undirected(graph: Graph) -> Graph:
    """Symmetrize: add reversed edges then deduplicate."""
    src, dst, val = graph.edges()
    g = _rebuild(
        graph,
        np.concatenate([src, dst]),
        np.concatenate([dst, src]),
        np.concatenate([val, val]),
    )
    return delete_repeated_edges(g)


def reorder_nodes(graph: Graph, perm: np.ndarray) -> Graph:
    """Relabel nodes by a permutation: new id of old node ``i`` is
    ``perm[i]``.  Features, labels, and edge endpoints move consistently.
    Splits indexed by old ids map through ``perm`` (``new_idx = perm[idx]``).

    Locality-aware renumbering balances graph partitions and tightens the
    source windows a row's gathers read.
    """
    perm = np.asarray(perm, np.int64)
    n = graph.num_nodes
    if perm.shape != (n,) or not np.array_equal(np.sort(perm), np.arange(n)):
        raise ValueError("perm must be a permutation of range(num_nodes)")
    src, dst, val = graph.edges()
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    x = None if graph.x is None else np.asarray(graph.x)[inv]
    y = None if graph.y is None else np.asarray(graph.y)[inv]
    return _rebuild(graph, perm[src], perm[dst], val, x=x, y=y)


def rcm_ordering(graph: Graph) -> np.ndarray:
    """Reverse-Cuthill-McKee permutation (bandwidth-minimizing): clustered
    or mesh-like graphs gather from much tighter source windows afterwards.
    Returns ``perm`` for :func:`reorder_nodes`."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    src, dst, val = graph.edges()
    n = graph.num_nodes
    m = sp.csr_matrix(
        (np.ones(src.shape[0], np.float32), (src, dst)), shape=(n, n)
    )
    order = reverse_cuthill_mckee(m, symmetric_mode=True)
    perm = np.empty(n, np.int64)
    perm[order] = np.arange(n)  # node order[k] gets new id k
    return perm


def degree_ordering(graph: Graph, descending: bool = True) -> np.ndarray:
    """Degree-sorted permutation: puts the hub nodes next to each other
    (descending by default); returns ``perm`` for :func:`reorder_nodes`."""
    src, _, val = graph.edges()
    deg = np.zeros(graph.num_nodes, np.float64)
    np.add.at(deg, src, np.where(val != 0, 1.0, 0.0))
    order = np.argsort(-deg if descending else deg, kind="stable")
    perm = np.empty(graph.num_nodes, np.int64)
    perm[order] = np.arange(graph.num_nodes)
    return perm


def laplacian_pe(graph: Graph, k: int) -> np.ndarray:
    """NAGphormer's positional encoding (its ``utils.get_dataset``): the
    ``k`` eigenvectors of ``L = I - D^-1/2 A D^-1/2`` after the one of the
    smallest eigenvalue, in ascending order of eigenvalue, as ``(N, k)``
    float32 columns.  On a connected graph these are the ``k`` of smallest
    nonzero eigenvalue.  ``A`` is the graph read as undirected and
    unweighted (an edge either way links two nodes), ``D`` its degrees, at
    least 1.  scipy's ``eigsh`` solves to working precision from a fixed
    start; each column's entry of largest magnitude is made positive, so
    the signs repeat.  Concatenate the result to the features and count its
    columns in the model's ``feat_dim``."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import eigsh

    n = graph.num_nodes
    if not 0 < k < n - 1:
        raise ValueError(f"k = {k} eigenvectors of a {n}-node graph: need 0 < k < {n - 1}")
    src, dst, _ = graph.edges()
    a = sp.csr_matrix((np.ones(src.shape[0]), (src, dst)), shape=(n, n))
    a = ((a + a.T) > 0).astype(np.float64)
    inv_sqrt = sp.diags(np.maximum(np.asarray(a.sum(axis=1)).ravel(), 1.0) ** -0.5)
    lap = sp.identity(n, format="csr") - inv_sqrt @ a @ inv_sqrt
    vals, vecs = eigsh(lap, k=k + 1, which="SA", v0=np.ones(n))
    vecs = vecs[:, np.argsort(vals)][:, 1:]
    sign = np.sign(vecs[np.abs(vecs).argmax(axis=0), np.arange(k)])
    return (vecs * sign).astype(np.float32)
