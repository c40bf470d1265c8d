"""Adjacency normalization as edge-weight transforms, computed on the device.

Counterpart of ``sgl_tpu/graph/normalize.py``: per stored edge ``(s, t, a)``
of ``Â = A + I`` the weight is ``w = deg[t]^(r-1) * a * deg[s]^(-r)`` with
``deg = rowsum(Â)`` and messages flowing ``x[s] -> y[t]``; ``r = 0.5`` is
the GCN ``D^-1/2 Â D^-1/2``.  Degrees are summed with ``index_add_`` on the
target device and the edges are then sorted by dst (stable), at every graph
size.

The ``*_host`` twins compute the same weights on the host with the native
builder (``graph/native.py``) and return a dst-sorted :class:`SparseAdj` of
CPU tensors.  ``sgl_tpu``'s graph op switches to them above
:data:`HOST_NORM_EDGE_THRESHOLD` edges, because its device sits behind a
slow link; the port's graph op normalizes on the card at every size, and
the host twins are there for callers that build on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.graph import native
from sgl_tpu_torch.graph.graph import Graph
from sgl_tpu_torch.kernels.sparse import SparseAdj


def _safe_pow(deg: torch.Tensor, p: float) -> torch.Tensor:
    """deg**p with 0**negative -> 0 (the reference zeroes infs)."""
    pos = deg > 0
    return torch.where(pos, torch.where(pos, deg, 1.0).pow(p), 0.0)


def _with_self_loops(graph: Graph, device: torch.device):
    """Edges of ``Â = A + I`` (the N self edges appended at the end) and the
    row degrees of ``Â``."""
    n = graph.num_nodes
    loop = torch.arange(n, dtype=torch.int32, device=device)
    src = torch.cat([torch.as_tensor(graph.src, device=device), loop])
    dst = torch.cat([torch.as_tensor(graph.dst, device=device), loop])
    val = torch.cat(
        [torch.as_tensor(graph.val, device=device), torch.ones(n, device=device)]
    )
    deg = torch.zeros(n, device=device).index_add_(0, src.long(), val)
    return src, dst, val, deg


def _sorted_adj(src, dst, w, num_nodes: int, sort: bool) -> SparseAdj:
    if sort:
        order = torch.argsort(dst, stable=True)
        src, dst, w = src[order], dst[order], w[order]
    return SparseAdj(src, dst, w, num_nodes, sorted_by_dst=sort)


def symmetric_normalized_weights(
    graph: Graph, r: float = 0.5, sort: bool = True, device=None
) -> SparseAdj:
    """Generalized symmetric normalization ``D^{r-1} Â^T D^{-r}``."""
    device = resolve_device(device)
    src, dst, val, deg = _with_self_loops(graph, device)
    w = _safe_pow(deg, r - 1.0)[dst.long()] * val * _safe_pow(deg, -r)[src.long()]
    return _sorted_adj(src, dst, w, graph.num_nodes, sort)


def ppr_weights(
    graph: Graph, r: float = 0.5, alpha: float = 0.15, sort: bool = True, device=None
) -> SparseAdj:
    """Personalized-PageRank transition ``(1-α)·Ā + α·I`` over the
    symmetric-normalized ``Ā``."""
    device = resolve_device(device)
    n = graph.num_nodes
    src, dst, val, deg = _with_self_loops(graph, device)
    w = _safe_pow(deg, r - 1.0)[dst.long()] * val * _safe_pow(deg, -r)[src.long()]
    w = w * (1.0 - alpha)
    # the N self edges are the trailing block appended by _with_self_loops
    w[-n:] += alpha
    return _sorted_adj(src, dst, w, n, sort)


def _host_norm_edges(graph: Graph, r: float):
    """The edges of ``Â = A + I`` (self loops appended) with generalized
    symmetric weights, on the host."""
    n = graph.num_nodes
    loop = np.arange(n, dtype=np.int32)
    s = np.concatenate([np.asarray(graph.src, np.int32), loop])
    d = np.concatenate([np.asarray(graph.dst, np.int32), loop])
    v = np.concatenate([np.asarray(graph.val, np.float32), np.ones(n, np.float32)])
    deg = native.compute_degrees(s, v, n)
    return s, d, native.normalized_weights(s, d, v, deg, r)


def _host_adj(s, d, w, num_nodes: int) -> SparseAdj:
    s, d, w = native.sort_edges_by_dst(s, d, w, num_nodes)
    return SparseAdj(torch.from_numpy(s), torch.from_numpy(d), torch.from_numpy(w), num_nodes,
                     sorted_by_dst=True)


def symmetric_normalized_weights_host(graph: Graph, r: float = 0.5) -> SparseAdj:
    """Host twin of :func:`symmetric_normalized_weights`: the same weights
    in the same (stable dst) order, as CPU tensors."""
    return _host_adj(*_host_norm_edges(graph, r), graph.num_nodes)


def ppr_weights_host(graph: Graph, r: float = 0.5, alpha: float = 0.15) -> SparseAdj:
    """Host twin of :func:`ppr_weights` (the trailing self loops get ``+α``)."""
    n = graph.num_nodes
    s, d, w = _host_norm_edges(graph, r)
    w = w * np.float32(1.0 - alpha)
    w[-n:] += np.float32(alpha)
    return _host_adj(s, d, w, n)


#: ``sgl_tpu``'s graph op normalizes on the host above this many edges; the
#: port's normalizes on the card at every size (see the module docstring).
HOST_NORM_EDGE_THRESHOLD = 8 << 20


def row_normalized_weights(
    graph: Graph, add_self_loops: bool = True, sort: bool = True, device=None
) -> SparseAdj:
    """Random-walk normalization ``D^{-1} Â`` (messages averaged over the
    in-neighbors of each destination)."""
    device = resolve_device(device)
    if add_self_loops:
        src, dst, val, _ = _with_self_loops(graph, device)
    else:
        src = torch.as_tensor(graph.src, device=device)
        dst = torch.as_tensor(graph.dst, device=device)
        val = torch.as_tensor(graph.val, device=device)
    deg_in = torch.zeros(graph.num_nodes, device=device).index_add_(0, dst.long(), val)
    w = val * _safe_pow(deg_in, -1.0)[dst.long()]
    return _sorted_adj(src, dst, w, graph.num_nodes, sort)
