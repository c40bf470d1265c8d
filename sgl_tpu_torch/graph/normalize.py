"""Adjacency normalization as edge-weight transforms, computed on the device.

Counterpart of ``sgl_tpu/graph/normalize.py``: per stored edge ``(s, t, a)``
of ``Â = A + I`` the weight is ``w = deg[t]^(r-1) * a * deg[s]^(-r)`` with
``deg = rowsum(Â)`` and messages flowing ``x[s] -> y[t]``; ``r = 0.5`` is
the GCN ``D^-1/2 Â D^-1/2``.  Degrees are summed with ``index_add_`` on the
target device and the edges are then sorted by dst (stable), at every graph
size (``sgl_tpu`` routes graphs past 8M edges to a native host builder).
"""

from __future__ import annotations

import torch

from sgl_tpu_torch.device import resolve_device
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
