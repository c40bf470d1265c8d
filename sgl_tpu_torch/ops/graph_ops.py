"""Graph ops: k-hop propagation as a loop of SpMMs.

Counterpart of ``sgl_tpu/ops/graph_ops.py``.  A graph op normalizes the
graph once on the target device, lays it out as a dst-CSR (cached per graph
and device), and runs one SpMM per hop.  Propagation is training-free, so
it runs under ``torch.no_grad()`` (the counterpart of ``stop_gradient``).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.graph.graph import Graph
from sgl_tpu_torch.graph.normalize import ppr_weights, symmetric_normalized_weights
from sgl_tpu_torch.kernels.sparse import SparseAdj, spmm
from sgl_tpu_torch.kernels.spmm_csr import CsrAdj, prepare_csr


@torch.no_grad()
def k_hop_propagate(adj, x: torch.Tensor, prop_steps: int) -> torch.Tensor:
    """``[X, AX, A²X, …]`` stacked as ``(prop_steps+1, N, D)``."""
    out = torch.empty((prop_steps + 1, *x.shape), dtype=x.dtype, device=x.device)
    out[0] = x
    h = x
    for k in range(1, prop_steps + 1):
        h = spmm(adj, h)
        out[k] = h
    return out


@torch.no_grad()
def k_hop_aggregate(adj, x: torch.Tensor, weights, prop_steps: int) -> torch.Tensor:
    """``sum_k weights[k] · A^k x`` without materializing the hop stack:
    peak memory O(N·D) instead of O((K+1)·N·D).  Used for linear message
    ops.  The sum is kept in f32 for bf16 hops too and cast back to
    ``x.dtype`` at the end."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=x.device)
    acc = w[0] * x.float()
    h = x
    for k in range(1, prop_steps + 1):
        h = spmm(adj, h)
        acc += w[k] * h.float()
    return acc.to(x.dtype)


def _as_compute_dtype(x, device: torch.device) -> torch.Tensor:
    """f32 by default; bf16 passes through (the opt-in bf16 precompute —
    the CSR kernel has a bf16 variant)."""
    x = torch.as_tensor(x, device=device)
    if x.dtype == torch.bfloat16:
        return x.contiguous()
    return x.to(torch.float32).contiguous()


class GraphOp:
    """Propagation operator: builds a normalized adjacency from a ``Graph``
    and runs the k-hop loop."""

    def __init__(self, prop_steps: int):
        self.prop_steps = prop_steps
        self._adj_cache = (None, None, None)  # (weakref(graph), device, CsrAdj)

    def construct_adj(self, graph: Graph, device: torch.device) -> SparseAdj:
        raise NotImplementedError

    def _adj_for(self, graph: Graph, device: torch.device) -> CsrAdj:
        """Normalized dst-CSR adjacency on ``device``, with a one-entry
        cache: repeated propagation over one graph (preprocess, then
        postprocess) builds the layout once."""
        ref, cached_device, cached = self._adj_cache
        if ref is not None and ref() is graph and cached_device == device:
            return cached
        adj = prepare_csr(self.construct_adj(graph, device))
        self._adj_cache = (weakref.ref(graph), device, adj)
        return adj

    def _check(self, graph: Graph, x) -> None:
        if graph.num_nodes != np.shape(x)[0]:
            raise ValueError(
                "Dimension mismatch detected for the adjacency and the feature matrix!"
            )

    def propagate(self, graph: Graph, x, device=None) -> torch.Tensor:
        """``(K+1, N, D)`` hop stack on ``device`` (default: the GPU)."""
        self._check(graph, x)
        device = resolve_device(device)
        adj = self._adj_for(graph, device)
        return k_hop_propagate(adj, _as_compute_dtype(x, device), self.prop_steps)

    def propagate_aggregate(self, graph: Graph, x, weights, device=None) -> torch.Tensor:
        """Fused ``sum_k weights[k] A^k x`` (see :func:`k_hop_aggregate`)."""
        self._check(graph, x)
        device = resolve_device(device)
        adj = self._adj_for(graph, device)
        return k_hop_aggregate(
            adj, _as_compute_dtype(x, device), np.asarray(weights, np.float32), self.prop_steps
        )


class LaplacianGraphOp(GraphOp):
    """Generalized symmetric normalization ``D^{r-1} Â D^{-r}`` (r=0.5 = GCN)."""

    def __init__(self, prop_steps: int, r: float = 0.5):
        super().__init__(prop_steps)
        self.r = r

    def construct_adj(self, graph: Graph, device: torch.device) -> SparseAdj:
        return symmetric_normalized_weights(graph, r=self.r, device=device)


class PprGraphOp(GraphOp):
    """Personalized-PageRank transition ``(1-α)Ā + αI`` (APPNP-style)."""

    def __init__(self, prop_steps: int, r: float = 0.5, alpha: float = 0.15):
        super().__init__(prop_steps)
        self.r = r
        self.alpha = alpha

    def construct_adj(self, graph: Graph, device: torch.device) -> SparseAdj:
        return ppr_weights(graph, r=self.r, alpha=self.alpha, device=device)
