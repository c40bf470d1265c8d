"""Sparse adjacency × dense features: the SpMM every propagation hop runs.

Counterpart of ``sgl_tpu/kernels/sparse.py``.  Message direction is
``y[dst] += w * x[src]``.  Dispatch follows the tensor, with no backend
switch: a CUDA tensor goes to the hand-written CSR kernel
(``spmm_csr.py``), a CPU tensor to the plain gather + ``index_add_``
version.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SparseAdj:
    """A sparse matrix in padded COO form, ready for SpMM.

    ``w`` already contains any normalization; padding edges carry ``w == 0``
    and in-range indices.  ``sorted_by_dst`` records that ``dst`` is sorted.
    """

    src: torch.Tensor  # [E] int32
    dst: torch.Tensor  # [E] int32
    w: torch.Tensor  # [E] float32
    num_nodes: int
    sorted_by_dst: bool = False


def spmm_segment(adj: SparseAdj, x: torch.Tensor) -> torch.Tensor:
    """``y = adj @ x`` by gather, ×w and a scatter-add, summed in f32.

    The plain PyTorch version of the product: the CPU path and the twin the
    CUDA kernel is held against.  The sum is taken in f32 for every input
    dtype and cast back to ``x.dtype`` once, as the kernel does (and as the
    TPU kernel does; ``sgl_tpu``'s own XLA segment path sums bf16 in bf16).
    """
    msgs = x.index_select(0, adj.src.long()).float() * adj.w[:, None].float()
    y = torch.zeros((adj.num_nodes, x.shape[1]), dtype=torch.float32, device=x.device)
    if y.is_cuda:
        # index_add_ on CUDA adds with atomics, in an order that changes from
        # run to run; index_put_(accumulate=True) sorts the rows stably and
        # adds each row's messages in edge order, as the CSR kernel does, so
        # the two differ only by the kernel's fused multiply-add rounding.
        y.index_put_((adj.dst.long(),), msgs, accumulate=True)
    else:
        y.index_add_(0, adj.dst.long(), msgs)
    return y.to(x.dtype)


def spmm(adj, x: torch.Tensor) -> torch.Tensor:
    """Sparse-matrix × dense-features product.

    ``adj`` is a :class:`SparseAdj` or a
    :class:`~sgl_tpu_torch.kernels.spmm_csr.CsrAdj` (build once per graph
    with ``prepare_csr`` and reuse it across hops).  On a CUDA tensor the
    product runs on the CSR kernel, building the CSR layout first when given
    a :class:`SparseAdj`; on a CPU tensor it runs the plain version.
    """
    from sgl_tpu_torch.kernels.spmm_csr import prepare_csr, spmm_csr

    if isinstance(adj, SparseAdj):
        if x.device.type == "cpu":
            return spmm_segment(adj, x)
        adj = prepare_csr(adj)
    return spmm_csr(adj, x)
