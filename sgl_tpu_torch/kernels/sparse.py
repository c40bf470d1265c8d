"""Sparse adjacency × dense features: the SpMM every propagation hop runs.

Counterpart of ``sgl_tpu/kernels/sparse.py``.  Message direction is
``y[dst] += w * x[src]``.  By default dispatch follows the tensor: a CUDA
tensor goes to the hand-written CSR kernel (``spmm_csr.py``), a CPU tensor
to the plain gather + ``index_add_`` version.  :func:`set_default_backend`
(or ``spmm``'s ``backend=``) overrides that: ``"segment"`` takes the plain
version on any device, ``"pallas"`` the CSR kernel, which needs a CUDA
tensor (the name is ``sgl_tpu``'s, whose kernel of that name is the TPU
one).

:func:`spmm` is differentiable in ``x``: when ``x`` needs a gradient the
product goes through :class:`_Spmm`, whose backward is ``dx = Aᵀ g`` on the
same route (the CSR kernel on the transposed CSR on the card, the plain
product on the transposed edges on the CPU), the counterpart of
``spmm_pallas``'s ``custom_vjp`` (``pallas_spmm.py:559, 923-934``).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional

import torch

BACKENDS = ("auto", "segment", "pallas")
_DEFAULT_BACKEND = "auto"


def set_default_backend(name: str) -> None:
    """Select the default SpMM backend: ``"auto"`` (the CSR kernel on a CUDA
    tensor, the plain version on a CPU one), ``"segment"`` (the plain
    version on any device) or ``"pallas"`` (the CSR kernel; a CPU tensor
    raises)."""
    global _DEFAULT_BACKEND
    if name not in BACKENDS:
        raise ValueError(f"unknown spmm backend {name!r}")
    _DEFAULT_BACKEND = name


def get_default_backend() -> str:
    """The backend :func:`spmm` takes when called without ``backend=``."""
    return _DEFAULT_BACKEND


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

    @property
    def nnz_padded(self) -> int:
        """The stored edges, the zero-weight padding edges included (as
        ``sgl_tpu``'s: both keep the padding ``Graph.from_coo`` adds)."""
        return int(self.src.shape[0])

    def transpose(self) -> "SparseAdj":
        """The same edges reversed: ``Aᵀ``, no longer sorted by dst."""
        return SparseAdj(self.dst, self.src, self.w, self.num_nodes, False)


def spmm_segment(adj: SparseAdj, x: torch.Tensor) -> torch.Tensor:
    """``y = adj @ x`` by gather, ×w and a scatter-add, summed in f32.

    The plain PyTorch version of the product: the CPU path and the twin the
    CUDA kernel is held against.  The sum is taken in f32 for every input
    dtype and cast back to ``x.dtype`` once, as the kernel does (and as the
    TPU kernel does; ``sgl_tpu``'s own XLA segment path sums bf16 in bf16).
    """
    return segment_sum_f32(adj, x).to(x.dtype)


def segment_sum_f32(adj: SparseAdj, x: torch.Tensor) -> torch.Tensor:
    """:func:`spmm_segment` before its cast: the f32 sum for f32, bf16 and
    f16 ``x``; a float64 ``x`` (``gradcheck``) is summed in float64."""
    acc = torch.promote_types(x.dtype, torch.float32)
    msgs = x.index_select(0, adj.src.long()).to(acc) * adj.w[:, None].to(acc)
    y = torch.zeros((adj.num_nodes, x.shape[1]), dtype=acc, device=x.device)
    return add_rows_(y, adj.dst, msgs)


def add_rows_(y: torch.Tensor, rows: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``y[rows[i]] += values[i]`` in place, each row's values added one by
    one in the order of ``i``; returns ``y``."""
    if y.is_cuda:
        # index_add_ on CUDA adds with atomics, in an order that changes from
        # run to run; index_put_(accumulate=True) sorts the rows stably and
        # adds each row's values in order, as the CSR kernel does, so the two
        # differ only by the kernel's fused multiply-add rounding.
        y.index_put_((rows.long(),), values, accumulate=True)
    else:
        y.index_add_(0, rows.long(), values)
    return y


def spmm(adj, x: torch.Tensor, backend: Optional[str] = None) -> torch.Tensor:
    """Sparse-matrix × dense-features product.

    ``adj`` is a :class:`SparseAdj` or a
    :class:`~sgl_tpu_torch.kernels.spmm_csr.CsrAdj` (build once per graph
    with ``prepare_csr``, or :func:`ensure_device_layout`, and reuse it
    across hops).  ``backend`` (default: :func:`set_default_backend`'s)
    picks the route.  ``"auto"``: on a CUDA tensor the CSR kernel, building
    the CSR layout first when given a :class:`SparseAdj`; on a CPU tensor
    the plain version.  ``"segment"``: :func:`spmm_segment` on any device
    (a ``CsrAdj`` is read back as its edges).  ``"pallas"``: the CSR
    kernel, which raises on a CPU tensor.  When ``x`` needs a gradient the
    same product runs inside :class:`_Spmm`; otherwise nothing is recorded
    and the launches and bits are those of the plain call.
    """
    from sgl_tpu_torch.kernels.spmm_csr import prepare_csr

    backend = backend or _DEFAULT_BACKEND
    if backend not in BACKENDS:
        raise ValueError(f"unknown spmm backend {backend!r}")
    if backend == "segment":
        adj = csr_edges(adj)
    elif backend == "pallas" and x.device.type == "cpu":
        raise ValueError("the 'pallas' spmm backend is the CUDA kernel; x lies on the CPU")
    elif isinstance(adj, SparseAdj) and x.device.type != "cpu":
        adj = prepare_csr(adj)
    if x.requires_grad and torch.is_grad_enabled():
        return _Spmm.apply(adj, x)
    return _product(adj, x)


def csr_edges(adj) -> SparseAdj:
    """A ``CsrAdj`` as the :class:`SparseAdj` of its edges, in row order
    (sorted by dst); a :class:`SparseAdj` unchanged."""
    if isinstance(adj, SparseAdj):
        return adj
    counts = torch.diff(adj.rowptr.long())
    dst = torch.repeat_interleave(torch.arange(adj.num_nodes, device=adj.col.device, dtype=torch.int32), counts)
    return SparseAdj(adj.col, dst, adj.val, adj.num_nodes, sorted_by_dst=True)


def _product(adj, x: torch.Tensor) -> torch.Tensor:
    from sgl_tpu_torch.kernels.spmm_csr import spmm_csr

    if isinstance(adj, SparseAdj):
        return spmm_segment(adj, x)
    return spmm_csr(adj, x)


class _Spmm(torch.autograd.Function):
    """``y = A x`` with ``dx = Aᵀ g``: K1's gradient (``_spmm_pallas_bwd``).

    A :class:`SparseAdj` (the CPU's layout) is transposed by swapping its
    edges' ends and runs the plain product; a ``CsrAdj`` runs the CSR
    kernel on its transposed CSR, built once per ``CsrAdj`` with its own
    plan (``spmm_csr.transposed``).  The port's CSR keeps the self-loops
    and hub edges in their rows, so the diag and hub carriers of the TPU
    layout, and ``extras_transpose_vjp`` with them, have no counterpart:
    the transposed CSR carries every edge.  No gradient flows to the
    weights, as in ``sgl_tpu``.
    """

    @staticmethod
    def forward(ctx, adj, x):
        ctx.adj = adj
        return _product(adj, x)

    @staticmethod
    def backward(ctx, g):
        from sgl_tpu_torch.kernels.spmm_csr import transposed

        adj = ctx.adj
        adj_t = adj.transpose() if isinstance(adj, SparseAdj) else transposed(adj)
        return None, _product(adj_t, g.contiguous())


# the last few (weakref(SparseAdj), CsrAdj) pairs: label propagation and
# C&S build a fresh SparseAdj per call and run many products on it
_LAYOUT_CACHE: list = []
_LAYOUT_CACHE_SIZE = 8


def ensure_device_layout(adj):
    """The CSR layout of ``adj`` when it lies on a CUDA device, built once
    and kept for the last :data:`_LAYOUT_CACHE_SIZE` adjacencies (matched
    by identity, through a weak reference); ``adj`` unchanged when it lies
    on the CPU or is a ``CsrAdj`` already.

    The counterpart of ``sgl_tpu``'s ``ensure_device_layout``: task code
    that is handed a :class:`SparseAdj` (label propagation, Correct &
    Smooth) runs every product of it on the CSR kernel without preparing
    the layout at each call.
    """
    from sgl_tpu_torch.kernels.spmm_csr import prepare_csr

    if not isinstance(adj, SparseAdj) or adj.src.device.type == "cpu":
        return adj
    for ref, csr in _LAYOUT_CACHE:
        if ref() is adj:
            return csr
    csr = prepare_csr(adj)
    _LAYOUT_CACHE.append((weakref.ref(adj), csr))
    del _LAYOUT_CACHE[:-_LAYOUT_CACHE_SIZE]
    return csr


def spmm_multi(adjs, x: torch.Tensor) -> torch.Tensor:
    """R products over one edge structure under R weight sets:
    ``y[r] = adjs[r] @ x[r]``, as ``(R, N, D)``.

    ``x`` is ``(R, N, D)``, or ``(N, D)`` for the same features under every
    weight set.  On a CUDA tensor this runs the CSR kernel once per r (each
    :class:`SparseAdj` through :func:`ensure_device_layout`), as
    ``sgl_tpu``'s NAFS runs ``spmm_pallas`` once per r on the TPU
    (``node_clustering.py:174-181``).  On a CPU tensor it is
    :func:`spmm_multi_gather`, or, given ``CsrAdj``, the CSR kernel's plain
    twin once per r.
    """
    x = _broadcast_multi(len(adjs), x)
    if x.device.type == "cpu" and all(isinstance(a, SparseAdj) for a in adjs):
        return spmm_multi_gather(adjs, x)
    return torch.stack([spmm(ensure_device_layout(a), x[i].contiguous()) for i, a in enumerate(adjs)])


def _broadcast_multi(r: int, x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 2:
        x = x.expand(r, *x.shape)
    if x.dim() != 3 or x.shape[0] != r:
        raise ValueError(f"x must be [{r}, N, D] or [N, D], got {tuple(x.shape)}")
    return x


def spmm_multi_gather(adjs, x: torch.Tensor) -> torch.Tensor:
    """The plain form of :func:`spmm_multi` (``sgl_tpu``'s,
    ``sparse.py:141-172``): the R feature blocks packed side by side as one
    ``(N, R·D)`` array, so each edge gathers its source row once for all r,
    then ×w per block and one f32 scatter-add.

    ``adjs`` are :class:`SparseAdj` that share ``src`` and ``dst`` (the
    normalizations of one graph keep its edge order) and differ in ``w``;
    only the shapes are checked.
    """
    r = len(adjs)
    x = _broadcast_multi(r, x)
    a0 = adjs[0]
    if any(a.w.shape != a0.w.shape for a in adjs):
        raise ValueError("spmm_multi's adjacencies must share one edge structure")
    _, n, d = x.shape
    xs = x.movedim(0, 1).reshape(n, r * d)
    acc = torch.promote_types(x.dtype, torch.float32)
    w = torch.stack([a.w for a in adjs], dim=1).to(acc)  # (E, R)
    msgs = xs.index_select(0, a0.src.long()).to(acc).view(-1, r, d) * w[:, :, None]
    y = torch.zeros((n, r * d), dtype=acc, device=x.device)
    add_rows_(y, a0.dst, msgs.view(-1, r * d))
    return y.view(n, r, d).movedim(1, 0).to(x.dtype)


def sddmm(adj: SparseAdj, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense product: ``<a[src], b[dst]>`` per edge.

    Plain PyTorch (gather, multiply, sum): ``sgl_tpu`` computes it in XLA,
    outside any Pallas kernel.
    """
    return (a.index_select(0, adj.src.long()) * b.index_select(0, adj.dst.long())).sum(-1)
