"""CSR SpMM on Hopper: the port of the TPU segment-reduce kernels.

Counterpart of ``sgl_tpu/kernels/pallas_spmm.py``.  The TPU path lays the
dst-sorted edges out in 128-row tile chunks (``prepare_chunked``), splits
each f32 message into bf16 hi/lo halves and reduces them with one-hot
matmuls on the matrix unit (``_make_seg_kernel``), with self-loops and hub
sources split out of the gather.  All of that exists for the TPU's matrix
unit and its gather cost.  On the GPU the same sum is one kernel over a
plain dst-CSR (``csrc/spmm_csr.cu``): the gather, the ×w and the f32 sum
happen inside it.

One-shot product (``_segment_reduce_mxu``, TPU kernels K1/K2):

* :func:`prepare_csr` — the counterpart of ``prepare_chunked``: sort by dst
  (stable), drop ``w == 0`` (graph padding vanishes), build ``rowptr``.
* :func:`spmm_csr` — the wrapper: launches the kernel on a CUDA tensor,
  runs :func:`spmm_csr_reference` on a CPU tensor, raises on anything else.
* :func:`spmm_csr_reference` — the plain PyTorch twin (gather, ×w, a
  scatter-add into f32 in edge order, cast); the CPU path and the
  yardstick the kernel is held against.

Streaming product, part by part (``prepare_chunked_parts`` /
``spmm_pallas_streaming`` / ``_segment_reduce_mxu_acc``, TPU kernels
K3/K4).  The TPU path splits the graph because its E×D messages would not
fit at once; the CSR kernel gathers inside and never forms them, so here
the parts buy no memory and exist to carry K3/K4 over:

* :func:`prepare_csr_parts` — split a CSR into parts of balanced nonzero
  counts (:class:`CsrParts`);
* :func:`spmm_csr_acc` / :func:`spmm_csr_acc_reference` — add one part's
  product into an f32 accumulator, in place;
* :func:`spmm_csr_streaming` / :func:`spmm_csr_streaming_reference` — the
  whole product, part by part.

``spmm_csr.launches`` counts kernel launches by instantiation: ``"f32"``,
``"bf16"``, ``"acc_f32"``, ``"acc_bf16"``.  No gradient: propagation is
training-free and runs under ``no_grad``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from sgl_tpu_torch.kernels.sparse import SparseAdj, segment_sum_f32, spmm_segment

_INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class CsrAdj:
    """Destination-row CSR: row ``r`` holds the edges into node ``r``.

    ``rowptr`` int32 ``[N+1]``; ``col`` int32 ``[nnz]`` (the edge's source);
    ``val`` f32 ``[nnz]`` (normalized weight, never 0).
    """

    rowptr: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    num_nodes: int

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    @property
    def device(self) -> torch.device:
        return self.col.device


def prepare_csr(adj: SparseAdj) -> CsrAdj:
    """Dst-CSR of ``adj`` on ``adj``'s device; build once per graph."""
    src, dst, w = adj.src, adj.dst, adj.w
    if not adj.sorted_by_dst:
        order = torch.argsort(dst, stable=True)
        src, dst, w = src[order], dst[order], w[order]
    keep = w != 0
    src, dst, w = src[keep], dst[keep], w[keep]
    nnz = int(src.shape[0])
    if nnz > _INT32_MAX:
        raise ValueError(f"{nnz} edges overflow the int32 row pointers of the CSR kernel")
    n = adj.num_nodes
    counts = torch.bincount(dst.long(), minlength=n)
    rowptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return CsrAdj(
        rowptr.to(torch.int32),
        src.to(torch.int32).contiguous(),
        w.to(torch.float32).contiguous(),
        n,
    )


def spmm_csr_reference(adj: CsrAdj, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``adj @ x``: gather, ×w, scatter-add in f32, cast."""
    return spmm_segment(_coo(adj.rowptr, adj.col, adj.val, adj.num_nodes), x)


def _coo(rowptr: torch.Tensor, col: torch.Tensor, val: torch.Tensor, num_rows: int) -> SparseAdj:
    rows = torch.repeat_interleave(
        torch.arange(num_rows, dtype=torch.int32, device=col.device), torch.diff(rowptr.long())
    )
    return SparseAdj(col, rows, val, num_rows, True)


# kernel instantiation -> (C entry point, number of int64 arguments)
_ENTRY = {
    "f32": ("sgl_spmm_csr_f32", 2),  # n, d
    "bf16": ("sgl_spmm_csr_bf16", 2),
    "acc_f32": ("sgl_spmm_csr_acc_f32", 3),  # row_offset, n, d
    "acc_bf16": ("sgl_spmm_csr_acc_bf16", 3),
}
_DTYPE_KEY = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures set."""
    from sgl_tpu_torch.kernels import _build

    lib = _build.load("spmm_csr")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for fn, n_ints in _ENTRY.values():
        f = getattr(lib, fn)
        f.argtypes = [ptr] * 5 + [i64] * n_ints + [ptr]
        f.restype = ctypes.c_int
    lib.sgl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sgl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(key: str, device: torch.device, *args) -> None:
    """Call the C entry point of ``key`` on ``device``'s current stream;
    raise on a refused launch, count it otherwise."""
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, _ENTRY[key][0])(*args, stream)
    if err != 0:
        msg = lib.sgl_cuda_error_string(err).decode()
        raise RuntimeError(f"spmm_csr {key} kernel launch failed: {msg} (cudaError {err})")
    spmm_csr.launches[key] += 1


def _check_features(x: torch.Tensor, num_rows=None) -> None:
    if x.dim() != 2 or (num_rows is not None and x.shape[0] != num_rows):
        rows = "N" if num_rows is None else num_rows
        raise ValueError(f"x must be [{rows}, D], got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_KEY:
        raise TypeError(f"spmm_csr takes float32 or bfloat16 features, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("spmm_csr needs contiguous features")


def _check_csr(owner: str, device: torch.device, rowptr, col, val, num_rows: int) -> None:
    nnz = int(col.shape[0])
    for name, t, dtype, length in (
        ("rowptr", rowptr, torch.int32, num_rows + 1),
        ("col", col, torch.int32, nnz),
        ("val", val, torch.float32, nnz),
    ):
        if t.device != device:
            raise ValueError(f"{owner}.{name} is on {t.device}, features on {device}")
        if t.dtype != dtype or t.dim() != 1 or t.shape[0] != length or not t.is_contiguous():
            raise ValueError(f"{owner}.{name} must be a contiguous {dtype} vector of {length}")


def spmm_csr(adj: CsrAdj, x: torch.Tensor) -> torch.Tensor:
    """``y = adj @ x`` with ``y`` in ``x``'s dtype (f32 or bf16).

    On a CUDA tensor this launches the CSR kernel on the current stream or
    raises; on a CPU tensor it runs :func:`spmm_csr_reference`.
    """
    if x.device.type == "cpu":
        return spmm_csr_reference(adj, x)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_csr runs on CUDA or CPU tensors, got {x.device}")
    _check_features(x, adj.num_nodes)
    _check_csr("CsrAdj", x.device, adj.rowptr, adj.col, adj.val, adj.num_nodes)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    _launch(
        _DTYPE_KEY[x.dtype], x.device,
        adj.rowptr.data_ptr(), adj.col.data_ptr(), adj.val.data_ptr(),
        x.data_ptr(), y.data_ptr(), adj.num_nodes, x.shape[1],
    )
    return y


spmm_csr.launches = {key: 0 for key in _ENTRY}


# -- streaming: the product part by part --------------------------------------


@dataclasses.dataclass(frozen=True)
class CsrPart:
    """The nonzeros ``[e_lo, e_hi)`` of a dst-CSR, as rows
    ``[row_offset, row_offset + num_rows)`` of the whole.

    ``rowptr`` int32 ``[num_rows+1]`` is local: the global one clamped to
    ``[e_lo, e_hi]``, minus ``e_lo``.  ``col``/``val`` are views of the
    global arrays' ``[e_lo, e_hi)`` slice, not copies.  A row cut between
    two parts lies in both, each with its share of the nonzeros.
    ``num_nodes`` is the whole graph's: the rows ``x`` must have.
    """

    rowptr: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    row_offset: int
    num_rows: int
    num_nodes: int

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])


@dataclasses.dataclass(frozen=True)
class CsrParts:
    """A dst-CSR split into consecutive parts (:func:`prepare_csr_parts`)."""

    parts: Tuple[CsrPart, ...]
    num_nodes: int

    def __len__(self) -> int:
        return len(self.parts)

    def __iter__(self):
        return iter(self.parts)

    @property
    def nnz(self) -> int:
        return sum(p.nnz for p in self.parts)


def prepare_csr_parts(adj: CsrAdj, max_edges_per_part: int = 6 << 20) -> CsrParts:
    """Split ``adj``'s nonzeros into ``ceil(nnz / max_edges_per_part)``
    contiguous ranges whose sizes differ by at most one, as
    ``prepare_chunked_parts`` balances its parts (``np.linspace(...).round()``).

    A range may start or end inside a row: that row is then cut between
    two consecutive parts, and :func:`spmm_csr_streaming` adds both shares
    into it, as the TPU path adds parts that share a tile.

    Where this departs from ``prepare_chunked_parts``, by design:

    * no padding to the largest part: the TPU pads every part for its one
      compiled kernel, and PyTorch compiles nothing per shape;
    * no self-loop or hub split: the port's CSR keeps self-loops and hub
      edges in their rows, as :func:`prepare_csr` does;
    * so the part count can differ from the TPU path's, which counts
      tile-padded chunks without the self-loop and hub edges.

    The parts hold views of ``adj.col``/``adj.val`` and a small local
    ``rowptr`` each; the split itself is computed on the host.
    """
    if max_edges_per_part < 1:
        raise ValueError(f"max_edges_per_part must be >= 1, got {max_edges_per_part}")
    nnz = adj.nnz
    n_parts = -(-nnz // max_edges_per_part)
    bounds = np.linspace(0, nnz, n_parts + 1).round().astype(np.int64)
    rowptr = adj.rowptr.cpu().numpy()
    # the row holding each part's first nonzero, and one past the row
    # holding its last
    first = np.searchsorted(rowptr, bounds[:-1], side="right") - 1
    stop = np.searchsorted(rowptr, bounds[1:], side="left")
    parts = []
    for e_lo, e_hi, r_lo, r_hi in zip(
        bounds[:-1].tolist(), bounds[1:].tolist(), first.tolist(), stop.tolist()
    ):
        local = adj.rowptr[r_lo : r_hi + 1].clamp(e_lo, e_hi) - e_lo
        parts.append(
            CsrPart(local.contiguous(), adj.col[e_lo:e_hi], adj.val[e_lo:e_hi], r_lo, r_hi - r_lo,
                    adj.num_nodes)
        )
    return CsrParts(tuple(parts), adj.num_nodes)


def spmm_csr_acc_reference(part: CsrPart, x: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of :func:`spmm_csr_acc`: the part's f32 sum
    first (:func:`spmm_segment`'s order), then one add into the rows of the
    ``acc`` window that the part touches; returns ``acc``."""
    local = segment_sum_f32(_coo(part.rowptr, part.col, part.val, part.num_rows), x)
    touched = torch.diff(part.rowptr) > 0
    window = acc.narrow(0, part.row_offset, part.num_rows)
    window[touched] += local[touched]
    return acc


def spmm_csr_acc(part: CsrPart, x: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``acc[row_offset + r] += Σ_{e in part row r} val[e] · x[col[e]]``, in
    place; returns ``acc``.  The counterpart of ``_segment_reduce_mxu_acc``.

    ``acc`` is an f32 ``[>= row_offset + num_rows, D]`` tensor for f32 and
    for bf16 ``x``.  Rows of the window whose range in the part is empty
    are not written, so they keep ``acc`` bit for bit, as the TPU kernel
    leaves the tiles it never visits.  Where JAX returns a new array
    aliased to its input, the port writes into ``acc`` itself.

    On a CUDA tensor this launches the kernel on the current stream or
    raises; parts launched in order on one stream may share a cut row.  On
    a CPU tensor it runs :func:`spmm_csr_acc_reference`.
    """
    if x.device.type == "cpu":
        return spmm_csr_acc_reference(part, x, acc)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_csr_acc runs on CUDA or CPU tensors, got {x.device}")
    _check_features(x, part.num_nodes)
    _check_csr("CsrPart", x.device, part.rowptr, part.col, part.val, part.num_rows)
    if acc.device != x.device:
        raise ValueError(f"acc is on {acc.device}, features on {x.device}")
    if acc.dtype != torch.float32:
        raise TypeError(f"spmm_csr_acc accumulates into float32, got {acc.dtype}")
    rows = part.row_offset + part.num_rows
    if acc.dim() != 2 or acc.shape[0] < rows or acc.shape[1] != x.shape[1]:
        raise ValueError(f"acc must be [>= {rows}, {x.shape[1]}], got {tuple(acc.shape)}")
    if not acc.is_contiguous():
        raise ValueError("spmm_csr_acc needs a contiguous accumulator")
    if part.num_rows == 0 or x.shape[1] == 0:
        return acc
    _launch(
        "acc_" + _DTYPE_KEY[x.dtype], x.device,
        part.rowptr.data_ptr(), part.col.data_ptr(), part.val.data_ptr(),
        x.data_ptr(), acc.data_ptr(), part.row_offset, part.num_rows, x.shape[1],
    )
    return acc


def _streaming(parts: CsrParts, x: torch.Tensor, acc_fn) -> torch.Tensor:
    if x.dim() != 2 or x.shape[0] != parts.num_nodes:
        raise ValueError(f"x must be [{parts.num_nodes}, D], got {tuple(x.shape)}")
    acc = torch.zeros((parts.num_nodes, x.shape[1]), dtype=torch.float32, device=x.device)
    for part in parts:
        acc_fn(part, x, acc)
    return acc.to(x.dtype)


def spmm_csr_streaming(parts: CsrParts, x: torch.Tensor) -> torch.Tensor:
    """``y = adj @ x`` part by part: the counterpart of
    ``spmm_pallas_streaming``.

    An f32 accumulator takes each part's product in turn
    (:func:`spmm_csr_acc`); ``y`` comes back in ``x``'s dtype.  One form
    serves every part count: the TPU path's scan for more than 24 parts
    computes the same function for compile-time reasons the port does not
    have.  bf16 features are read as bf16 (the TPU path gathers them
    upcast to f32, a choice measured on its gather).

    It needs more memory than :func:`spmm_csr`, not less: the one-shot
    kernel never forms the messages whose size made the TPU path split the
    graph, and this adds an f32 ``[N, D]`` accumulator and a cast.  It is
    also slower on skewed graphs, since the hub rows of consecutive parts
    run one after another instead of side by side.  The parts exist as the
    counterpart of K3/K4, not for memory.
    """
    return _streaming(parts, x, spmm_csr_acc)


def spmm_csr_streaming_reference(parts: CsrParts, x: torch.Tensor) -> torch.Tensor:
    """The plain twin of :func:`spmm_csr_streaming`, part by part, so its
    memory is one part's messages."""
    return _streaming(parts, x, spmm_csr_acc_reference)
