"""CSR SpMM on Hopper: the port of the TPU segment-reduce kernel.

Counterpart of ``sgl_tpu/kernels/pallas_spmm.py``.  The TPU path lays the
dst-sorted edges out in 128-row tile chunks (``prepare_chunked``), splits
each f32 message into bf16 hi/lo halves and reduces them with one-hot
matmuls on the matrix unit (``_make_seg_kernel``), with self-loops and hub
sources split out of the gather.  All of that exists for the TPU's matrix
unit and its gather cost.  On the GPU the same sum is one kernel over a
plain dst-CSR (``csrc/spmm_csr.cu``): the gather, the ×w and the f32 sum
happen inside it.

* :func:`prepare_csr` — the counterpart of ``prepare_chunked``: sort by dst
  (stable), drop ``w == 0`` (graph padding vanishes), build ``rowptr``.
* :func:`spmm_csr` — the wrapper: launches the kernel on a CUDA tensor,
  runs :func:`spmm_csr_reference` on a CPU tensor, raises on anything else.
  ``spmm_csr.launches["f32" | "bf16"]`` counts kernel launches.
* :func:`spmm_csr_reference` — the plain PyTorch twin (gather, ×w, a
  scatter-add into f32 in edge order, cast); the CPU path and the
  yardstick the kernel is held against.

No gradient: propagation is training-free and runs under ``no_grad``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from sgl_tpu_torch.kernels.sparse import SparseAdj, spmm_segment

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
    rows = torch.repeat_interleave(
        torch.arange(adj.num_nodes, dtype=torch.int32, device=adj.device),
        torch.diff(adj.rowptr.long()),
    )
    return spmm_segment(SparseAdj(adj.col, rows, adj.val, adj.num_nodes, True), x)


_KERNELS = {torch.float32: ("f32", "sgl_spmm_csr_f32"), torch.bfloat16: ("bf16", "sgl_spmm_csr_bf16")}


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures set."""
    from sgl_tpu_torch.kernels import _build

    lib = _build.load("spmm_csr")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for _, fn in _KERNELS.values():
        f = getattr(lib, fn)
        f.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, ptr]
        f.restype = ctypes.c_int
    lib.sgl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sgl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(adj: CsrAdj, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != adj.num_nodes:
        raise ValueError(f"x must be [{adj.num_nodes}, D], got {tuple(x.shape)}")
    if x.dtype not in _KERNELS:
        raise TypeError(f"spmm_csr takes float32 or bfloat16 features, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("spmm_csr needs contiguous features")
    for name, t, dtype, length in (
        ("rowptr", adj.rowptr, torch.int32, adj.num_nodes + 1),
        ("col", adj.col, torch.int32, adj.nnz),
        ("val", adj.val, torch.float32, adj.nnz),
    ):
        if t.device != x.device:
            raise ValueError(f"CsrAdj.{name} is on {t.device}, features on {x.device}")
        if t.dtype != dtype or t.dim() != 1 or t.shape[0] != length or not t.is_contiguous():
            raise ValueError(f"CsrAdj.{name} must be a contiguous {dtype} vector of {length}")


def spmm_csr(adj: CsrAdj, x: torch.Tensor) -> torch.Tensor:
    """``y = adj @ x`` with ``y`` in ``x``'s dtype (f32 or bf16).

    On a CUDA tensor this launches the CSR kernel on the current stream or
    raises; on a CPU tensor it runs :func:`spmm_csr_reference`.
    """
    if x.device.type == "cpu":
        return spmm_csr_reference(adj, x)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_csr runs on CUDA or CPU tensors, got {x.device}")
    _check(adj, x)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    key, fn_name = _KERNELS[x.dtype]
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, fn_name)(
            adj.rowptr.data_ptr(), adj.col.data_ptr(), adj.val.data_ptr(),
            x.data_ptr(), y.data_ptr(), adj.num_nodes, x.shape[1], stream,
        )
    if err != 0:
        msg = lib.sgl_cuda_error_string(err).decode()
        raise RuntimeError(f"spmm_csr {key} kernel launch failed: {msg} (cudaError {err})")
    spmm_csr.launches[key] += 1
    return y


spmm_csr.launches = {"f32": 0, "bf16": 0}
