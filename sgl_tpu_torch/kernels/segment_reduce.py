"""Segment sum of precomputed, dst-ordered message rows on Hopper: the port
of the Pallas kernels of the ``dev/`` harnesses D2–D6.

Those five TPU kernels are one function: a dst-ordered segment sum of
message rows that XLA gathered (and sometimes weighted) outside the kernel,
done as one-hot matmuls over 128-row output tiles.  They differ only in the
message type, whether a row holds two halves ``[hi | lo]``, the per-edge
weight and whether the sum is added into an existing buffer.  Here they are
one CUDA kernel body (``csrc/segment_reduce.cu``) over a plain row pointer:

* :func:`segment_reduce` — the wrapper: launches the kernel on a CUDA
  tensor, runs :func:`segment_reduce_reference` on a CPU tensor, raises on
  anything else;
* :func:`segment_reduce_reference` — the plain PyTorch twin: each message
  formed in f32, then a scatter-add into f32 in edge order (as
  ``spmm_segment`` sums);
* :func:`dst_order` — a stable order and a row pointer for messages whose
  ``dst`` is not sorted (D2's probe hands its chunk's edges in any order).

``segment_reduce.launches`` counts kernel launches by instantiation
(:data:`INSTANTIATIONS`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from sgl_tpu_torch.kernels import _build

#: instantiation -> (message dtype, halves, weights, accumulate, TPU kernel)
#: weights: 0 none, 1 ``wh``, 2 the pair ``wh``, ``wl``
INSTANTIATIONS = {
    "bf16_acc": (torch.bfloat16, 1, 0, True, "D2 dev/exp_acc_alias.py:56"),
    "bf16_hilo": (torch.bfloat16, 2, 0, False, "D3 dev/exp_spmm.py:100"),
    "f32": (torch.float32, 1, 0, False, "D4 dev/exp_spmm.py:175, D6 A' :662"),
    "bf16_hilo_w2": (torch.bfloat16, 2, 2, False, "D5 dev/exp_spmm.py:396"),
    "f32_w2": (torch.float32, 1, 2, False, "D6 A dev/exp_spmm.py:662"),
    "bf16_w": (torch.bfloat16, 1, 1, False, "D6 B dev/exp_spmm.py:662"),
}
_KEY = {spec[:4]: key for key, spec in INSTANTIATIONS.items()}


def dst_order(dst: torch.Tensor, num_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order, rowptr)`` for messages with destination rows ``dst``: the
    stable order that sorts ``dst`` (int64, to index the messages with) and
    the int32 ``[num_rows + 1]`` row pointer of the sorted messages."""
    dst = dst.long()
    if dst.numel() and (int(dst.min()) < 0 or int(dst.max()) >= num_rows):
        raise ValueError(f"dst must lie in [0, {num_rows})")
    order = torch.argsort(dst, stable=True)
    counts = torch.bincount(dst, minlength=num_rows)
    rowptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return order, rowptr.to(torch.int32)


def _messages_f32(m: torch.Tensor, halves: int, wh, wl) -> torch.Tensor:
    """Each edge's message in f32, the terms of ``segment_reduce.cu``'s
    ``message`` in its order."""
    d = m.shape[1] // halves
    a = m[:, :d].float()
    b = m[:, d:].float() if halves == 2 else None
    h = None if wh is None else wh.float()[:, None]
    l = None if wl is None else wl.float()[:, None]
    if h is None:
        return a if b is None else a + b
    if l is None:
        return h * a if b is None else h * a + h * b
    return (h + l) * a if b is None else h * a + h * b + l * a


def segment_reduce_reference(
    rowptr: torch.Tensor,
    m: torch.Tensor,
    *,
    halves: int = 1,
    wh: Optional[torch.Tensor] = None,
    wl: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
    row_offset: int = 0,
) -> torch.Tensor:
    """Plain PyTorch twin of :func:`segment_reduce`: the messages in f32,
    summed per row in edge order into f32; then, with ``out``, one add into
    the rows of ``out``'s window that have messages, in place."""
    n, e = rowptr.shape[0] - 1, int(rowptr[-1])  # the message rows rowptr names
    msgs = _messages_f32(m[:e], halves, None if wh is None else wh[:e], None if wl is None else wl[:e])
    rows = torch.repeat_interleave(torch.arange(n, device=m.device), torch.diff(rowptr.long()))
    y = torch.zeros((n, msgs.shape[1]), dtype=torch.float32, device=m.device)
    if y.is_cuda:
        # index_add_ on CUDA adds with atomics in an order that changes from
        # run to run; index_put_(accumulate=True) adds in edge order
        y.index_put_((rows,), msgs, accumulate=True)
    else:
        y.index_add_(0, rows, msgs)
    if out is None:
        return y
    touched = torch.diff(rowptr) > 0
    window = out.narrow(0, row_offset, n)
    window[touched] += y[touched]
    return out


def _check(rowptr, m, halves, wh, wl, out, row_offset) -> str:
    """Check the arguments of :func:`segment_reduce`; return the
    instantiation's key."""
    device = m.device
    if m.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"segment_reduce takes float32 or bfloat16 messages, got {m.dtype}")
    if halves not in (1, 2):
        raise ValueError(f"halves must be 1 or 2, got {halves}")
    if m.dim() != 2 or m.shape[1] % halves:
        raise ValueError(f"m must be [E, {halves}*D], got {tuple(m.shape)}")
    if not m.is_contiguous():
        raise ValueError("segment_reduce needs contiguous messages")
    if rowptr.device != device:
        raise ValueError(f"rowptr is on {rowptr.device}, messages on {device}")
    if rowptr.dtype != torch.int32:
        raise TypeError(f"rowptr must be int32, got {rowptr.dtype}")
    if rowptr.dim() != 1 or rowptr.shape[0] < 1 or not rowptr.is_contiguous():
        raise ValueError(f"rowptr must be a contiguous [N+1] vector, got {tuple(rowptr.shape)}")
    e = m.shape[0]
    if int(rowptr[-1]) > e:  # the one entry checked: one scalar read from the card
        raise ValueError(f"rowptr names {int(rowptr[-1])} message rows, m holds {e}")
    if wl is not None and wh is None:
        raise ValueError("wl needs wh: the weight pair is (wh, wl)")
    for name, w in (("wh", wh), ("wl", wl)):
        if w is None:
            continue
        if w.device != device:
            raise ValueError(f"{name} is on {w.device}, messages on {device}")
        if w.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {w.dtype}")
        if w.dim() != 1 or w.shape[0] != e or not w.is_contiguous():
            raise ValueError(f"{name} must be a contiguous vector of {e}, got {tuple(w.shape)}")
    if out is not None:
        n, d = rowptr.shape[0] - 1, m.shape[1] // halves
        if out.device != device:
            raise ValueError(f"out is on {out.device}, messages on {device}")
        if out.dtype != torch.float32:
            raise TypeError(f"segment_reduce accumulates into float32, got {out.dtype}")
        if row_offset < 0:
            raise ValueError(f"row_offset must be >= 0, got {row_offset}")
        if out.dim() != 2 or out.shape[0] < row_offset + n or out.shape[1] != d:
            raise ValueError(f"out must be [>= {row_offset + n}, {d}], got {tuple(out.shape)}")
        if not out.is_contiguous():
            raise ValueError("segment_reduce needs a contiguous out")
    elif row_offset:
        raise ValueError("row_offset needs out")
    form = (m.dtype, halves, (wh is not None) + (wl is not None), out is not None)
    if form not in _KEY:
        raise ValueError(
            f"segment_reduce has no kernel for {form[0]} messages, halves={halves}, {form[2]} "
            f"weight arrays, accumulate={form[3]} (the forms are INSTANTIATIONS)"
        )
    return _KEY[form]


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures set."""
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    args = [ptr] * 5 + [i64] * 3 + [ptr]  # rowptr m wh wl out, row_offset n d, stream
    return _build.load_entries(
        "segment_reduce", {f"sgl_segment_reduce_{key}": args for key in INSTANTIATIONS}
    )


def segment_reduce(
    rowptr: torch.Tensor,
    m: torch.Tensor,
    *,
    halves: int = 1,
    wh: Optional[torch.Tensor] = None,
    wl: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
    row_offset: int = 0,
) -> torch.Tensor:
    """``y[r] = Σ_{e in rowptr[r]..rowptr[r+1]} msg(e)`` over message rows
    already in destination order, summed in f32.

    ``rowptr`` int32 ``[N+1]``; ``m`` f32 or bf16 ``[E, halves·D]`` (with
    ``halves=2`` a row is ``[hi | lo]``); ``wh``/``wl`` bf16 ``[E]``.
    ``msg(e)`` is ``a``, ``a + b``, ``wh·a``, ``wh·a + wh·b + wl·a`` or
    ``(wh + wl)·a`` for the row's halves ``a`` (and ``b``), in f32; only
    the forms in :data:`INSTANTIATIONS` exist.

    Without ``out`` it returns a new f32 ``[N, D]``, empty rows zero.  With
    ``out`` (f32 ``[>= row_offset + N, D]``) it adds row ``r``'s sum into
    ``out[row_offset + r]`` in place and returns ``out``; a row with no
    messages is not written, so it keeps ``out`` bit for bit.  Where the
    TPU kernel returns a new array aliased to its input, the port writes
    into ``out`` itself.

    On a CUDA tensor this launches the kernel on the current stream or
    raises; on a CPU tensor it runs :func:`segment_reduce_reference`.
    ``rowptr`` must be non-decreasing from 0 to at most ``E``.  Its last
    entry is checked against ``E`` (one scalar read, which waits for the
    card); the others are not, and the kernel reads the rows they name.
    """
    key = _check(rowptr, m, halves, wh, wl, out, row_offset)
    kw = dict(halves=halves, wh=wh, wl=wl, out=out, row_offset=row_offset)
    if m.device.type == "cpu":
        return segment_reduce_reference(rowptr, m, **kw)
    if m.device.type != "cuda":
        raise ValueError(f"segment_reduce runs on CUDA or CPU tensors, got {m.device}")
    n, d = rowptr.shape[0] - 1, m.shape[1] // halves
    y = torch.empty((n, d), dtype=torch.float32, device=m.device) if out is None else out
    if n == 0 or d == 0:
        return y
    _build.call(
        _library(), f"sgl_segment_reduce_{key}", m.device,
        rowptr.data_ptr(), m.data_ptr(),
        None if wh is None else wh.data_ptr(), None if wl is None else wl.data_ptr(),
        y.data_ptr(), row_offset, n, d,
    )
    segment_reduce.launches[key] += 1
    return y


segment_reduce.launches = {key: 0 for key in INSTANTIATIONS}
