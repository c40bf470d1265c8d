"""Segment sum of precomputed, dst-ordered message rows on Hopper: the port
of the Pallas kernels of the ``dev/`` harnesses D2–D6.

Those five TPU kernels are one function: a dst-ordered segment sum of
message rows that XLA gathered (and sometimes weighted) outside the kernel,
done as one-hot matmuls over 128-row output tiles.  They differ only in the
message type, whether a row holds two halves ``[hi | lo]``, the per-edge
weight and whether the sum is added into an existing buffer.  Here they are
one CUDA kernel body (``csrc/segment_reduce.cu``) over a plain row pointer.

The kernel balances bytes, not rows: the call's messages are cut into
tiles of :data:`TILE_MESSAGES` consecutive messages, one block each, and a
row that crosses a tile edge is summed piece by piece, each piece into an
f32 workspace, whose pieces a second launch (the fix-up) adds in tile
order.  The twin sums in the same order.

* :func:`segment_reduce` — the wrapper: launches the kernel on a CUDA
  tensor, runs :func:`segment_reduce_reference` on a CPU tensor, raises on
  anything else;
* :func:`segment_reduce_reference` — the plain PyTorch twin: each message
  formed in f32, each row's piece of each tile summed in edge order, the
  pieces of a cut row added in tile order;
* :func:`tiling` — how a call is cut: tiles, cut rows, workspace bytes and
  the copy path the kernel takes;
* :func:`dst_order` — a stable order and a row pointer for messages whose
  ``dst`` is not sorted (D2's probe hands its chunk's edges in any order).

``segment_reduce.launches`` counts kernel launches by instantiation
(:data:`INSTANTIATIONS`), ``segment_reduce.fixup_launches`` the fix-up's,
launched whenever a call has more than one tile; both once per column
window of :data:`COLUMN_WINDOW`, a launch each.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from sgl_tpu_torch.kernels import _build
from sgl_tpu_torch.kernels.sparse import add_rows_

#: Consecutive messages one block sums: the ``kTileMessages`` of
#: ``csrc/segment_reduce.cu``, by which the kernel cuts too.  Timed on the
#: H100 against 256, 1024 and 2048 with
#: ``python -m sgl_tpu_torch.dev.tune_segment_reduce`` (``PERF.md``).
TILE_MESSAGES = 512
#: Output columns one launch sums (``kWindowCols``): a wider call launches
#: pass 1 and the fix-up once per window, and each window's stages hold
#: only its columns of the message rows.
COLUMN_WINDOW = 1024

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


def messages_f32(m: torch.Tensor, halves: int, wh, wl) -> torch.Tensor:
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


def _cut_rows(r: torch.Tensor, tile: int):
    """``(first, last, cut)`` for the int64 row pointer ``r`` and tiles of
    ``tile`` messages: each row's first and last tile, and whether the row
    crosses a tile edge (a cut row, summed piece by piece)."""
    first, last = r[:-1] // tile, (r[1:] - 1) // tile
    return first, last, (r[1:] > r[:-1]) & (first != last)


def _tile_slots(rowptr: torch.Tensor, num_messages: int, tile: int):
    """Where each message is summed when the messages are cut into tiles of
    ``tile``: ``(slot, owner)``.  A row that lies in one tile is its own
    slot; a row that crosses a tile edge (a cut row) has one slot per tile
    it touches, ``num_rows + j`` for its pieces in (row, tile) order, and
    ``owner[j]`` is the row of piece ``j``."""
    r = rowptr.long()
    n = r.shape[0] - 1
    rows = torch.repeat_interleave(torch.arange(n, device=r.device), torch.diff(r), output_size=num_messages)
    first, last, cut = _cut_rows(r, tile)
    cut_rows = torch.nonzero(cut).flatten()
    counts = (last - first + 1)[cut_rows]
    piece_ptr = torch.cumsum(counts, 0) - counts
    slot = rows.clone()
    idx = torch.nonzero(cut[rows]).flatten()  # the messages of cut rows
    k = (torch.cumsum(cut.long(), 0) - 1)[rows[idx]]  # their row's rank among the cut rows
    slot[idx] = n + piece_ptr[k] + idx // tile - first[rows[idx]]
    owner = torch.repeat_interleave(cut_rows, counts, output_size=int(counts.sum()))
    return slot, owner


def segment_reduce_reference(
    rowptr: torch.Tensor,
    m: torch.Tensor,
    *,
    halves: int = 1,
    wh: Optional[torch.Tensor] = None,
    wl: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
    row_offset: int = 0,
    tile: int = TILE_MESSAGES,
) -> torch.Tensor:
    """Plain PyTorch twin of :func:`segment_reduce`, in the kernel's order:
    the messages in f32; each row's piece of each tile of ``tile``
    consecutive messages summed in edge order (a row within one tile is one
    piece); the pieces of a row cut by a tile edge added in tile order;
    then, with ``out``, one add into the rows of ``out``'s window that have
    messages, in place.  The kernel cuts at :data:`TILE_MESSAGES`; another
    ``tile`` lets small inputs cross tile edges."""
    n, e = rowptr.shape[0] - 1, int(rowptr[-1])  # the message rows rowptr names
    msgs = messages_f32(m[:e], halves, None if wh is None else wh[:e], None if wl is None else wl[:e])
    slot, owner = _tile_slots(rowptr, e, tile)
    sums = torch.zeros((n + owner.shape[0], msgs.shape[1]), dtype=torch.float32, device=m.device)
    add_rows_(sums, slot, msgs)
    y = add_rows_(sums[:n], owner, sums[n:])
    if out is None:
        return y
    touched = torch.diff(rowptr) > 0
    window = out.narrow(0, row_offset, n)
    window[touched] += y[touched]
    return out


def tiling(rowptr: torch.Tensor, m: torch.Tensor, halves: int = 1, tile: int = TILE_MESSAGES) -> dict:
    """How the kernel cuts one call: ``tiles`` (blocks of ``tile``
    messages), ``cut_rows`` (rows that cross a tile edge and go through the
    fix-up), ``workspace_bytes`` (the f32 pieces, two rows a tile, and
    the row each tile's fix-up adds), ``windows`` (column windows, a
    launch each) and ``path``, the copy the kernel streams messages with:
    ``"windows"`` (``cp.async`` of each row's window) past one column
    window, else ``"bulk"`` (1-D bulk copies) where a message row is a
    multiple of 16 bytes and ``m`` is 16-byte aligned, else
    ``"cp.async"``.  Reads ``rowptr`` on its device."""
    e, d = int(rowptr[-1]), m.shape[1] // halves
    tiles = -(-e // tile)
    cut = _cut_rows(rowptr.long(), tile)[2]
    row_bytes = m.shape[1] * m.element_size()
    return dict(
        tiles=tiles, cut_rows=int(cut.sum()),
        workspace_bytes=4 * tiles * (2 * d + 1) if tiles > 1 else 0, windows=-(-d // COLUMN_WINDOW),
        path="windows" if d > COLUMN_WINDOW
        else "bulk" if row_bytes % 16 == 0 and m.data_ptr() % 16 == 0 else "cp.async",
    )


def named_messages(rowptr: torch.Tensor, m: torch.Tensor) -> int:
    """``rowptr[-1]``, the message rows ``rowptr`` names, checked against
    ``m``'s: the one entry of ``rowptr`` checked, one scalar read that
    waits for the card."""
    named = int(rowptr[-1])
    if named > m.shape[0]:
        raise ValueError(f"rowptr names {named} message rows, m holds {m.shape[0]}")
    return named


def _check(rowptr, m, halves, wh, wl, out, row_offset) -> str:
    """Check the arguments of :func:`segment_reduce` but the entries of
    ``rowptr`` (:func:`named_messages`); return the instantiation's key."""
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
    return _build.load_entries("segment_reduce", signatures())


def signatures() -> dict:
    """The C argument types of each entry point of ``segment_reduce.cu``."""
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    args = [ptr] * 6 + [i64] * 4 + [ptr]  # rowptr m wh wl out work, row_offset n d e, stream
    return {f"sgl_segment_reduce_{key}": args for key in INSTANTIATIONS}


def run_kernel(lib: ctypes.CDLL, key: str, rowptr, m, wh, wl, out, row_offset: int,
               num_messages: Optional[int] = None, tile: int = TILE_MESSAGES) -> Tuple[int, int]:
    """Instantiation ``key`` of ``lib`` (built with ``kTileMessages`` =
    ``tile``) on ``m``'s device's current stream into ``out``, with a
    workspace of its own; raise on a refused launch.  ``num_messages`` is
    ``rowptr[-1]``; where it is not given, :func:`named_messages` reads it
    after every other host step, just before the launch, since the read
    waits for the card.  Returns the launches of pass 1 and of the fix-up:
    one a column window each, none for an accumulating call with no
    messages, and no fix-up within one tile.  Checks nothing else and
    counts nothing: the wrapper does."""
    n, d = rowptr.shape[0] - 1, out.shape[1]
    # sized for the rows m holds, of which rowptr names a prefix
    tiles = -(-(m.shape[0] if num_messages is None else num_messages) // tile)
    # the pieces of cut rows, two f32 rows a tile, then one int32 a tile
    work = torch.empty(tiles * (2 * d + 1), dtype=torch.float32, device=m.device) if tiles > 1 else None
    fn = f"sgl_segment_reduce_{key}"
    args = (rowptr.data_ptr(), m.data_ptr(), None if wh is None else wh.data_ptr(),
            None if wl is None else wl.data_ptr(), out.data_ptr(), None if work is None else work.data_ptr(),
            row_offset, n, d)
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream().cuda_stream
        e = named_messages(rowptr, m) if num_messages is None else num_messages
        if e == 0 and INSTANTIATIONS[key][3]:
            return 0, 0
        err = getattr(lib, fn)(*args, e, stream)
    _build.raise_on_error(lib, fn, err)
    windows = -(-d // COLUMN_WINDOW)
    return windows, windows if e > tile else 0


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

    On a CUDA tensor this launches the kernel (and, past one tile of
    :data:`TILE_MESSAGES` messages, its fix-up) on the current stream,
    once per column window of :data:`COLUMN_WINDOW`, or raises.  On a CPU
    tensor it runs :func:`segment_reduce_reference`.
    ``rowptr`` must be non-decreasing from 0 to at most ``E``.  Its last
    entry is checked against ``E`` (one scalar read, which waits for the
    card, made last before the launch); the others are not, and the kernel
    reads the rows they name.
    """
    key = _check(rowptr, m, halves, wh, wl, out, row_offset)
    if m.device.type == "cpu":
        named_messages(rowptr, m)
        return segment_reduce_reference(rowptr, m, halves=halves, wh=wh, wl=wl, out=out, row_offset=row_offset)
    if m.device.type != "cuda":
        raise ValueError(f"segment_reduce runs on CUDA or CPU tensors, got {m.device}")
    n, d = rowptr.shape[0] - 1, m.shape[1] // halves
    y = torch.empty((n, d), dtype=torch.float32, device=m.device) if out is None else out
    if n == 0 or d == 0:  # nothing to write
        named_messages(rowptr, m)
        return y
    launched, fixups = run_kernel(_library(), key, rowptr, m, wh, wl, y, row_offset)
    segment_reduce.launches[key] += launched
    segment_reduce.fixup_launches[key] += fixups
    return y


segment_reduce.launches = {key: 0 for key in INSTANTIATIONS}
segment_reduce.fixup_launches = {key: 0 for key in INSTANTIATIONS}
