"""Out-of-core SpMM: features, hops and edges on the host, streamed through the card.

Counterpart of ``sgl_tpu/kernels/spmm_ooc.py``.  At papers100M scale
(111M nodes x 128 f32 = 57 GB of features, 1.8B edges) neither ``x``,
``y`` nor the edge list fits the card's 80 GB, so all three stay in host
memory and move through the card part by part.  The product of a part is
the port's accumulating CSR kernel (``spmm_csr_acc``, K3 for f32 and K4
for bf16 features), which replaces the TPU path's gather + hi/lo +
``_segment_reduce_mxu`` steps at all four of its call sites: ``_ooc_step``,
``_ooc_step_2d``, ``_ooc_cell_2d`` and ``_resident_class_scan``.

Two layouts, each built once on the host:

* 1-D (:func:`prepare_out_of_core`, :func:`spmm_out_of_core`): contiguous
  nonzero ranges of the dst-sorted CSR, balanced as ``prepare_csr_parts``
  balances them.  A part's ``cols`` are the unique sources it reads (its
  workspace); its columns are remapped to workspace positions, so it is a
  ``CsrPart`` whose ``num_nodes`` is the workspace size.  Per part the host
  gathers ``x[cols]`` into pinned memory.  On power-law graphs hub sources
  reach every part, so the workspaces add up to many feature volumes a hop.
* 2-D (:func:`prepare_out_of_core_2d`, :func:`spmm_out_of_core_2d`): dst
  parts on row boundaries times contiguous source blocks.  A cell is a CSR
  over its part's rows with block-relative columns; the workspace of block
  ``b`` is the slice ``x[b*sb:(b+1)*sb]``, copied once per accumulator group:
  one feature volume a hop when every part's accumulator fits on the card.
  :func:`spmm_2d_resident` runs the same cells with ``x`` on the card.

The copies: host-to-device on a stream of its own, device-to-host on
another, the kernels on the caller's current stream.  Features are staged
through two pinned slots used in turn (:class:`PinnedRing`); a slot is
rewritten only after the copy that used it completed (its event), and a
device workspace only after the kernels that read it (theirs).  Part
``i+1``'s host gather, copy and kernel are issued before part ``i``'s
readback is waited on.  On the CPU there are no streams and nothing is
pinned: the staging buffers are plain arrays and the "copies" are the
arrays themselves.

Where the port departs from ``sgl_tpu``, by design: no chunk-tile padding,
no part padding to one compiled shape and no ``interpret`` flag (PyTorch
compiles nothing per shape); no ``tile_mask`` select or ``step_mode`` split
(``spmm_csr_acc`` leaves the rows it does not touch bit for bit, and there
is no XLA fusion to protect); no ``chunk``/``tile_rows`` or their model
pick (a CSR has no tiles: parts end on row boundaries); no gather-cliff
budget (a v5e measurement): ``src_blocks="auto"`` sizes blocks by
:data:`SRC_BLOCK_BYTES`.  The layout cache is the port's own format.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import shutil
import time
import warnings
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.graph import native
from sgl_tpu_torch.kernels.sparse import SparseAdj
from sgl_tpu_torch.kernels.spmm_csr import (
    SPLIT_NNZ,
    CsrPart,
    SplitPlan,
    _make_plan,
    prepare_csr,
    prepare_csr_parts,
    spmm_csr_acc,
)

logger = logging.getLogger(__name__)

#: Host rows per step of the host-applied self-loop term (bounds its temporaries).
_DIAG_WINDOW = 1 << 20

#: ``src_blocks="auto"`` cuts ``x`` into blocks of at most this many bytes.
#: Blocks are the unit of the copy pipeline: block ``b+1`` crosses PCIe
#: while the cells of block ``b`` run, so the transfer a hop is not shorter
#: than one block's copy plus the rest overlapped; 256 MiB crosses in ~10 ms
#: at ~25 GB/s, and two of them (the double-buffered device workspaces) sit
#: beside the accumulators and the edge cache at any feature size on the
#: H100's 80 GB.  At products scale (2.4M x 100 f32) that is 4 blocks.
SRC_BLOCK_BYTES = 256 << 20

#: The densest cell's device arrays (edges, row pointer, plan and its fix-up
#: workspace at the feature width) may not exceed this: a cell past the
#: default device edge cache (4 GiB) could never stay on the card.
#: Module-level, so tests can lower it.
_CELL_BYTE_BUDGET = 4 << 30

_CACHE_PREFIX = "sglt_ooc2d_"


# -- host arrays ----------------------------------------------------------------


def host_bits(x, dtype: Optional[torch.dtype] = None) -> Tuple[np.ndarray, torch.dtype]:
    """``x``'s rows as a C-contiguous numpy array of their raw bits, and
    their torch dtype.

    ``x`` is a numpy float32 array (or memmap), a CPU tensor of float32 or
    bfloat16, or, with ``dtype=torch.bfloat16``, a numpy array of bf16 bits
    (int16 or uint16).  Numpy has no bf16 here, so bf16 rows travel as
    int16 bits; nothing is copied, and a read-only memmap stays one.
    """
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"host features must be a CPU tensor, got {x.device}")
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"host features must be float32 or bfloat16, got {x.dtype}")
        x = x.contiguous()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy(), x.dtype
    a = np.ascontiguousarray(x)
    if dtype == torch.bfloat16:
        if a.dtype not in (np.int16, np.uint16):
            raise TypeError(f"bf16 host rows travel as int16 or uint16 bits, got {a.dtype}")
        return a.view(np.int16), torch.bfloat16
    if a.dtype != np.float32:
        raise TypeError(f"host features must be float32 numpy or a CPU tensor, got {a.dtype}")
    return a, torch.float32


def _bits_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.int16 if dtype == torch.bfloat16 else torch.float32


def _as_tensor(bits: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A CPU tensor of ``dtype`` over ``bits`` (which must be writable)."""
    return torch.from_numpy(bits).view(dtype)


def _new_out(x_host, n: int, d: int, dtype: torch.dtype, out, zero: bool) -> Tuple[object, torch.Tensor]:
    """The output in ``x_host``'s type and dtype (numpy f32 or a CPU
    tensor), zeroed when ``zero``, and a tensor view of it."""
    if out is None:
        out = (torch.empty((n, d), dtype=dtype) if isinstance(x_host, torch.Tensor)
               else np.empty((n, d), np.float32))
    out_t = out if isinstance(out, torch.Tensor) else torch.from_numpy(out)
    if tuple(out_t.shape) != (n, d) or out_t.dtype != dtype or not out_t.is_contiguous():
        raise ValueError(f"out must be a contiguous [{n}, {d}] {dtype} array, got "
                         f"{tuple(out_t.shape)} {out_t.dtype}")
    if zero:
        out_t.zero_()
    return out, out_t


def _host_edges(adj):
    """``(src, dst, w, n, sorted_by_dst)`` as host numpy arrays (int32,
    int32, float32), the ``w == 0`` padding dropped."""
    if isinstance(adj, SparseAdj):
        src, dst, w, n, srt = adj.src, adj.dst, adj.w, adj.num_nodes, adj.sorted_by_dst
        src, dst, w = (t.cpu().numpy() for t in (src, dst, w))
    else:
        src, dst, w, n = adj
        srt = False
    if n >= 2**31:
        raise ValueError("node ids must fit int32")
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    w = np.asarray(w, np.float32)
    keep = w != 0
    if not keep.all():
        src, dst, w = src[keep], dst[keep], w[keep]
    srt = srt or bool(dst.size == 0 or np.all(dst[1:] >= dst[:-1]))
    return src, dst, w, int(n), srt


def _split_diag(src, dst, w, n: int):
    """Take the self-loops out of the edges: ``(src, dst, w, diag)``, with
    ``diag`` the f32 sum of each node's loop weights (None without loops).
    The order of the other edges is kept."""
    loop = src == dst
    if not loop.any():
        return src, dst, w, None
    diag = np.zeros(n, np.float32)
    np.add.at(diag, dst[loop], w[loop])
    keep = ~loop
    return src[keep], dst[keep], w[keep], diag


def _unique_inverse(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``np.unique(a, return_inverse=True)`` by a sort and a neighbour
    compare: numpy 2.3's ``np.unique`` hashes integer keys first, ~70x
    slower than a sort at 10M keys (``PERF.md``)."""
    s = np.sort(a)
    first = np.ones(s.shape[0], bool)
    first[1:] = s[1:] != s[:-1]
    u = s[first]
    return u, np.searchsorted(u, a).astype(np.int32)


# -- the packed CSR of a part or cell -------------------------------------------

_HEADER = 5  # num_rows, nnz, segments, long rows, listed rows


@dataclasses.dataclass(frozen=True)
class OocSubPart:
    """One CSR with its split plan, packed into one int32 array for one copy
    to the card: a (dst-part, src-block) cell of the 2-D layout, and the CSR
    of a 1-D part.

    ``packed`` holds the header ``[num_rows, nnz, segments, long rows,
    listed rows]``, then ``rowptr`` (``num_rows + 1``, local), ``col``,
    ``val``'s float32 bits, and the plan's ``seg_beg``, ``seg_end``,
    ``seg_ptr``, ``long_rows`` and ``rows`` (the rows neither empty nor
    long).  It may be a read-only memmap (a cached layout).
    """

    packed: np.ndarray

    @property
    def counts(self) -> Tuple[int, int, int, int, int]:
        return tuple(int(v) for v in self.packed[:_HEADER])

    @property
    def num_rows(self) -> int:
        return int(self.packed[0])

    @property
    def nnz(self) -> int:
        return int(self.packed[1])

    @property
    def nbytes(self) -> int:
        return int(self.packed.nbytes)


def _pack(rowptr: np.ndarray, col: np.ndarray, val: np.ndarray, plan: Optional[SplitPlan] = None) -> OocSubPart:
    rowptr = np.ascontiguousarray(rowptr, np.int32)
    if plan is None:
        plan = _make_plan(torch.from_numpy(rowptr))
    arrays = [plan.seg_beg, plan.seg_end, plan.seg_ptr, plan.long_rows, plan.rows]
    seg_beg, seg_end, seg_ptr, long_rows, listed = (np.asarray(t.numpy(), np.int32) for t in arrays)
    header = np.array([rowptr.shape[0] - 1, col.shape[0], seg_beg.shape[0], long_rows.shape[0],
                       listed.shape[0]], np.int64)
    if header.max() >= 2**31:
        raise ValueError(f"a part of {header[1]} nonzeros overflows the kernel's int32 indices")
    return OocSubPart(np.concatenate([
        header.astype(np.int32), rowptr, np.asarray(col, np.int32),
        np.ascontiguousarray(val, np.float32).view(np.int32), seg_beg, seg_end, seg_ptr, long_rows,
        listed,
    ]))


def _empty_cell() -> OocSubPart:
    return _pack(np.zeros(1, np.int32), np.zeros(0, np.int32), np.zeros(0, np.float32))


def _views(packed: torch.Tensor, counts, num_nodes: int, row_offset: int) -> CsrPart:
    """The ``CsrPart`` (with its plan) over ``packed``'s views, on its device."""
    rows, nnz, n_seg, n_long, n_listed = counts
    sizes = (rows + 1, nnz, nnz, n_seg, n_seg, n_long + 1, n_long, n_listed)
    views, o = [], _HEADER
    for size in sizes:
        views.append(packed[o:o + size])
        o += size
    rowptr, col, val, seg_beg, seg_end, seg_ptr, long_rows, listed = views
    plan = SplitPlan(seg_beg, seg_end, seg_ptr, long_rows, listed, SPLIT_NNZ, rowptr)
    return CsrPart(rowptr, col, val.view(torch.float32), row_offset, rows, num_nodes, plan)


def _upload(sub: OocSubPart, device: torch.device, num_nodes: int, row_offset: int = 0) -> CsrPart:
    """``sub`` as a :class:`CsrPart` on ``device``.  On the card the packed
    array goes through a pinned copy and one asynchronous copy on the current
    stream (the caller's copy stream): the pinned block is freed at once, and
    PyTorch's caching host allocator hands it out again only after the copy
    recorded on it has completed.  On the CPU it is a copy of the array (a
    cached layout's arrays are read-only memmaps)."""
    if device.type == "cuda":
        host = torch.empty(sub.packed.shape[0], dtype=torch.int32, pin_memory=True)
        host.numpy()[:] = sub.packed
        dev = host.to(device, non_blocking=True)
    else:
        dev = torch.from_numpy(np.array(sub.packed))
    return _views(dev, sub.counts, num_nodes, row_offset)


# -- the copy pipeline ---------------------------------------------------------


class PinnedRing:
    """Host buffers used in turn (two by default), for one copy direction.

    :meth:`take` hands out the next slot as a tensor of the asked shape and
    dtype, after waiting for the event of the copy that used the slot last,
    so the host never rewrites memory a host-to-device copy still reads, nor
    hands out memory a device-to-host copy still writes; :meth:`release`
    records that event on the stream of the copy.  A slot holds bytes, so
    one dtype after another reuses it; it is at least ``slot_bytes`` and
    grows when a larger shape is asked for.  ``pin=False`` gives plain host
    memory (the CPU runs); pinning needs CUDA and raises without it.
    """

    def __init__(self, slots: int = 2, slot_bytes: int = 0, pin: bool = True):
        self.slot_bytes = slot_bytes
        self.pin = pin
        self._bufs: List[Optional[torch.Tensor]] = [None] * slots
        self._events: List[Optional[torch.cuda.Event]] = [None] * slots
        self._next = 0

    @property
    def nbytes(self) -> int:
        """Host bytes the slots hold."""
        return sum(b.numel() for b in self._bufs if b is not None)

    def take(self, shape, dtype: torch.dtype) -> Tuple[torch.Tensor, int]:
        k = self._next
        self._next = (k + 1) % len(self._bufs)
        self.wait(k)
        need = int(np.prod(shape)) * dtype.itemsize
        buf = self._bufs[k]
        if buf is None or buf.numel() < need:
            buf = self._bufs[k] = torch.empty(max(need, self.slot_bytes, 1), dtype=torch.uint8,
                                              pin_memory=self.pin)
        return buf[:need].view(dtype).view(shape), k

    def release(self, k: int, stream) -> None:
        """The copy that uses slot ``k`` has been issued on ``stream`` (None:
        it has completed, as a copy on the CPU has)."""
        ev = None
        if stream is not None:
            ev = torch.cuda.Event()
            ev.record(stream)
        self._events[k] = ev

    def wait(self, k: int) -> None:
        if self._events[k] is not None:
            self._events[k].synchronize()


class _Pipeline:
    """The streams and staging of one out-of-core call.

    On the card: the kernels on the current (compute) stream, host-to-device
    copies on ``h2d``, device-to-host copies on ``d2h``; feature workspaces
    staged through a :class:`PinnedRing` into (at most) two device buffers
    of ``ws_rows`` rows, each reused only after the kernels that read it (an
    event on the compute stream); results read back through another ring.
    On the CPU every step is the array itself, in order.
    """

    def __init__(self, device: torch.device, ws_rows: int, d: int, dtype: torch.dtype):
        if device.type == "cuda" and device.index is None:
            # the index the tensors it makes will carry, so the layout's
            # edge cache recognizes them on the next call
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.cuda = device.type == "cuda"
        self.dtype = dtype
        self.bits = _bits_dtype(dtype)
        self.d = d
        self.ws_rows = ws_rows
        if not self.cuda:
            return
        self.compute = torch.cuda.current_stream(device)
        self.h2d = torch.cuda.Stream(device)
        self.d2h = torch.cuda.Stream(device)
        self.ring_in, self.ring_out = PinnedRing(), PinnedRing()
        self.ws: List[Optional[torch.Tensor]] = [None, None]
        self.ws_free: List[Optional[torch.cuda.Event]] = [None, None]

    def stage(self, rows: int, fill: Callable[[np.ndarray], None]) -> Tuple[torch.Tensor, int]:
        """A workspace of ``rows`` feature rows on the device, filled on the
        host by ``fill(array)``; returns it and its slot.  On the card it is
        ready for kernels issued after :meth:`ready`."""
        if not self.cuda:
            buf = np.empty((rows, self.d), _np_bits(self.bits))
            fill(buf)
            return _as_tensor(buf, self.dtype), -1
        host, k = self.ring_in.take((rows, self.d), self.bits)
        fill(host.numpy())
        with torch.cuda.stream(self.h2d):
            if self.ws[k] is None:
                # allocated on the copy stream that writes it, read by the kernels
                self.ws[k] = torch.empty((self.ws_rows, self.d), dtype=self.bits, device=self.device)
                self.ws[k].record_stream(self.compute)
            if self.ws_free[k] is not None:
                self.h2d.wait_event(self.ws_free[k])
            dev = self.ws[k][:rows]
            dev.copy_(host, non_blocking=True)
            self.ring_in.release(k, self.h2d)
        return dev.view(self.dtype), k

    def ready(self) -> None:
        """Kernels issued from here on see every copy issued on ``h2d``."""
        if self.cuda:
            self.compute.wait_stream(self.h2d)

    def used(self, k: int) -> None:
        """The kernels that read workspace ``k`` have all been issued."""
        if self.cuda and k >= 0:
            ev = torch.cuda.Event()
            ev.record(self.compute)
            self.ws_free[k] = ev

    def readback(self, res: torch.Tensor):
        """Start copying ``res`` (on the device) to the host; returns a
        handle for :meth:`result`."""
        if not self.cuda:
            return res, -1
        host, k = self.ring_out.take(tuple(res.shape), res.dtype)
        self.d2h.wait_stream(self.compute)
        with torch.cuda.stream(self.d2h):
            host.copy_(res, non_blocking=True)
            self.ring_out.release(k, self.d2h)
        res.record_stream(self.d2h)
        return host, k

    def result(self, handle) -> torch.Tensor:
        """The host tensor of a :meth:`readback`, once its copy completed."""
        host, k = handle
        if k >= 0:
            self.ring_out.wait(k)
        return host

    def finish(self, wait: bool) -> None:
        """Order the compute stream after both copy streams, so memory freed
        on it after the call is no longer read or written by a copy; with
        ``wait``, also wait for it (a ``null_transfer`` call reads nothing
        back, so nothing else waits for its kernels)."""
        if self.cuda:
            self.compute.wait_stream(self.h2d)
            self.compute.wait_stream(self.d2h)
            if wait:
                self.compute.synchronize()


def _np_bits(bits: torch.dtype):
    return np.int16 if bits == torch.int16 else np.float32


def _device_edges(oc, key, sub: OocSubPart, pipe: _Pipeline, num_nodes: int, cache: bool) -> CsrPart:
    """The cell or part ``key`` on the card, from the layout's edge cache or
    uploaded on the copy stream (and kept when ``cache``)."""
    part = oc._dev_edges.get(key)
    if part is not None and part.rowptr.device == pipe.device:
        return part
    if pipe.cuda:
        with torch.cuda.stream(pipe.h2d):
            part = _upload(sub, pipe.device, num_nodes)
        # allocated on the copy stream, read by the kernels
        part.rowptr.record_stream(pipe.compute)
    else:
        part = _upload(sub, pipe.device, num_nodes)
    if cache:
        oc._dev_edges[key] = part
    return part


def _apply_diag(diag: np.ndarray, x_bits: np.ndarray, dtype: torch.dtype, out_t: torch.Tensor) -> None:
    """``out += diag[:, None] * x`` on the host, a window of rows at a time:
    the self-loop term the layouts split out of the edges.  Each window of
    ``x`` is copied (in parallel) into one reused buffer, since ``x`` may be
    a read-only memmap, and added in place: the product is taken in f32 and
    rounded once into ``out``."""
    diag_t = torch.from_numpy(diag)
    n = diag.shape[0]
    buf = np.empty((min(n, _DIAG_WINDOW), x_bits.shape[1]), x_bits.dtype)
    for lo in range(0, n, _DIAG_WINDOW):
        hi = min(lo + _DIAG_WINDOW, n)
        window = native.gather_rows(x_bits, np.arange(lo, hi, dtype=np.int32), out=buf[:hi - lo])
        out_t[lo:hi].addcmul_(diag_t[lo:hi, None], _as_tensor(window, dtype))


# -- 1-D layout -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OocPart:
    """One part of the 1-D layout: ``csr`` over the part's rows (local, from
    ``row_offset``) whose columns index its workspace ``x[cols]``."""

    csr: OocSubPart
    cols: np.ndarray  # int32 global feature rows, sorted
    row_offset: int

    @property
    def num_rows(self) -> int:
        return self.csr.num_rows


@dataclasses.dataclass
class OutOfCoreAdj:
    """Host-resident 1-D layout for feature-out-of-core SpMM."""

    num_nodes: int
    parts: List[OocPart]
    diag: Optional[np.ndarray]  # (N,) f32 self-loop weights, applied on the host
    # device copies of part edges (the same every hop, so re-sending them is
    # PCIe waste), bounded by ``max_device_edge_bytes`` in spmm_out_of_core
    _dev_edges: dict = dataclasses.field(default_factory=dict, repr=False)
    # null_transfer mode: one device workspace shared by every part
    _dev_ws: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def num_parts(self) -> int:
        return len(self.parts)

    @property
    def workspace_rows(self) -> List[int]:
        return [int(p.cols.shape[0]) for p in self.parts]

    def part_edge_nbytes(self) -> List[int]:
        return [p.csr.nbytes for p in self.parts]


def prepare_out_of_core(adj, max_edges_per_part: int = 6 << 20, *, split_diag: bool = True) -> OutOfCoreAdj:
    """Build the 1-D out-of-core layout on the host.

    ``adj`` is a :class:`SparseAdj` (CPU tensors, e.g.
    ``symmetric_normalized_weights_host``) or a ``(src, dst, w, num_nodes)``
    tuple of host arrays, weights already normalized.  Parts are
    ``prepare_csr_parts``' balanced nonzero ranges of the dst-sorted CSR;
    with ``split_diag`` the self-loops are taken out and applied on the host.
    No device memory is touched.
    """
    src, dst, w, n, srt = _host_edges(adj)
    diag = None
    if split_diag:
        src, dst, w, diag = _split_diag(src, dst, w, n)
    if not srt:
        src, dst, w = native.sort_edges_by_dst(src, dst, w, n)
    csr = prepare_csr(SparseAdj(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w), n,
                                sorted_by_dst=True))
    parts = []
    for p in prepare_csr_parts(csr, max_edges_per_part) if csr.nnz else ():
        cols, local = _unique_inverse(p.col.numpy())
        parts.append(OocPart(_pack(p.rowptr.numpy(), local, p.val.numpy(), p.plan), cols, p.row_offset))
    if not parts:  # no edge off the diagonal
        parts = [OocPart(_empty_cell(), np.zeros(0, np.int32), 0)]
    ws = sum(int(p.cols.shape[0]) for p in parts)
    logger.info(
        "out-of-core layout: %d parts, %d nonzeros; workspaces %d rows in all (%.2fx the "
        "features); diag %s", len(parts), csr.nnz, ws, ws / max(n, 1),
        "split" if diag is not None else "off",
    )
    return OutOfCoreAdj(num_nodes=n, parts=parts, diag=diag)


def _check_x(x_bits: np.ndarray, n: int) -> None:
    if x_bits.ndim != 2 or x_bits.shape[0] != n:
        raise ValueError(f"x must be [{n}, D], got {x_bits.shape}")


def spmm_out_of_core(
    oc: OutOfCoreAdj,
    x_host,
    out=None,
    device=None,
    max_device_edge_bytes: int = 4 << 30,
    null_transfer: bool = False,
):
    """``y = adj @ x`` with ``x``, ``y`` and the edges on the host, one part
    at a time through ``device`` (default: the GPU; ``device="cpu"`` runs
    the plain path).  Returns ``out`` (allocated when None) in ``x_host``'s
    type and dtype: numpy float32, or a CPU tensor of float32 or bfloat16.

    Per part: the host gathers ``x[cols]`` into a pinned slot, the copy
    stream sends it, ``spmm_csr_acc`` adds the part into a zeroed f32
    accumulator, which is cast to the output dtype on the device (a bf16
    output halves the readback), read back into pinned memory and added
    into ``out`` (a row cut between two parts lies in both).  Part ``i+1`` is
    issued before part ``i``'s readback is waited on.  Part edges stay on
    the card in part order up to ``max_device_edge_bytes``; a later call
    with a smaller budget evicts the parts past it.

    ``null_transfer=True`` is a measurement mode: the same kernels on the
    same parts, against one device workspace shared by every part, with no
    feature copy either way; what it returns is NOT the product.
    """
    device = resolve_device(device)
    x_bits, dtype = host_bits(x_host)
    _check_x(x_bits, oc.num_nodes)
    n, d = x_bits.shape
    # parts add into it (a null_transfer call returns no product)
    out, out_t = _new_out(x_host, n, d, dtype, out, zero=not null_transfer)
    sizes = oc.part_edge_nbytes()
    cacheable = int(np.searchsorted(np.cumsum(sizes), max_device_edge_bytes, side="right"))
    for i in [i for i in oc._dev_edges if i >= cacheable]:
        del oc._dev_edges[i]
    max_ws = max(oc.workspace_rows)
    pipe = _Pipeline(device, max_ws, d, dtype)
    shared = None
    if null_transfer:
        key = (str(dtype), d, str(device))
        shared = oc._dev_ws.get(key)
        if shared is None:
            big = max(oc.parts, key=lambda p: p.cols.shape[0])
            rows = torch.from_numpy(native.gather_rows(x_bits, big.cols)).view(dtype)
            shared = oc._dev_ws[key] = rows.to(device)
    pending = None
    for i, p in enumerate(oc.parts):
        if p.csr.nnz == 0:
            continue
        s = int(p.cols.shape[0])
        edges = _device_edges(oc, i, p.csr, pipe, s, cache=i < cacheable)
        k = -1
        if null_transfer:
            ws = shared.narrow(0, 0, s)
        else:
            ws, k = pipe.stage(s, lambda buf, cols=p.cols: native.gather_rows(x_bits, cols, out=buf))
        pipe.ready()
        acc = torch.zeros((p.num_rows, d), dtype=torch.float32, device=device)
        spmm_csr_acc(edges, ws, acc)
        pipe.used(k)
        if null_transfer:
            continue
        handle = pipe.readback(acc.to(dtype))
        if pending is not None:
            _flush_add(pipe, out_t, *pending)
        pending = (handle, p.row_offset, p.num_rows)
    if pending is not None:
        _flush_add(pipe, out_t, *pending)
    pipe.finish(wait=null_transfer)
    if null_transfer:
        return out
    if oc.diag is not None:
        _apply_diag(oc.diag, x_bits, dtype, out_t)
    return out


def _flush_add(pipe: _Pipeline, out_t: torch.Tensor, handle, row_offset: int, rows: int) -> None:
    # consecutive parts may share a row: overlap-ADD
    out_t[row_offset:row_offset + rows] += pipe.result(handle)


# -- 2-D layout -----------------------------------------------------------------


@dataclasses.dataclass
class OutOfCoreAdj2D:
    """2-D (dst-part x src-block) out-of-core layout.

    The 1-D layout's unique-column workspaces degrade on power-law graphs:
    hub sources reach every dst range, so each part's workspace covers ~all
    of ``x``.  Here the workspace of block ``b`` is the contiguous slice
    ``x[b*block_rows:(b+1)*block_rows]`` (no host gather), and the block loop
    runs outside the part loop, so each block crosses once per accumulator
    group: ``ceil(P/G)`` feature volumes a hop.

    ``parts[p][b]`` is the cell of part ``p`` (rows ``row_offsets[p]`` ..
    ``+ valid_rows[p]``) and block ``b``: a CSR over the part's rows whose
    columns are block-relative; an empty cell has no rows.
    """

    num_nodes: int
    block_rows: int
    num_blocks: int
    row_offsets: List[int]
    valid_rows: List[int]
    parts: List[List[OocSubPart]]
    diag: Optional[np.ndarray]
    _dev_edges: dict = dataclasses.field(default_factory=dict, repr=False)
    _dev_ws: dict = dataclasses.field(default_factory=dict, repr=False)
    # spmm_2d_resident's device cells (global row offsets), apart from
    # _dev_edges, whose (part, block) keys the byte budget evicts
    _dev_stacks: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def num_parts(self) -> int:
        return len(self.parts)

    @property
    def n_rows(self) -> int:
        return max(self.valid_rows)

    @property
    def num_cells(self) -> int:
        """Non-empty cells: one kernel launch each a hop."""
        return sum(1 for row in self.parts for s in row if s.nnz)

    def block_range(self, b: int) -> Tuple[int, int]:
        """``(first row, rows)`` of block ``b``; the last block may be short."""
        lo = b * self.block_rows
        return lo, max(0, min(self.block_rows, self.num_nodes - lo))

    def subpart_edge_nbytes(self) -> int:
        """Bytes of the packed CSRs of every non-empty cell."""
        return sum(s.nbytes for row in self.parts for s in row if s.nnz)


def auto_src_blocks(num_nodes: int, nnz: int, feat_dim: int, feat_dtype) -> int:
    """``src_blocks="auto"``: blocks of at most :data:`SRC_BLOCK_BYTES` of
    features, and no more blocks than the mean degree ``nnz / num_nodes``:
    every cell carries a row pointer over its part's rows, so ``k`` blocks
    cost ``4k(N + P)`` bytes of row pointers, which this keeps below the
    columns' ``4 nnz``."""
    item = torch.empty((), dtype=_torch_dtype(feat_dtype)).element_size()
    k = -(-num_nodes * max(int(feat_dim), 1) * item // SRC_BLOCK_BYTES)
    return int(max(1, min(k, nnz // max(num_nodes, 1))))


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or getattr(dtype, "__name__", None) or str(dtype)
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _part_bounds(dst: np.ndarray, n: int, max_edges_per_part: int) -> List[int]:
    """Row bounds of the dst parts, balanced by edge count: ``sgl_tpu``'s
    tile bounds with one-row tiles."""
    cum = np.cumsum(np.bincount(dst, minlength=n))
    total = int(cum[-1]) if n else 0
    n_parts = max(-(-total // max_edges_per_part), 1)
    targets = np.linspace(0, total, n_parts + 1)[1:-1]
    return sorted(set([0] + np.searchsorted(cum, targets).tolist() + [n]))


def prepare_out_of_core_2d(
    adj,
    max_edges_per_part: int = 6 << 20,
    src_blocks="auto",
    *,
    split_diag: bool = True,
    feat_dim: int = 128,
    feat_dtype=torch.float32,
    strict: bool = False,
    cache_dir: Optional[str] = None,
) -> OutOfCoreAdj2D:
    """Build the 2-D out-of-core layout (see :class:`OutOfCoreAdj2D`).

    ``src_blocks`` is the block count; ``"auto"`` is :func:`auto_src_blocks`
    at ``feat_dim``/``feat_dtype``, the width and dtype of the features the
    layout will meet.  Parts end on row boundaries with about
    ``max_edges_per_part`` edges each.  The edges are sorted into cells by
    the native classifier (``graph/native.py``), dst order kept inside each
    cell.

    ``cache_dir`` keeps the built layout on disk, keyed by a hash of the
    edge arrays and every parameter: a directory of ``.npy`` files that a
    warm call opens ``mmap_mode="r"``.  ``strict=True`` raises (default:
    warns) when the densest cell's device arrays exceed
    :data:`_CELL_BYTE_BUDGET`, on cold builds and warm loads alike.
    """
    src, dst, w, n, srt = _host_edges(adj)
    if src_blocks == "auto":
        src_blocks = auto_src_blocks(n, src.shape[0], feat_dim, feat_dtype)
    k = int(src_blocks)
    if k < 1:
        raise ValueError(f"src_blocks must be >= 1 or 'auto', got {src_blocks}")
    cache_path = None
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        cache_path = _layout_cache_path(cache_dir, src, dst, w, n, max_edges_per_part, k, split_diag)
        if os.path.isdir(cache_path):
            t0 = time.perf_counter()
            oc = load_out_of_core_2d(cache_path)
            logger.info("2-D out-of-core layout loaded from cache in %.3f s (%s)",
                        time.perf_counter() - t0, cache_path)
            # the guard runs on warm loads too: the cache may have been
            # built by a warn-only caller
            _guard_cell_budget(oc.parts, strict, feat_dim)
            return oc
    diag = None
    if split_diag:
        src, dst, w, diag = _split_diag(src, dst, w, n)
    if not srt:
        src, dst, w = native.sort_edges_by_dst(src, dst, w, n)
    bounds = _part_bounds(dst, n, max_edges_per_part)
    n_parts = len(bounds) - 1
    sb = max(-(-n // k), 1)
    part_of_row = np.repeat(np.arange(n_parts, dtype=np.int32), np.diff(bounds))
    src, dst, w, cell_counts = native.classify_sort_cells_2d(src, dst, w, sb, k, part_of_row)
    starts = np.concatenate([[0], np.cumsum(cell_counts)])
    parts = []
    for p in range(n_parts):
        row_lo, rows = bounds[p], bounds[p + 1] - bounds[p]
        row = []
        for b in range(k):
            lo, hi = int(starts[p * k + b]), int(starts[p * k + b + 1])
            if hi == lo:
                row.append(_empty_cell())
                continue
            counts = np.bincount(dst[lo:hi] - row_lo, minlength=rows)
            rowptr = np.concatenate([[0], np.cumsum(counts)])
            row.append(_pack(rowptr, src[lo:hi] - np.int32(b * sb), w[lo:hi]))
        parts.append(row)
    return _finish_out_of_core_2d(parts, n, sb, k, bounds, diag, strict, feat_dim, cache_path)


def _finish_out_of_core_2d(parts, n, sb, k, bounds, diag, strict, feat_dim, cache_path) -> OutOfCoreAdj2D:
    """The tail of the 2-D build: the guard, the log line, the object and
    the cache save."""
    _guard_cell_budget(parts, strict, feat_dim)
    oc = OutOfCoreAdj2D(
        num_nodes=n, block_rows=sb, num_blocks=k,
        row_offsets=[int(b) for b in bounds[:-1]],
        valid_rows=[int(hi - lo) for lo, hi in zip(bounds[:-1], bounds[1:])],
        parts=parts, diag=diag,
    )
    logger.info(
        "2-D out-of-core layout: %d parts x %d blocks (%d non-empty cells), block workspace %d "
        "rows, largest part %d rows, %d bytes of packed cells",
        oc.num_parts, k, oc.num_cells, sb, oc.n_rows, oc.subpart_edge_nbytes(),
    )
    if cache_path is not None:
        t0 = time.perf_counter()
        save_out_of_core_2d(oc, cache_path)
        logger.info("2-D out-of-core layout cached in %.3f s (%s)", time.perf_counter() - t0, cache_path)
    return oc


def _cell_bytes(s: OocSubPart, feat_dim: int) -> int:
    """What the card allocates for cell ``s``: its packed arrays and the f32
    fix-up workspace of its segments at ``feat_dim``."""
    return s.nbytes + 4 * s.counts[2] * int(feat_dim)


def _guard_cell_budget(parts, strict: bool, feat_dim: int) -> None:
    """Bound what the port allocates for one cell (cold builds and warm
    cache loads).  Parts end on row boundaries, so a row with more edges
    than ``max_edges_per_part`` cannot be split; under ``strict`` this
    raises here, at the cause, instead of an out-of-memory error later."""
    worst = max((_cell_bytes(s, feat_dim) for row in parts for s in row if s.nnz), default=0)
    if worst > _CELL_BYTE_BUDGET:
        msg = (f"2-D out-of-core: densest cell needs {worst} bytes on the card at width "
               f"{feat_dim} (budget {_CELL_BYTE_BUDGET}): raise src_blocks or lower "
               "max_edges_per_part")
        if strict:
            raise ValueError(msg)
        warnings.warn(msg, stacklevel=3)


def save_out_of_core_2d(oc: OutOfCoreAdj2D, path) -> None:
    """Write a 2-D layout as a directory of ``.npy`` files, one per cell, so
    :func:`load_out_of_core_2d` can open each ``mmap_mode="r"``.  Written
    under a temporary name and renamed: a crashed save never half-caches."""
    path = str(path)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)

    def put(name, arr):
        np.save(os.path.join(tmp, name + ".npy"), arr)

    put("meta", np.asarray([oc.num_nodes, oc.block_rows, oc.num_blocks, oc.num_parts], np.int64))
    put("row_offsets", np.asarray(oc.row_offsets, np.int64))
    put("valid_rows", np.asarray(oc.valid_rows, np.int64))
    if oc.diag is not None:
        put("diag", oc.diag)
    for p, row in enumerate(oc.parts):
        for b, s in enumerate(row):
            put(f"c{p}_{b}", s.packed)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def load_out_of_core_2d(path) -> OutOfCoreAdj2D:
    """Open a layout written by :func:`save_out_of_core_2d`; the cells are
    read-only memmaps, paged in as they are copied to the card."""
    path = str(path)

    def get(name, mmap=True):
        return np.load(os.path.join(path, name + ".npy"), mmap_mode="r" if mmap else None)

    num_nodes, block_rows, num_blocks, n_parts = get("meta", mmap=False).tolist()
    parts = [[OocSubPart(get(f"c{p}_{b}")) for b in range(num_blocks)] for p in range(n_parts)]
    has_diag = os.path.exists(os.path.join(path, "diag.npy"))
    return OutOfCoreAdj2D(
        num_nodes=int(num_nodes), block_rows=int(block_rows), num_blocks=int(num_blocks),
        row_offsets=get("row_offsets", mmap=False).tolist(),
        valid_rows=get("valid_rows", mmap=False).tolist(),
        parts=parts, diag=get("diag", mmap=False) if has_diag else None,
    )


def _layout_cache_path(cache_dir, src, dst, w, n, max_edges_per_part, src_blocks, split_diag) -> str:
    """Content-keyed cache path: a hash of the edge arrays and every layout
    parameter, so a changed graph or configuration never aliases; the
    port's own prefix and key, so it never reads ``sgl_tpu``'s caches."""
    h = hashlib.sha1()
    h.update(f"sgl_tpu_torch-v2|{n}|{max_edges_per_part}|{src_blocks}|{split_diag}|{src.shape[0]}".encode())
    for a in (src, dst, w):
        h.update(np.ascontiguousarray(a).tobytes())
    return os.path.join(str(cache_dir), _CACHE_PREFIX + h.hexdigest())


def spmm_out_of_core_2d(
    oc: OutOfCoreAdj2D,
    x_host,
    out=None,
    device=None,
    max_device_edge_bytes: int = 4 << 30,
    max_device_acc_bytes: int = 2 << 30,
    null_transfer: bool = False,
):
    """``y = adj @ x`` through the 2-D layout, ``x`` and ``y`` on the host
    (types as :func:`spmm_out_of_core`).

    Parts run in groups whose f32 accumulators fit ``max_device_acc_bytes``.
    For each group, each block that a cell of the group reads is copied once
    (host slice into a pinned slot, then the copy stream) and each
    non-empty cell runs ``spmm_csr_acc`` into its part's accumulator; block
    ``b+1``'s copy overlaps block ``b``'s cells.  Then each accumulator is
    cast on the device and read back.  Cells stay on the card up to
    ``max_device_edge_bytes``; a later call with a smaller budget evicts
    the most recent ones until it holds.

    ``null_transfer=True`` is the measurement mode of
    :func:`spmm_out_of_core`: one device block shared by every block, no
    feature copy either way, a result that is NOT the product.
    """
    device = resolve_device(device)
    x_bits, dtype = host_bits(x_host)
    _check_x(x_bits, oc.num_nodes)
    n, d = x_bits.shape
    # the parts' rows cover [0, n) once each: every row is written, none added
    out, out_t = _new_out(x_host, n, d, dtype, out, zero=False)
    acc_bytes = max(oc.n_rows * d * 4, 1)
    group = max(int(max_device_acc_bytes // acc_bytes), 1)
    cached = sum(oc.parts[p][b].nbytes for p, b in oc._dev_edges)
    for key in reversed(list(oc._dev_edges)):
        if cached <= max_device_edge_bytes:
            break
        cached -= oc.parts[key[0]][key[1]].nbytes
        del oc._dev_edges[key]
    pipe = _Pipeline(device, oc.block_rows, d, dtype)
    shared = None
    if null_transfer:
        key = (str(dtype), d, str(device))
        shared = oc._dev_ws.get(key)
        if shared is None:
            rows = oc.block_range(0)[1]
            shared = oc._dev_ws[key] = _as_tensor(np.array(x_bits[:rows]), dtype).to(device)
    pending = None
    for g_lo in range(0, oc.num_parts, group):
        g = range(g_lo, min(g_lo + group, oc.num_parts))
        accs = {p: torch.zeros((oc.valid_rows[p], d), dtype=torch.float32, device=device) for p in g}
        for b in range(oc.num_blocks):
            cells = [p for p in g if oc.parts[p][b].nnz]
            if not cells:
                continue  # no cell of the group reads this block: no copy
            lo, rows = oc.block_range(b)
            edges = []
            for p in cells:
                s = oc.parts[p][b]
                keep = (p, b) in oc._dev_edges or cached + s.nbytes <= max_device_edge_bytes
                if keep and (p, b) not in oc._dev_edges:
                    cached += s.nbytes
                edges.append(_device_edges(oc, (p, b), s, pipe, rows, cache=keep))
            k = -1
            if null_transfer:
                ws = shared.narrow(0, 0, rows)
            else:
                idx = np.arange(lo, lo + rows, dtype=np.int32)
                ws, k = pipe.stage(rows, lambda buf, idx=idx: native.gather_rows(x_bits, idx, out=buf))
            pipe.ready()
            for p, part in zip(cells, edges):
                spmm_csr_acc(part, ws, accs[p])
            pipe.used(k)
        for p in g:
            acc = accs.pop(p)
            if null_transfer:
                continue
            handle = pipe.readback(acc.to(dtype))
            if pending is not None:
                _flush_copy(pipe, out_t, *pending)
            pending = (handle, oc.row_offsets[p], oc.valid_rows[p])
    if pending is not None:
        _flush_copy(pipe, out_t, *pending)
    pipe.finish(wait=null_transfer)
    if null_transfer:
        return out
    if oc.diag is not None:
        _apply_diag(oc.diag, x_bits, dtype, out_t)
    return out


def _flush_copy(pipe: _Pipeline, out_t: torch.Tensor, handle, row_offset: int, rows: int) -> None:
    # 2-D parts own disjoint rows
    out_t[row_offset:row_offset + rows].copy_(pipe.result(handle))


def k_hop_out_of_core(oc, x_host, prop_steps: int, hop_sink=None, device=None):
    """``[X, AX, A^2 X, ...]`` with every hop on the host.

    ``oc`` is an :class:`OutOfCoreAdj` or :class:`OutOfCoreAdj2D`.  With
    ``hop_sink(k, arr)`` each hop is handed off (e.g. to a
    :class:`~sgl_tpu_torch.utils.MemmapHopSink`) instead of kept, so peak
    host memory is two hop matrices, and this returns None; otherwise it
    returns the list of hops.
    """
    device = resolve_device(device)
    spmm = spmm_out_of_core_2d if isinstance(oc, OutOfCoreAdj2D) else spmm_out_of_core
    hops = None
    if hop_sink is None:
        hops = [x_host]
    else:
        hop_sink(0, x_host)
    cur = x_host
    for k in range(1, prop_steps + 1):
        cur = spmm(oc, cur, device=device)
        if hop_sink is None:
            hops.append(cur)
        else:
            hop_sink(k, cur)
    return hops


def hop_transfer_bytes(oc, d: int, elem: int, max_device_acc_bytes: int = 2 << 30) -> Tuple[int, int]:
    """Feature bytes one hop copies each way, ``(to the card, to the host)``,
    at width ``d`` and ``elem`` bytes an element (edges not counted: they
    stay cached on the card)."""
    if isinstance(oc, OutOfCoreAdj2D):
        group = max(int(max_device_acc_bytes // max(oc.n_rows * d * 4, 1)), 1)
        h2d = 0
        for g_lo in range(0, oc.num_parts, group):
            g = range(g_lo, min(g_lo + group, oc.num_parts))
            h2d += sum(oc.block_range(b)[1] for b in range(oc.num_blocks)
                       if any(oc.parts[p][b].nnz for p in g))
        return h2d * d * elem, sum(oc.valid_rows) * d * elem
    live = [p for p in oc.parts if p.csr.nnz]
    return sum(int(p.cols.shape[0]) for p in live) * d * elem, sum(p.num_rows for p in live) * d * elem


# -- the 2-D layout with x on the card ------------------------------------------


def spmm_2d_resident(oc: OutOfCoreAdj2D, x: torch.Tensor) -> torch.Tensor:
    """``y = adj @ x`` with ``x`` on its device, through the 2-D layout's
    cells: the counterpart of ``spmm_pallas_2d_resident``
    (``sgl_tpu/kernels/spmm_ooc.py:1324``, its scan over stacked cells of
    one size class, ``_resident_class_scan``).

    Each non-empty cell is one ``spmm_csr_acc`` on ``x.narrow(0, b*sb, sb)``
    into one f32 output at its part's global rows; the self-loop term is
    added after, and ``y`` comes back in ``x``'s dtype.  The cells move to
    ``x``'s device once and stay with the layout.  Its peak memory is ``x``,
    ``y`` and the cells: no messages, no per-part buffers.
    """
    if x.dim() != 2 or x.shape[0] != oc.num_nodes:
        raise ValueError(f"x must be [{oc.num_nodes}, D], got {tuple(x.shape)}")
    x = x.contiguous()
    device = x.device
    cells = oc._dev_stacks.get(device)
    if cells is None:
        cells = [
            (b, _upload(s, device, oc.block_range(b)[1], oc.row_offsets[p]))
            for p, row in enumerate(oc.parts) for b, s in enumerate(row) if s.nnz
        ]
        oc._dev_stacks = {device: cells}  # one device's cells at a time
        if oc.diag is not None:
            oc._dev_stacks["diag"] = torch.from_numpy(oc.diag).to(device)
    y = torch.zeros(x.shape, dtype=torch.float32, device=device)
    for b, part in cells:
        lo, rows = oc.block_range(b)
        spmm_csr_acc(part, x.narrow(0, lo, rows), y)
    if oc.diag is not None:
        y += oc._dev_stacks["diag"][:, None] * x.float()
    return y.to(x.dtype)
