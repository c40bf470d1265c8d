"""CSR SpMM on Hopper: the port of the TPU segment-reduce kernels.

Counterpart of ``sgl_tpu/kernels/pallas_spmm.py``.  The TPU path lays the
dst-sorted edges out in 128-row tile chunks (``prepare_chunked``), splits
each f32 message into bf16 hi/lo halves and reduces them with one-hot
matmuls on the matrix unit (``_make_seg_kernel``), with self-loops and hub
sources split out of the gather.  All of that exists for the TPU's matrix
unit and its gather cost.  On the GPU the same sum is one kernel over a
plain dst-CSR (``csrc/spmm_csr.cu``): the gather, the ×w and the f32 sum
happen inside it.

The kernel balances nonzeros, not rows, across warps: every row of at most
:data:`SPLIT_NNZ` nonzeros is one warp task, and a longer row is cut into
segments of :data:`SPLIT_NNZ` consecutive nonzeros whose f32 partial sums a
second launch adds in segment order.  The cut is a :class:`SplitPlan`,
built once per CSR (and once per part) on its device and kept with it, so
every hop reuses it; where its rows are short on average it also lists
those neither empty nor long, the only ones the accumulating form then
walks.  Where ``x`` is far larger than the L2 cache, the one-shot product
walks ``x`` in column panels (:func:`panel_columns`) so that what a panel
gathers stays there.  The twins sum in the same order, which neither the
panels nor the short rows' path change.

One-shot product (``_segment_reduce_mxu``, TPU kernels K1/K2):

* :func:`prepare_csr` — the counterpart of ``prepare_chunked``: sort by dst
  (stable), drop ``w == 0`` (graph padding vanishes), build ``rowptr`` and
  the plan.
* :func:`spmm_csr` — the wrapper: launches the kernels on a CUDA tensor,
  runs :func:`spmm_csr_reference` on a CPU tensor, raises on anything else.
* :func:`spmm_csr_reference` — the plain PyTorch twin (gather, ×w, the
  scatter-adds into f32 in the kernel's order, cast); the CPU path and the
  yardstick the kernel is held against.

Streaming product, part by part (``prepare_chunked_parts`` /
``spmm_pallas_streaming`` / ``_segment_reduce_mxu_acc``, TPU kernels
K3/K4).  The TPU path splits the graph because its E×D messages would not
fit at once; the CSR kernel gathers inside and never forms them, so here
the parts buy no memory and exist to carry K3/K4 over:

* :func:`prepare_csr_parts` — split a CSR into parts of balanced nonzero
  counts (:class:`CsrParts`), each with its own plan;
* :func:`spmm_csr_acc` / :func:`spmm_csr_acc_reference` — add one part's
  product into an f32 accumulator, in place;
* :func:`spmm_csr_streaming` / :func:`spmm_csr_streaming_reference` — the
  whole product, part by part.

``spmm_csr.launches`` counts products by instantiation (one first-pass
launch each): ``"f32"``, ``"bf16"``, ``"acc_f32"``, ``"acc_bf16"``;
``spmm_csr.fixup_launches`` counts the second-pass launches, made only
when the plan has a long row; ``spmm_csr.panels`` keeps the column
panel width of each instantiation's last launch.  ``spmm_csr`` itself
records no gradient;
``sparse.spmm`` wraps it in K1's VJP, ``dx = Aᵀ g`` on
:func:`transposed`, the CSR of ``Aᵀ`` (:func:`transpose_csr`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from sgl_tpu_torch.kernels import _build
from sgl_tpu_torch.kernels.sparse import SparseAdj, add_rows_, segment_sum_f32

_INT32_MAX = 2**31 - 1

#: The longest row that is one warp task; longer rows are cut into segments
#: of this many nonzeros.  A constant of the design, the ``kSplitNnz`` of
#: ``csrc/spmm_csr.cu``, which cuts by it too: about the ~620 nonzeros a
#: warp that E / (132 SMs x 64 warps) gives at the SpMM bench shape, and
#: timed on the H100 against 256 and 1024 with
#: ``python -m sgl_tpu_torch.dev.tune_spmm_csr`` (``PERF.md``).
SPLIT_NNZ = 512

#: Bytes of ``x`` above which the one-shot product walks it in column
#: panels, and the most that one panel may gather.  On the H100 (ms, no
#: panels against panels of :data:`PANEL_BYTES`): the bench shape's f32
#: rows (x 102 MB, a panel 51.2 MB) 0.475 against 0.421; Reddit's (561 MB,
#: 59.6 MB) 119.2 against 77.9; Flickr's (178 MB, 22.8 MB) 0.907 against
#: 0.542.  Where all of ``x`` about fits the 50 MB L2 (the bench shape's
#: bf16 rows, 51.2 MB, in panels of 64 columns) panels cost 9%, and where
#: a panel does not (products 614 MB, the graph batch 308 MB, the NARS
#: batch's bf16 rows 160 MB) 8-19%; the NARS batch's f32 rows (319 MB a
#: panel) gained 11% all the same, the one shape the budget misses.  Timed with ``python -m sgl_tpu_torch.dev.tune_spmm_csr
#: --products --wide --batches`` (``PERF.md``).
L2_BUDGET = 60 * 10**6
#: The width of a column panel, in bytes of a row of ``x`` (at most the 32
#: packets a warp covers in one pass).  Each panel reads the (col, val)
#: pairs again, so narrower ones lost wherever timed (Reddit's f32 rows:
#: 32 columns 85.3 ms, 16 columns 124.7), and wider ones too (128 columns
#: 98.6; Flickr's f32 rows 0.564 against 0.542).  Timed with the budget.
PANEL_BYTES = 256
#: A plan lists its rows neither empty nor long when its non-empty rows hold
#: at most this many nonzeros on average.  Walking the list drops the empty
#: rows' tasks but costs each row task one more dependent load: on the H100
#: it gained the ring's buckets (~2 nonzeros a row, a quarter of the rows
#: empty) 9% in f32 and 2% in bf16 (1% in f32 against a walk of every row
#: whose row loop is left rolled, ``spmm_csr.cu``) and cost the 2-D
#: out-of-core cells (~13) 4% (``tune_spmm_csr --ring --ooc``, ``PERF.md``).
LIST_MAX_NNZ = 8


def _packet(d: int) -> int:
    """The elements of the kernel's packet in a panel at width ``d``: the
    widest of 4, 2, 1 that divides it."""
    return next(v for v in (4, 2, 1) if d % v == 0)


def panel_columns(n: int, d: int, elem: int) -> int:
    """The column panel width of ``A @ x`` for ``x`` of ``n`` rows, ``d``
    columns and ``elem`` bytes an element: the columns of
    :data:`PANEL_BYTES` (at most the 32 packets a warp covers in one pass)
    where ``x`` is larger than :data:`L2_BUDGET` and such a panel of it is
    not; else ``d``, no panels: ``x`` fits, or a row fits one panel, or a
    panel would gather from HBM all the same (products, the NARS and graph
    batches)."""
    cols = min(PANEL_BYTES // elem, 32 * _packet(d))
    return cols if cols < d and n * cols * elem <= L2_BUDGET < n * d * elem else d


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How the kernel cuts the long rows of one CSR (or part) into warp tasks.

    A row of at most ``split`` nonzeros is one task.  Long row
    ``long_rows[k]`` (more than ``split``) is cut into the consecutive
    segments ``seg_ptr[k] .. seg_ptr[k+1]``; segment ``t`` covers the
    nonzeros ``[seg_beg[t], seg_end[t])``: ``split`` of them, the row's last
    segment fewer.  ``rows`` lists, in order, the rows that are neither
    empty nor long, or is empty (:data:`LIST_MAX_NNZ`): the accumulating
    form's row tasks walk the list, when there is one, so an empty row
    takes no task.  All int32, on the CSR's device.  ``rowptr`` is the
    row pointer it cuts; the wrappers refuse a plan made for another, or
    with another ``split`` than :data:`SPLIT_NNZ`, by which the kernel cuts.
    """

    seg_beg: torch.Tensor
    seg_end: torch.Tensor
    seg_ptr: torch.Tensor
    long_rows: torch.Tensor
    rows: torch.Tensor
    split: int
    rowptr: torch.Tensor

    @property
    def num_segments(self) -> int:
        return int(self.seg_beg.shape[0])

    @property
    def num_long(self) -> int:
        return int(self.long_rows.shape[0])

    @property
    def num_listed(self) -> int:
        return int(self.rows.shape[0])

    def workspace_bytes(self, d: int) -> int:
        """Bytes of the f32 ``[segments, d]`` partial sums a product needs."""
        return 4 * self.num_segments * d


def _make_plan(rowptr: torch.Tensor, split: int = SPLIT_NNZ, listed: Optional[bool] = None) -> SplitPlan:
    """The plan of ``rowptr`` for segments of ``split`` nonzeros, in plain
    torch on ``rowptr``'s device.  The port's plans are of
    :data:`SPLIT_NNZ`; ``dev/tune_spmm_csr.py`` makes others for kernels
    built with another ``kSplitNnz``.  ``listed`` forces the list of rows
    neither empty nor long on or off; by default it is made when the
    non-empty rows hold at most :data:`LIST_MAX_NNZ` nonzeros on average."""
    r = rowptr.long()
    lengths = r[1:] - r[:-1]
    long_rows = torch.nonzero(lengths > split).flatten()
    nonempty = lengths > 0
    if listed is None:
        listed = int(r[-1] - r[0]) <= LIST_MAX_NNZ * int(nonempty.sum())
    rows = torch.nonzero(nonempty & (lengths <= split)).flatten() if listed else lengths.new_zeros(0)
    counts = (lengths[long_rows] + split - 1) // split
    seg_ptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    n_seg = int(seg_ptr[-1])
    owner = torch.repeat_interleave(
        torch.arange(long_rows.shape[0], device=r.device), counts, output_size=n_seg
    )
    beg = r[long_rows][owner] + (torch.arange(n_seg, device=r.device) - seg_ptr[owner]) * split
    end = torch.minimum(beg + split, r[long_rows + 1][owner])

    def i32(t):
        return t.to(torch.int32).contiguous()

    return SplitPlan(i32(beg), i32(end), i32(seg_ptr), i32(long_rows), i32(rows), split, rowptr)


def _plan(csr) -> SplitPlan:
    """``csr``'s plan; a CSR built by hand without one gets it on first use."""
    if csr.plan is None:
        object.__setattr__(csr, "plan", _make_plan(csr.rowptr))
    return csr.plan


@dataclasses.dataclass(frozen=True)
class CsrAdj:
    """Destination-row CSR: row ``r`` holds the edges into node ``r``.

    ``rowptr`` int32 ``[N+1]``; ``col`` int32 ``[nnz]`` (the edge's source);
    ``val`` f32 ``[nnz]`` (normalized weight, never 0); ``plan`` the cut of
    its long rows (:class:`SplitPlan`; built on first use when missing);
    ``t`` the CSR of its transpose, built by :func:`transposed` on first use.
    """

    rowptr: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    num_nodes: int
    plan: Optional[SplitPlan] = dataclasses.field(default=None, compare=False, repr=False)
    t: Optional["CsrAdj"] = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    @property
    def device(self) -> torch.device:
        return self.col.device


def prepare_csr(adj: SparseAdj) -> CsrAdj:
    """Dst-CSR of ``adj``, with its plan, on ``adj``'s device; build once
    per graph."""
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
    rowptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)
    return CsrAdj(
        rowptr,
        src.to(torch.int32).contiguous(),
        w.to(torch.float32).contiguous(),
        n,
        _make_plan(rowptr),
    )


def transpose_csr(adj: CsrAdj) -> CsrAdj:
    """The dst-CSR of ``Aᵀ``, with its own plan, on ``adj``'s device.

    Row ``c`` of ``Aᵀ`` holds the nonzeros of column ``c`` of ``A``: a
    stable sort of the nonzeros by column keeps them in ``A``'s row order.
    Nothing assumes symmetry: ``symmetric_normalized_weights`` with
    ``r != 0.5`` gives ``Aᵀ`` the pattern of ``A`` but other values.
    """
    rows = torch.repeat_interleave(
        torch.arange(adj.num_nodes, dtype=torch.int32, device=adj.device),
        torch.diff(adj.rowptr.long()), output_size=adj.nnz,
    )
    order = torch.argsort(adj.col, stable=True)
    counts = torch.bincount(adj.col.long(), minlength=adj.num_nodes)
    rowptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)
    return CsrAdj(rowptr, rows[order].contiguous(), adj.val[order].contiguous(), adj.num_nodes,
                  _make_plan(rowptr))


def transposed(adj: CsrAdj) -> CsrAdj:
    """``adj``'s :func:`transpose_csr`, built on first use and kept with it."""
    if adj.t is None:
        object.__setattr__(adj, "t", transpose_csr(adj))
    return adj.t


def _split_sum_f32(rowptr, col, val, num_rows: int, plan: SplitPlan, x: torch.Tensor) -> torch.Tensor:
    """The f32 row sums in the kernel's order: a row of at most
    ``plan.split`` nonzeros in edge order; a longer row as its segments'
    sums (each in edge order), added in segment order."""
    dst = torch.repeat_interleave(
        torch.arange(num_rows, dtype=torch.int32, device=col.device), torch.diff(rowptr.long())
    )
    if plan.num_segments == 0:
        return segment_sum_f32(SparseAdj(col, dst, val, num_rows, True), x)
    # the nonzeros of segment t go to output slot num_rows + t
    counts = (plan.seg_end - plan.seg_beg).long()
    seg = torch.repeat_interleave(torch.arange(plan.num_segments, device=col.device), counts)
    first = torch.repeat_interleave(plan.seg_beg.long() - (counts.cumsum(0) - counts), counts)
    dst[first + torch.arange(seg.shape[0], device=col.device)] = (num_rows + seg).to(torch.int32)
    sums = segment_sum_f32(SparseAdj(col, dst, val, num_rows + plan.num_segments), x)
    owner = torch.repeat_interleave(plan.long_rows, torch.diff(plan.seg_ptr.long()))
    return add_rows_(sums[:num_rows], owner, sums[num_rows:])


def spmm_csr_reference(adj: CsrAdj, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``adj @ x``: gather, ×w, the scatter-adds in f32 in
    the kernel's order, cast."""
    return _split_sum_f32(adj.rowptr, adj.col, adj.val, adj.num_nodes, _plan(adj), x).to(x.dtype)


# kernel instantiation -> (C entry point, number of int64 arguments)
_ENTRY = {
    "f32": ("sgl_spmm_csr_f32", 6),  # n, d, segments, long rows, listed rows, panel
    "bf16": ("sgl_spmm_csr_bf16", 6),
    "acc_f32": ("sgl_spmm_csr_acc_f32", 7),  # row_offset, then the same
    "acc_bf16": ("sgl_spmm_csr_acc_bf16", 7),
}
_DTYPE_KEY = {torch.float32: "f32", torch.bfloat16: "bf16"}


def signatures() -> dict:
    """The C argument types of each entry point of ``spmm_csr.cu``."""
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    return {fn: [ptr] * 11 + [i64] * n_ints + [ptr] for fn, n_ints in _ENTRY.values()}


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures set."""
    return _build.load_entries("spmm_csr", signatures())


def launch_panel(key: str, x: torch.Tensor) -> int:
    """The column panel width instantiation ``key`` takes on ``x``: the
    one-shot forms' :func:`panel_columns`; ``D``, no panels, for the
    accumulating forms, whose parts, cells and ring buckets all ran slower
    with panels on the H100 (each panel reads and writes its accumulator
    rows again; ``PERF.md``)."""
    n, d = x.shape
    return d if key.startswith("acc") else panel_columns(n, d, x.element_size())


def run_passes(lib: ctypes.CDLL, key: str, plan: SplitPlan, rowptr, col, val, x, out, *ints,
               panel: Optional[int] = None) -> int:
    """Both passes of instantiation ``key`` of ``lib`` on ``x``'s device's
    current stream into ``out``, with a workspace of its own; raise on a
    refused launch.  ``ints`` are the arguments before the plan's (``n, d``
    or ``row_offset, n, d``); ``panel`` is the column panel width, by
    default :func:`launch_panel`'s.  Returns the width passed.  Checks
    nothing and counts nothing: the wrappers do."""
    panel = launch_panel(key, x) if panel is None else panel
    work = torch.empty((plan.num_segments, x.shape[1]), dtype=torch.float32, device=x.device)
    _build.call(
        lib, _ENTRY[key][0], x.device,
        rowptr.data_ptr(), col.data_ptr(), val.data_ptr(), x.data_ptr(), out.data_ptr(),
        plan.seg_beg.data_ptr(), plan.seg_end.data_ptr(), plan.seg_ptr.data_ptr(),
        plan.long_rows.data_ptr(), plan.rows.data_ptr(), work.data_ptr(),
        *ints, plan.num_segments, plan.num_long, plan.num_listed, panel,
    )
    return panel


def _launch(key: str, plan: SplitPlan, rowptr, col, val, x, out, *ints) -> None:
    """:func:`run_passes` on the package's library, counted, its panel
    width kept."""
    spmm_csr.panels[key] = run_passes(_library(), key, plan, rowptr, col, val, x, out, *ints)
    spmm_csr.launches[key] += 1
    if plan.num_long:
        spmm_csr.fixup_launches[key] += 1


def _check_features(x: torch.Tensor, num_rows=None) -> None:
    if x.dim() != 2 or (num_rows is not None and x.shape[0] != num_rows):
        rows = "N" if num_rows is None else num_rows
        raise ValueError(f"x must be [{rows}, D], got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_KEY:
        raise TypeError(f"spmm_csr takes float32 or bfloat16 features, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("spmm_csr needs contiguous features")


def _check_csr(owner: str, device: torch.device, csr, num_rows: int) -> SplitPlan:
    """Check ``csr``'s arrays and that its plan is its own and cut by
    :data:`SPLIT_NNZ`; returns the plan (whose arrays :func:`_make_plan`
    made together, on one device)."""
    nnz = int(csr.col.shape[0])
    for name, t, dtype, length in (
        ("rowptr", csr.rowptr, torch.int32, num_rows + 1),
        ("col", csr.col, torch.int32, nnz),
        ("val", csr.val, torch.float32, nnz),
    ):
        if t.device != device:
            raise ValueError(f"{owner}.{name} is on {t.device}, features on {device}")
        if t.dtype != dtype or t.dim() != 1 or t.shape[0] != length or not t.is_contiguous():
            raise ValueError(f"{owner}.{name} must be a contiguous {dtype} vector of {length}")
    plan = _plan(csr)
    if plan.rowptr is not csr.rowptr:
        raise ValueError(f"{owner}.plan was built for another row pointer")
    if plan.split != SPLIT_NNZ:
        raise ValueError(f"{owner}.plan has segments of {plan.split} nonzeros; the kernel cuts "
                         f"rows of more than {SPLIT_NNZ}")
    if plan.seg_ptr.device != device:
        raise ValueError(f"{owner}.plan is on {plan.seg_ptr.device}, features on {device}")
    return plan


def spmm_csr(adj: CsrAdj, x: torch.Tensor) -> torch.Tensor:
    """``y = adj @ x`` with ``y`` in ``x``'s dtype (f32 or bf16).

    On a CUDA tensor this launches the CSR kernel (and, when a row is
    long, its fix-up) on the current stream or raises; on a CPU tensor it
    runs :func:`spmm_csr_reference`.
    """
    if x.device.type == "cpu":
        return spmm_csr_reference(adj, x)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_csr runs on CUDA or CPU tensors, got {x.device}")
    _check_features(x, adj.num_nodes)
    plan = _check_csr("CsrAdj", x.device, adj, adj.num_nodes)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    _launch(_DTYPE_KEY[x.dtype], plan, adj.rowptr, adj.col, adj.val, x, y, adj.num_nodes, x.shape[1])
    return y


spmm_csr.launches = {key: 0 for key in _ENTRY}
spmm_csr.fixup_launches = {key: 0 for key in _ENTRY}
spmm_csr.panels = {key: None for key in _ENTRY}


# -- streaming: the product part by part --------------------------------------


@dataclasses.dataclass(frozen=True)
class CsrPart:
    """The nonzeros ``[e_lo, e_hi)`` of a dst-CSR, as rows
    ``[row_offset, row_offset + num_rows)`` of the whole.

    ``rowptr`` int32 ``[num_rows+1]`` is local: the global one clamped to
    ``[e_lo, e_hi]``, minus ``e_lo``.  ``col``/``val`` are views of the
    global arrays' ``[e_lo, e_hi)`` slice, not copies.  A row cut between
    two parts lies in both, each with its share of the nonzeros.
    ``num_nodes`` is the whole graph's: the rows ``x`` must have.  ``plan``
    cuts the part's own long rows (built on first use when missing).
    """

    rowptr: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    row_offset: int
    num_rows: int
    num_nodes: int
    plan: Optional[SplitPlan] = dataclasses.field(default=None, compare=False, repr=False)

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

    The parts hold views of ``adj.col``/``adj.val``, a small local
    ``rowptr`` and a plan each; the split itself is computed on the host.
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
        local = (adj.rowptr[r_lo : r_hi + 1].clamp(e_lo, e_hi) - e_lo).contiguous()
        parts.append(
            CsrPart(local, adj.col[e_lo:e_hi], adj.val[e_lo:e_hi], r_lo, r_hi - r_lo,
                    adj.num_nodes, _make_plan(local))
        )
    return CsrParts(tuple(parts), adj.num_nodes)


def spmm_csr_acc_reference(part: CsrPart, x: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of :func:`spmm_csr_acc`: the part's f32 sums
    first (in the kernel's order, :func:`spmm_csr_reference`'s), then one
    add into the rows of the ``acc`` window that the part touches; returns
    ``acc``."""
    local = _split_sum_f32(part.rowptr, part.col, part.val, part.num_rows, _plan(part), x)
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
    leaves the tiles it never visits.  Every other row gets one add.
    Where JAX returns a new array aliased to its input, the port writes
    into ``acc`` itself.

    On a CUDA tensor this launches the kernel (and, when the part has a
    long row, its fix-up) on the current stream or raises; parts launched
    in order on one stream may share a cut row.  On a CPU tensor it runs
    :func:`spmm_csr_acc_reference`.
    """
    if x.device.type == "cpu":
        return spmm_csr_acc_reference(part, x, acc)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_csr_acc runs on CUDA or CPU tensors, got {x.device}")
    _check_features(x, part.num_nodes)
    plan = _check_csr("CsrPart", x.device, part, part.num_rows)
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
        "acc_" + _DTYPE_KEY[x.dtype], plan, part.rowptr, part.col, part.val, x, acc,
        part.row_offset, part.num_rows, x.shape[1],
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
    also a little slower, since the parts' launches run one after another
    (``PERF.md``).  The parts exist as the counterpart of K3/K4, not for
    memory.
    """
    return _streaming(parts, x, spmm_csr_acc)


def spmm_csr_streaming_reference(parts: CsrParts, x: torch.Tensor) -> torch.Tensor:
    """The plain twin of :func:`spmm_csr_streaming`, part by part, so its
    memory is one part's messages."""
    return _streaming(parts, x, spmm_csr_acc_reference)
