"""Distributed k-hop propagation: a 1-D node partition and a ring of feature
blocks, on ``torch.distributed``.

Counterpart of ``sgl_tpu/parallel/spmm_dist.py``.  The design is the same:

* nodes are block-partitioned over the mesh axis ``graph``: rank ``p`` owns
  rows ``[p·B, (p+1)·B)`` and every edge whose dst lies in its block, so it
  accumulates only into its own rows;
* its edges are bucketed by *source block*; at ring step ``s`` rank ``p``
  holds source block ``(p − s) mod P``, sends it on to ``p + 1`` and receives
  the next from ``p − 1`` while it reduces that block's bucket into its
  rows (``ppermute`` becomes ``isend``/``irecv``, posted before the reduce);
* per hop each rank moves ``N·D`` bytes around the ring and holds
  ``O(N/P · D)`` of the features.

Two layouts, as in ``sgl_tpu``:

* :func:`partition_adj` (:class:`DistAdj`) pads every bucket to one size
  and the ring body is a plain gather, ×w and f32 row sum, as ``sgl_tpu``'s
  XLA segment body is.  The CPU path runs it.
* :func:`partition_adj_chunked` (:class:`DistChunkedAdj`) keeps
  ``sgl_tpu``'s node shuffle, its self-loop and out-hub split and its dst
  super-hub strip, and makes each (owner, source block) bucket a dst-CSR
  with its split plan.  The ring reduces a bucket with ``spmm_csr_acc``
  into an f32 accumulator: K3 for f32 blocks, K4 for bf16 ones, where
  ``sgl_tpu`` runs its Pallas one-hot kernel (``spmm_dist.py:777``).  On a
  CUDA tensor that is the kernel or an error, never a quiet fallback.

What the chunked layout drops, by design: the TPU kernel's tile chunks
(``chunk``, ``tile_rows`` and their cost model), ``skip_empty_tiles`` and
``tile_mask``, the measured pick (``measure``) with the VMEM filter behind
``feat_dim``/``feat_dtype``, ``interpret``, and the rounding of ``block``
to the tile.  Buckets are not padded (ranks need not hold equal shapes), so
:func:`ring_padding_stats` reads ratio 1.0 on this layout by construction.
"""

from __future__ import annotations

import dataclasses
import logging
import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from sgl_tpu_torch.kernels.sparse import SparseAdj, add_rows_
from sgl_tpu_torch.kernels.spmm_csr import CsrPart, _make_plan, spmm_csr_acc
from sgl_tpu_torch.parallel.mesh import RingExchange, all_gather, all_reduce_, axis_size, rank_device

logger = logging.getLogger(__name__)

#: the TPU kernel's output-tile height.  ``sgl_tpu`` caps the dst-hub count
#: by a block rounded to it; the port keeps that cap so its hubs are
#: ``sgl_tpu``'s, though its own blocks are not rounded.
TPU_TILE_ROWS = 128

_PADDING_WARN_RATIO = 2.0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _real_edges(adj: SparseAdj):
    """``adj``'s edges with ``w != 0`` as host numpy arrays."""
    src = adj.src.cpu().numpy()
    dst = adj.dst.cpu().numpy()
    w = adj.w.cpu().numpy()
    keep = w != 0
    return src[keep], dst[keep], w[keep]


def ring_padding_stats(dadj) -> dict:
    """Real edges, allocated slots and their ratio for a ring layout.

    :class:`DistAdj` pads every (owner, source block) bucket to the largest
    one, so its ratio is the useless work of its ring body.
    :class:`DistChunkedAdj` holds each bucket as a CSR of its own size, so
    its ratio is 1.0 by construction."""
    if isinstance(dadj, DistChunkedAdj):
        real = slots = dadj.nnz
    else:
        w = dadj.w
        real, slots = int((w != 0).sum()), int(w.numel())
    return {"real_edges": real, "padded_slots": slots, "ratio": slots / max(real, 1)}


def _report_padding(dadj, kind: str) -> None:
    stats = ring_padding_stats(dadj)
    logger.info(
        "%s ring layout: %d real edges in %d slots (%.2fx padding, P=%d)",
        kind, stats["real_edges"], stats["padded_slots"], stats["ratio"], dadj.num_partitions,
    )
    if stats["ratio"] > _PADDING_WARN_RATIO:
        warnings.warn(
            f"{kind} ring buckets are {stats['ratio']:.1f}x padded "
            f"({stats['padded_slots']} slots for {stats['real_edges']} edges); "
            "the chunked layout holds buckets unpadded",
            stacklevel=3,
        )


# -- the segment layout ---------------------------------------------------------


@dataclasses.dataclass
class DistAdj:
    """Edge buckets for the ring, padded to one size.

    ``src``/``dst``/``w`` are host tensors of shape ``(P, P, E_b)``: owner
    rank (dst block), source block, slot.  ``src`` is local to its source
    block, ``dst`` to the owner's block; padding slots carry ``w == 0``.
    """

    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    num_nodes: int
    block: int
    _local: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def num_partitions(self) -> int:
        return int(self.src.shape[0])

    def local(self, p: int, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Owner ``p``'s ``(P, E_b)`` buckets on ``device``, kept for reuse."""
        key = (p, str(device))
        if key not in self._local:
            self._local[key] = tuple(t[p].to(device) for t in (self.src, self.dst, self.w))
        return self._local[key]


def partition_adj(adj: SparseAdj, num_partitions: int, bucket_multiple: int = 8) -> DistAdj:
    """Host-side partition of a normalized adjacency into ring buckets; the
    arrays equal ``sgl_tpu``'s bit for bit."""
    p = num_partitions
    n = adj.num_nodes
    block = _round_up(n, p) // p
    src, dst, w = _real_edges(adj)
    owner = dst // block
    sblk = src // block
    sizes = np.zeros((p, p), np.int64)
    np.add.at(sizes, (owner, sblk), 1)
    e_b = _round_up(max(int(sizes.max()), 1), bucket_multiple)
    out_src = np.zeros((p, p, e_b), np.int32)
    out_dst = np.zeros((p, p, e_b), np.int32)
    out_w = np.zeros((p, p, e_b), np.float32)
    order = np.lexsort((src, dst, sblk, owner))
    src, dst, w, owner, sblk = src[order], dst[order], w[order], owner[order], sblk[order]
    # contiguous runs per (owner, sblk); each edge's position in its bucket
    offs = np.concatenate([[0], np.cumsum(sizes.reshape(-1))]).astype(np.int64)
    pos = np.arange(src.shape[0]) - offs[(owner * p + sblk).astype(np.int64)]
    out_src[owner, sblk, pos] = (src - sblk * block).astype(np.int32)
    out_dst[owner, sblk, pos] = (dst - owner * block).astype(np.int32)
    out_w[owner, sblk, pos] = w
    out = DistAdj(torch.from_numpy(out_src), torch.from_numpy(out_dst), torch.from_numpy(out_w),
                  num_nodes=n, block=block)
    _report_padding(out, "segment")
    return out


def pad_features(x, num_partitions: int, block: Optional[int] = None) -> torch.Tensor:
    """Pad feature rows so the node axis divides evenly across ranks.

    bf16 stays bf16: the ring rotates the feature block every hop, so the
    dtype sets the bytes a hop moves and picks K4; everything else goes to
    f32."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    if block is None:
        block = _round_up(n, num_partitions) // num_partitions
    if x.dtype != torch.bfloat16:
        x = x.to(torch.float32)
    pad = block * num_partitions - n
    return torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x


# -- the chunked layout ---------------------------------------------------------


def _select_hubs(src: np.ndarray, n: int, hub_k, max_hub_bytes: int, cutoff_div: int = 700):
    """``sgl_tpu``'s pick of hub sources (``pallas_spmm.py:180``): those of
    out-degree at least ``N/700`` (at least 32), at most 8192 of them and
    ``max_hub_bytes`` of a dense f32 strip; None below 16."""
    if hub_k in (0, None):
        return None
    counts = np.bincount(src, minlength=n)
    if hub_k == "auto":
        cutoff = max(n // cutoff_div, 32)
        k = int(np.count_nonzero(counts >= cutoff))
    else:
        k = int(hub_k)
    k = min(k, 8192, max_hub_bytes // max(4 * n, 1))
    if k < 16:
        return None
    return np.argpartition(-counts, k - 1)[:k].astype(np.int32)


def split_extras(src, dst, w, n: int, *, split_diag: bool = True, hub_k="auto",
                 max_hub_bytes: int = 512 << 20):
    """The port's copy of ``sgl_tpu``'s ``split_extras``
    (``pallas_spmm.py:209``, f32 strip only): move the self-loops (only
    when hubs are split too) and the edges out of hub sources out of the
    edge list.  Returns ``(src, dst, w, diag, hub_ids, hub_m)``; ``diag`` is
    ``[n]`` f32, ``hub_m`` the dense ``[n, k]`` f32 strip, each None when
    not taken."""
    selfm = src == dst
    hubs = _select_hubs(src[~selfm], n, hub_k, max_hub_bytes)

    diag = None
    if split_diag and hubs is not None and bool(np.any(selfm)):
        diag = np.zeros(n, np.float32)
        np.add.at(diag, dst[selfm], w[selfm])
        src, dst, w = src[~selfm], dst[~selfm], w[~selfm]

    hub_ids = hub_m = None
    if hubs is not None:
        k = hubs.shape[0]
        col = np.full(n, -1, np.int64)
        col[hubs] = np.arange(k)
        hubm = col[src] >= 0
        flat = dst[hubm].astype(np.int64) * k + col[src[hubm]]
        hub_m = np.bincount(flat, weights=w[hubm], minlength=n * k).reshape(n, k).astype(np.float32)
        src, dst, w = src[~hubm], dst[~hubm], w[~hubm]
        hub_ids = hubs
    return src, dst, w, diag, hub_ids, hub_m


@dataclasses.dataclass
class _LocalChunked:
    """One owner's share of a :class:`DistChunkedAdj` on its device."""

    buckets: Tuple[CsrPart, ...]  # by source block
    diag: Optional[torch.Tensor]  # [block] f32
    hub_ids: Optional[torch.Tensor]  # [k] int64, layout ids
    hub_m: Optional[torch.Tensor]  # [block, k] f32
    hub_in_ids: Optional[torch.Tensor]  # [k_in] int64, layout ids
    hub_in_m: Optional[torch.Tensor]  # [k_in, block] f32


@dataclasses.dataclass
class DistChunkedAdj:
    """Ring buckets as CSRs (for K3/K4), with ``sgl_tpu``'s extras.

    ``buckets[o][b]`` is a :class:`CsrPart` of owner ``o`` and source block
    ``b``: rows local to ``o``'s block (``row_offset`` 0, ``num_rows`` =
    ``num_nodes`` of the part = ``block``), columns local to block ``b``,
    with its split plan.  Host tensors.  Around the ring, as in ``sgl_tpu``:

    * ``diag``: the self-loop weights, applied locally as ``diag ⊙ x``;
    * ``hub_ids``/``hub_m``: the highest out-degree sources skip the ring;
      their ``(k, D)`` rows are all-reduced once a hop and applied as
      ``hub_m_local @ x[hubs]``;
    * ``hub_in_ids``/``hub_in_m``: the highest in-degree destinations are a
      column-split dense strip: ``all_reduce_p(hub_in_m[:, block_p] @ x_p)``,
      added to the owners' rows.

    ``order[new] = old`` is the node shuffle (None at P = 1): the layout
    permutes features in and the hop stack back out.  ``diag`` and ``hub_m``
    rows and ``hub_in_m`` columns are padded to ``P·block``.
    """

    buckets: Tuple[Tuple[CsrPart, ...], ...]
    diag: Optional[torch.Tensor]
    hub_ids: Optional[torch.Tensor]
    hub_m: Optional[torch.Tensor]
    num_nodes: int
    block: int
    order: Optional[torch.Tensor] = None
    hub_in_ids: Optional[torch.Tensor] = None
    hub_in_m: Optional[torch.Tensor] = None
    _local: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def num_partitions(self) -> int:
        return len(self.buckets)

    @property
    def nnz(self) -> int:
        return sum(part.nnz for row in self.buckets for part in row)

    def local(self, p: int, device) -> _LocalChunked:
        """Owner ``p``'s buckets and extras on ``device``, kept for reuse."""
        key = (p, str(device))
        if key not in self._local:
            rows = slice(p * self.block, (p + 1) * self.block)

            def moved(part: CsrPart) -> CsrPart:
                rowptr = part.rowptr.to(device)
                return CsrPart(rowptr, part.col.to(device), part.val.to(device), part.row_offset,
                               part.num_rows, part.num_nodes, _make_plan(rowptr))

            def on(t, index=None):
                return None if t is None else (t if index is None else t[index]).to(device)

            self._local[key] = _LocalChunked(
                tuple(moved(part) for part in self.buckets[p]),
                on(self.diag, rows),
                None if self.hub_ids is None else self.hub_ids.long().to(device),
                on(self.hub_m, rows),
                None if self.hub_in_ids is None else self.hub_in_ids.long().to(device),
                None if self.hub_in_m is None else self.hub_in_m[:, rows].contiguous().to(device),
            )
        return self._local[key]


def partition_adj_chunked(
    adj: SparseAdj,
    num_partitions: int,
    *,
    split_diag: bool = True,
    hub_k="auto",
    max_hub_bytes: int = 512 << 20,
    shuffle: bool = True,
    shuffle_seed: int = 0,
) -> DistChunkedAdj:
    """Host-side partition into per-(owner, source block) CSR buckets.

    The node shuffle, the diag and out-hub split and the dst super-hub strip
    are ``sgl_tpu``'s (``spmm_dist.py:382``), so ``order``, ``diag``,
    ``hub_ids``, ``hub_m``, ``hub_in_ids`` and ``hub_in_m`` equal its arrays
    on their unpadded region, and the buckets hold the same edges.  ``block``
    is ``ceil(N / P)``, not rounded to a tile.
    """
    p = num_partitions
    n = adj.num_nodes
    src, dst, w = _real_edges(adj)

    node_order = None
    if shuffle and p > 1:
        rng = np.random.default_rng(shuffle_seed)
        node_order = rng.permutation(n).astype(np.int32)  # node_order[new] = old
        new_of = np.empty(n, np.int64)
        new_of[node_order] = np.arange(n)
        src = new_of[src]
        dst = new_of[dst]

    src, dst, w, diag, hub_ids, hub_m = split_extras(
        src, dst, w, n, split_diag=split_diag, hub_k=hub_k, max_hub_bytes=max_hub_bytes,
    )

    # dst super-hubs: a node's in-edges from one source block are one run of
    # one bucket; the densest run sets the TPU layout's padding, so sgl_tpu
    # pulls the top in-degree destinations into a column-split dense strip
    hub_in_ids = hub_in_edges = None
    if hub_k not in (0, None) and p > 1 and src.size:
        block0 = _round_up(-(-n // p), TPU_TILE_ROWS)
        in_counts = np.bincount(dst, minlength=n)
        cutoff = max(n // 700, 32)
        k_in = int(np.count_nonzero(in_counts >= cutoff))
        k_in = min(k_in, 4096, max_hub_bytes // max(4 * block0, 1))
        if k_in >= 16:
            hubs_in = np.argpartition(-in_counts, k_in - 1)[:k_in].astype(np.int32)
            row_of = np.full(n, -1, np.int64)
            row_of[hubs_in] = np.arange(k_in)
            m = row_of[dst] >= 0
            hub_in_edges = (row_of[dst[m]], src[m], w[m])
            src, dst, w = src[~m], dst[~m], w[~m]
            hub_in_ids = hubs_in

    block = max(-(-n // p), 1)
    n_pad = block * p
    if diag is not None:
        diag = np.pad(diag, (0, n_pad - n))
    if hub_m is not None:
        hub_m = np.pad(hub_m, ((0, n_pad - n), (0, 0)))
    hub_in_m = None
    if hub_in_edges is not None:
        rows_in, src_in, w_in = hub_in_edges
        k_in = hub_in_ids.shape[0]
        hub_in_m = np.bincount(
            rows_in * n_pad + src_in, weights=w_in, minlength=k_in * n_pad
        ).reshape(k_in, n_pad).astype(np.float32)

    # one stable sort by (owner, source block, local dst) lays every bucket
    # out as a dst-CSR, each row's edges in input order (prepare_csr's order)
    owner = dst.astype(np.int64) // block
    sblk = src.astype(np.int64) // block
    row_key = (owner * p + sblk) * block + (dst - owner * block)
    order = np.argsort(row_key, kind="stable")
    col = torch.from_numpy((src - sblk * block)[order].astype(np.int32))
    val = torch.from_numpy(w[order].astype(np.float32))
    row_counts = np.bincount(row_key, minlength=p * p * block).reshape(p * p, block)
    sizes = row_counts.sum(axis=1)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    buckets = []
    for o in range(p):
        row = []
        for b in range(p):
            i = o * p + b
            rowptr = torch.from_numpy(
                np.concatenate([[0], np.cumsum(row_counts[i])]).astype(np.int32)
            )
            lo, hi = int(offs[i]), int(offs[i + 1])
            row.append(CsrPart(rowptr, col[lo:hi], val[lo:hi], 0, block, block, _make_plan(rowptr)))
        buckets.append(tuple(row))

    def tensor(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a))

    out = DistChunkedAdj(
        tuple(buckets), tensor(diag), tensor(hub_ids), tensor(hub_m), num_nodes=n, block=block,
        order=tensor(node_order), hub_in_ids=tensor(hub_in_ids), hub_in_m=tensor(hub_in_m),
    )
    _report_padding(out, "chunked")
    return out


# -- the ring bodies --------------------------------------------------------------


class _StepTimer:
    """Kernel and transfer time of each ring step, when asked for: the
    kernel by CUDA events (read at :meth:`summary`), or by the host clock on
    the CPU; the transfer by the ring's own host clock."""

    def __init__(self, stats: Optional[dict]):
        self.stats = stats
        self.events = []
        self.kernel_s = []
        self.transfer_s = []

    def kernel(self, fn, device: torch.device):
        if self.stats is None:
            return fn()
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            self.events.append((start, end))
            return out
        t = time.perf_counter()
        out = fn()
        self.kernel_s.append(time.perf_counter() - t)
        return out

    def summary(self, route: str) -> None:
        if self.stats is None:
            return
        if self.events:
            self.events[-1][1].synchronize()
            kernel_ms = [s.elapsed_time(e) for s, e in self.events]
        else:
            kernel_ms = [t * 1e3 for t in self.kernel_s]
        self.stats.setdefault("kernel_ms", []).extend(kernel_ms)
        self.stats.setdefault("transfer_ms", []).extend(t * 1e3 for t in self.transfer_s)
        self.stats["route"] = route


def _rotate(x_local, group, parts: int, p: int, reduce_bucket, timer: _StepTimer) -> str:
    """Hold each source block in turn, ``(p − s) mod P`` at step ``s``:
    post the next block's send/recv, reduce this one, wait.  Returns the
    transfer route."""
    ring = RingExchange(group, x_local) if parts > 1 else None
    buf = x_local
    for s in range(parts):
        b = (p - s) % parts
        last = s == parts - 1
        if not last:
            before = ring.transfer_s
            ring.start(buf)
        timer.kernel(lambda: reduce_bucket(b, buf), x_local.device)
        if not last:
            buf = ring.finish()
            timer.transfer_s.append(ring.transfer_s - before)
    return ring.route if ring is not None else "none (one rank)"


def _ring_spmm_segment(local, x_local, group, parts: int, p: int, timer: _StepTimer) -> torch.Tensor:
    """The segment body: gather, ×w and an f32 row sum per bucket."""
    src_b, dst_b, w_b = local
    y = torch.zeros(x_local.shape, dtype=torch.float32, device=x_local.device)

    def reduce_bucket(b, buf):
        msgs = buf.index_select(0, src_b[b].long()).float() * w_b[b][:, None]
        add_rows_(y, dst_b[b], msgs)

    route = _rotate(x_local, group, parts, p, reduce_bucket, timer)
    timer.summary(route)
    return y.to(x_local.dtype)


def _ring_spmm_chunked(local: _LocalChunked, x_local, group, parts: int, p: int, block: int,
                       timer: _StepTimer) -> torch.Tensor:
    """The chunked body: K3/K4 per bucket into an f32 accumulator, then the
    diag, out-hub and dst-hub terms (``sgl_tpu``'s order of the sums)."""
    y = torch.zeros(x_local.shape, dtype=torch.float32, device=x_local.device)

    def reduce_bucket(b, buf):
        spmm_csr_acc(local.buckets[b], buf, y)

    route = _rotate(x_local, group, parts, p, reduce_bucket, timer)
    timer.summary(route)
    if local.diag is not None:
        y += local.diag[:, None] * x_local.float()
    if local.hub_ids is not None:
        # hub rows skip the ring: one all-reduce of (k, D) a hop
        mine = (local.hub_ids // block) == p
        xh = torch.zeros((local.hub_ids.shape[0], x_local.shape[1]), dtype=torch.float32,
                         device=x_local.device)
        xh[mine] = x_local.index_select(0, local.hub_ids[mine] - p * block).float()
        all_reduce_(xh, group)
        y += local.hub_m @ xh
    if local.hub_in_ids is not None:
        # dst super-hubs: each rank's column block against its own rows
        yh = all_reduce_(local.hub_in_m @ x_local.float(), group)
        mine_in = (local.hub_in_ids // block) == p
        y.index_add_(0, local.hub_in_ids[mine_in] - p * block, yh[mine_in])
    return y.to(x_local.dtype)


def make_dist_spmm(mesh, axis: str = "graph"):
    """``spmm(dadj, x_local, stats=None) -> y_local``: one product over the
    ring of ``mesh``'s ``axis``.  ``x_local`` is this rank's ``(block, D)``
    rows (f32 or bf16) on its device; the result has its dtype.  A
    :class:`DistAdj` runs the segment body, a :class:`DistChunkedAdj` K3/K4
    per bucket.  ``stats`` (a dict) gathers each ring step's ``kernel_ms``
    and ``transfer_ms`` and the ``route`` the blocks took."""
    parts = axis_size(mesh, axis)
    group = mesh.get_group(axis)
    p = mesh.get_local_rank(axis)

    def spmm_dist(dadj, x_local: torch.Tensor, stats: Optional[dict] = None) -> torch.Tensor:
        if dadj.num_partitions != parts:
            raise ValueError(f"layout has {dadj.num_partitions} partitions, the {axis} axis {parts}")
        if x_local.shape[0] != dadj.block:
            raise ValueError(f"x_local must be [{dadj.block}, D], got {tuple(x_local.shape)}")
        timer = _StepTimer(stats)
        local = dadj.local(p, x_local.device)
        if isinstance(dadj, DistChunkedAdj):
            return _ring_spmm_chunked(local, x_local, group, parts, p, dadj.block, timer)
        return _ring_spmm_segment(local, x_local, group, parts, p, timer)

    return spmm_dist


# -- hop stacks ---------------------------------------------------------------------


class ShardedHops:
    """A hop stack kept node-sharded over the ``graph`` axis.

    ``data`` is this rank's share: ``(K+1, block, D)`` (hop-major) or
    ``(block, D')`` after an aggregation, rows ``[p·block, (p+1)·block)``
    of the layout's numbering.  Per-rank memory is ``O(N/P · D · K)``.
    Batch rows come out through :meth:`rows` (each rank contributes the rows
    it owns, one all-reduce assembles the batch); the node shuffle's
    un-permute folds into that lookup through ``new_of``.  Every rank of the
    axis must make the same calls in the same order.
    """

    def __init__(self, data, mesh, axis, block, num_nodes, new_of=None):
        self.data = data
        self.mesh = mesh
        self.axis = axis
        self.block = block
        self.num_nodes = num_nodes
        self.new_of = new_of  # old id -> layout id (None = identity)
        self._group = mesh.get_group(axis)
        self._p = mesh.get_local_rank(axis)

    @property
    def per_device_bytes(self) -> int:
        return self.data.numel() * self.data.element_size()

    def aggregate(self, fn) -> "ShardedHops":
        """Apply a parameter-free hop aggregation (``(K+1, rows, D) ->
        (rows, D')``) to the local share: it reduces over hops, never over
        nodes, so the result stays sharded."""
        return ShardedHops(fn(self.data), self.mesh, self.axis, self.block, self.num_nodes,
                           new_of=self.new_of)

    def _lookup(self, idx) -> torch.Tensor:
        idx = torch.as_tensor(idx, device=self.data.device).long()
        return idx if self.new_of is None else self.new_of[idx]

    def rows(self, idx) -> torch.Tensor:
        """Rows of the old node ids ``idx``: ``(K+1, B, D)`` or ``(B, D')``,
        the same on every rank of the axis."""
        loc = self._lookup(idx) - self._p * self.block
        ok = (loc >= 0) & (loc < self.block)
        ax = self.data.dim() - 2
        rows = self.data.index_select(ax, loc.clamp(0, self.block - 1))
        mask = ok[:, None] if ax == 0 else ok[None, :, None]
        rows = torch.where(mask, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
        return all_reduce_(rows, self._group)

    def map_rows(self, fn, *args) -> torch.Tensor:
        """``fn(local share, *args)``: e.g. the logits of every owned row,
        whose node axis stays sharded (layout numbering)."""
        return fn(self.data, *args)

    def owned(self, idx, values: torch.Tensor):
        """For old ids ``idx``: the mask of those this rank owns and their
        rows of ``values``, a ``(block, ...)`` result of :meth:`map_rows`."""
        loc = self._lookup(idx) - self._p * self.block
        ok = (loc >= 0) & (loc < self.block)
        return ok, values[loc[ok]]

    def gather_full(self) -> torch.Tensor:
        """The replicated, un-permuted stack (``(K+1, N, D)`` or ``(N,
        D')``) on every rank: small graphs and tests only."""
        ax = self.data.dim() - 2
        out = all_gather(self.data, self._group, dim=ax).narrow(ax, 0, self.num_nodes)
        if self.new_of is not None:
            out = out.index_select(ax, self.new_of)
        return out


def _local_rows(x, order, p: int, block: int, device) -> torch.Tensor:
    """Rows ``[p·block, (p+1)·block)`` of the shuffled, padded features, on
    ``device`` (f32, or bf16 as given)."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    lo, hi = min(p * block, n), min((p + 1) * block, n)
    ids = torch.arange(lo, hi) if order is None else order[lo:hi].long()
    rows = pad_features(x.index_select(0, ids.to(x.device)), 1, block)
    return rows.to(device).contiguous()


@torch.no_grad()
def k_hop_propagate_dist(mesh, dadj, x, prop_steps: int, axis: str = "graph",
                         keep_sharded: bool = False, device=None, stats: Optional[dict] = None):
    """Distributed ``[X, AX, ..., A^K X]``; every rank of ``axis`` calls it
    with the same full ``(N, D)`` features (host or device).

    Each rank takes its block of the shuffled, padded rows onto its device
    (:func:`~sgl_tpu_torch.parallel.mesh.rank_device`) and runs ``K`` ring
    products.  Returns the replicated, un-permuted ``(K+1, N, D)`` stack
    (an all-gather over ``axis``), or with ``keep_sharded=True`` a
    :class:`ShardedHops` that never assembles it.  bf16 features ride the
    ring as bf16 (K4); others go to f32 (K3).  ``stats`` as in
    :func:`make_dist_spmm`, for every hop."""
    device = rank_device(device)
    if dadj.num_partitions != axis_size(mesh, axis):
        raise ValueError(f"layout has {dadj.num_partitions} partitions, the {axis} axis {axis_size(mesh, axis)}")
    p = mesh.get_local_rank(axis)
    spmm_dist = make_dist_spmm(mesh, axis)
    order = getattr(dadj, "order", None)
    h = _local_rows(x, order, p, dadj.block, device)
    hops = torch.empty((prop_steps + 1, *h.shape), dtype=h.dtype, device=device)
    hops[0] = h
    for k in range(1, prop_steps + 1):
        h = spmm_dist(dadj, h, stats)
        hops[k] = h
    new_of = None
    if order is not None:
        new_of = torch.empty(dadj.num_nodes, dtype=torch.long, device=device)
        new_of[order.long().to(device)] = torch.arange(dadj.num_nodes, device=device)
    sharded = ShardedHops(hops, mesh, axis, dadj.block, dadj.num_nodes, new_of=new_of)
    return sharded if keep_sharded else sharded.gather_full()


# -- the bucket work of one hop -------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ring_bucket_work_time(dadj: DistChunkedAdj, feat_dim: int = 128, dtype=torch.float32,
                          rounds: int = 3, iters: int = 2, device=None) -> float:
    """Seconds of one hop of bucket work: all ``P²`` buckets' K3/K4 launches
    (``spmm_csr_acc``, f32 or bf16 blocks into f32 accumulators) on one
    device, in one process, with no process group.

    The ring's transfers overlap this work and do not depend on the layout,
    so it is what tells layouts apart (``sgl_tpu``'s ``ring_bucket_work_time``,
    ``spmm_dist.py:68``).  Rows are synthetic (``feat_dim`` wide, from
    seed 0).  On CUDA each hop is timed with events; on the CPU, where it
    runs the plain twin, by the host clock.  The least of ``rounds · iters``
    single hops, each timed alone, after one warm-up hop (``sgl_tpu``'s
    ``rounds`` × ``iters`` protocol, without its slope between chains)."""
    device = rank_device(device)
    p, block = dadj.num_partitions, dadj.block
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((p, block, int(feat_dim))),
                        dtype=dtype).to(device)
    y = torch.zeros((p, block, int(feat_dim)), dtype=torch.float32, device=device)
    work = [(o, b, part) for o in range(p) for b, part in enumerate(dadj.local(o, device).buckets)]

    def hop():
        for o, b, part in work:
            spmm_csr_acc(part, x[b], y[o])

    hop()
    _sync(device)
    best = float("inf")
    for _ in range(rounds * iters):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            hop()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t = time.perf_counter()
            hop()
            best = min(best, time.perf_counter() - t)
    return best
