"""The CSR kernel's launch plan on the CPU: the column panels' width
(``panel_columns``) at the shapes the port runs, and the plan's list of
rows neither empty nor long, through every place that builds or rebuilds
a plan (``prepare_csr``, ``transpose_csr``, ``prepare_csr_parts``, the
out-of-core packing and its cache, the ring's buckets).  The kernel itself
is held on the card in ``test_torch_cuda.py``; its twin against
``sgl_tpu`` in ``test_torch_spmm.py``, ``test_torch_ooc.py`` and
``test_torch_distributed.py``."""

import numpy as np
import pytest
import torch

from sgl_tpu_torch.datasets import random_power_law_graph
from sgl_tpu_torch.graph import symmetric_normalized_weights, symmetric_normalized_weights_host
from sgl_tpu_torch.kernels import prepare_csr, prepare_csr_parts, prepare_out_of_core, prepare_out_of_core_2d
from sgl_tpu_torch.kernels import spmm_ooc as ooc
from sgl_tpu_torch.kernels.spmm_csr import (
    L2_BUDGET, LIST_MAX_NNZ, PANEL_BYTES, SPLIT_NNZ, _make_plan, launch_panel, panel_columns, signatures,
    transpose_csr,
)
from sgl_tpu_torch.parallel import partition_adj_chunked

CPU = torch.device("cpu")


# -- the column panels -----------------------------------------------------------


@pytest.mark.parametrize("n, d, elem, want", [
    (232_965, 602, 4, 64),  # Reddit f32: x 561 MB, a 64-column panel 59.6 MB
    (232_965, 602, 2, 64),  # Reddit bf16: 32 packets of two columns (602 % 4 = 2)
    (89_250, 500, 4, 64),  # Flickr f32: a 64-column panel 22.8 MB
    (89_250, 500, 2, 128),
    (200_000, 128, 4, 64),  # the SpMM bench shape: x 102 MB, a panel 51.2 MB
    (200_000, 128, 2, 128),  # bf16: x 51.2 MB fits, no panels
    (100_000, 128, 4, 128),  # the main path's hops: x 51.2 MB fits
    (600_000, 100, 4, 100),  # a ring bucket's x block at products scale, P = 4: a panel 154 MB
    (600_000, 100, 2, 100),
    (2_449_029, 100, 4, 100),  # products: a panel 627 MB
    (2_449_029, 100, 2, 100),
    (1_248_000, 128, 4, 128),  # the NARS batch (a panel 319 MB)
    (5_000, 128, 4, 128),  # a small graph: x fits
], ids=["reddit-f32", "reddit-bf16", "flickr-f32", "flickr-bf16", "bench-f32", "bench-bf16", "main-path",
        "ring-block-f32", "ring-block-bf16", "products-f32", "products-bf16", "nars-batch", "small"])
def test_panel_columns_at_the_ports_shapes(n, d, elem, want):
    assert panel_columns(n, d, elem) == want


@pytest.mark.parametrize("seed", range(4))
def test_panel_columns_rule(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        # N up to four times the rows whose panel of PANEL_BYTES fills the budget
        n = int(rng.integers(1, 4 * L2_BUDGET // PANEL_BYTES))
        d, elem = int(rng.integers(1, 2_000)), int(rng.choice([2, 4]))
        cols = panel_columns(n, d, elem)
        packet = next(v for v in (4, 2, 1) if d % v == 0)
        # PANEL_BYTES a row, at most 32 packets: one warp's pass
        width = min(PANEL_BYTES // elem, 32 * packet)
        if n * d * elem <= L2_BUDGET or width >= d or n * width * elem > L2_BUDGET:
            assert cols == d  # x fits, a row fits a panel, or a panel does not fit
        else:
            assert cols == width and cols % packet == 0 and n * cols * elem <= L2_BUDGET < n * d * elem


def test_launch_panel_only_for_the_one_shot_forms():
    x = torch.zeros((232_965, 602), dtype=torch.float32)
    assert launch_panel("f32", x) == 64 and launch_panel("bf16", x.to(torch.bfloat16)) == 64
    assert launch_panel("acc_f32", x) == 602 and launch_panel("acc_bf16", x.to(torch.bfloat16)) == 602
    assert 50 * 10**6 <= L2_BUDGET < 100 * 10**6  # about the card's 50 MB L2


def test_entry_points_take_the_listed_rows_and_the_panel():
    # 11 pointers (the plan's listed rows among them), the ints, the stream
    sigs = signatures()
    assert {len(s) for fn, s in sigs.items() if "_acc_" in fn} == {11 + 7 + 1}
    assert {len(s) for fn, s in sigs.items() if "_acc_" not in fn} == {11 + 6 + 1}


# -- the plan's listed rows ----------------------------------------------------


def _listed(rowptr) -> torch.Tensor:
    """The rows neither empty nor long, where the non-empty rows hold at
    most LIST_MAX_NNZ nonzeros on average; else none."""
    lengths = torch.diff(rowptr.long())
    rows = torch.nonzero((lengths > 0) & (lengths <= SPLIT_NNZ)).flatten()
    short = int(rowptr[-1] - rowptr[0]) <= LIST_MAX_NNZ * int((lengths > 0).sum())
    return rows if short else rows[:0]


def _check(plan, rowptr) -> None:
    assert plan.rows.dtype == torch.int32 and plan.rows.is_contiguous()
    assert torch.equal(plan.rows.long(), _listed(rowptr))
    assert plan.num_listed == plan.rows.shape[0]


@pytest.mark.parametrize("mean, listed", [(2, True), (LIST_MAX_NNZ, True), (LIST_MAX_NNZ + 1, False), (26, False)])
def test_plan_lists_its_rows_where_they_are_short_on_average(mean, listed):
    # a ring bucket's ~2 nonzeros a row are listed; the out-of-core cells'
    # ~13 and a products part's ~26 walk every row
    lengths = np.full(1_000, mean)
    lengths[::2] = 0  # half the rows empty: the non-empty ones hold `mean`
    rowptr = torch.as_tensor(np.concatenate([[0], np.cumsum(lengths)]), dtype=torch.int32)
    plan = _make_plan(rowptr)
    _check(plan, rowptr)
    assert (plan.num_listed > 0) == listed
    # forced either way
    assert _make_plan(rowptr, listed=True).num_listed == 500 and _make_plan(rowptr, listed=False).num_listed == 0


def _ring_like_rowptr(n=5_000, seed=0) -> torch.Tensor:
    """Rows of 0 to 3 nonzeros (a ring bucket's), a few long ones."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 4, n)
    lengths[[10, 20]] = [SPLIT_NNZ + 1, 3 * SPLIT_NNZ]
    return torch.as_tensor(np.concatenate([[0], np.cumsum(lengths)]), dtype=torch.int32)


@pytest.mark.parametrize("seed", range(3))
def test_plan_lists_exactly_the_rows_neither_empty_nor_long(seed):
    rowptr = _ring_like_rowptr(seed=seed)
    plan = _make_plan(rowptr)
    _check(plan, rowptr)
    lengths = torch.diff(rowptr.long())
    # every row is listed, long or empty, exactly once
    assert plan.num_listed + plan.num_long + int((lengths == 0).sum()) == rowptr.shape[0] - 1


def test_prepare_csr_transpose_and_parts_list_their_rows():
    g = random_power_law_graph(3_000, 6, 8, seed=2)
    adj = prepare_csr(symmetric_normalized_weights(g, device=CPU))
    _check(adj.plan, adj.rowptr)
    t = transpose_csr(adj)
    _check(t.plan, t.rowptr)
    for part in prepare_csr_parts(adj, adj.nnz // 5):
        _check(part.plan, part.rowptr)


def test_ooc_packing_keeps_the_listed_rows():
    rowptr = _ring_like_rowptr(seed=3)
    e = int(rowptr[-1])
    rng = np.random.default_rng(0)
    sub = ooc._pack(rowptr.numpy(), rng.integers(0, 100, e).astype(np.int32), rng.random(e).astype(np.float32))
    plan = _make_plan(rowptr)
    assert sub.counts == (rowptr.shape[0] - 1, e, plan.num_segments, plan.num_long, plan.num_listed)
    part = ooc._views(torch.from_numpy(np.array(sub.packed)), sub.counts, 100, 0)
    _check(part.plan, part.rowptr)
    for name in ("seg_beg", "seg_end", "seg_ptr", "long_rows", "rows"):
        assert torch.equal(getattr(part.plan, name), getattr(plan, name)), name


@pytest.mark.parametrize("blocks", [1, 3])
def test_ooc_layouts_and_their_cache_keep_the_listed_rows(tmp_path, blocks):
    g = random_power_law_graph(3_000, 8, 16, seed=0)
    adj = symmetric_normalized_weights_host(g)
    oc = prepare_out_of_core_2d(adj, 4_000, blocks, feat_dim=16, cache_dir=str(tmp_path))
    # the second build loads the layout the first one cached
    cached = prepare_out_of_core_2d(adj, 4_000, blocks, feat_dim=16, cache_dir=str(tmp_path))
    for layout in (oc, cached):
        for p, row in enumerate(layout.parts):
            for b, cell in enumerate(row):
                part = ooc._views(torch.from_numpy(np.array(cell.packed)), cell.counts,
                                  layout.block_range(b)[1], 0)
                _check(part.plan, part.rowptr)
    one_d = prepare_out_of_core((adj.src.numpy(), adj.dst.numpy(), adj.w.numpy(), adj.num_nodes),
                                max_edges_per_part=4_000)
    for p in one_d.parts:
        part = ooc._views(torch.from_numpy(np.array(p.csr.packed)), p.csr.counts, p.cols.shape[0], 0)
        _check(part.plan, part.rowptr)


def test_ring_buckets_list_their_rows():
    g = random_power_law_graph(4_000, 8, 8, seed=1)
    dadj = partition_adj_chunked(symmetric_normalized_weights(g, device=CPU), 4)
    empty = rows = 0
    for o, bucket_row in enumerate(dadj.buckets):
        for part in bucket_row:
            _check(part.plan, part.rowptr)
        # the buckets each owner moves to its device carry a plan of their own
        for part in dadj.local(o, CPU).buckets:
            _check(part.plan, part.rowptr)
            empty += int((torch.diff(part.rowptr) == 0).sum())
            rows += part.num_rows
    assert 0 < empty < rows  # the row tasks the list drops
