"""The port's out-of-core SpMM (``sgl_tpu_torch/kernels/spmm_ooc.py``)
against ``sgl_tpu``'s, on the CPU, on the same numpy inputs.

Mirrors ``tests/test_kernels.py:336-907``.  ``sgl_tpu`` runs its Pallas
kernels with ``interpret=True``, as its own tests do; the port runs the
plain path of ``spmm_csr_acc`` (the card is held to the same plain path in
``test_torch_cuda.py`` and ``chip_smoke.py`` phase 10).

Tolerances: port against ``sgl_tpu``'s out-of-core f32 at rtol 1e-4,
atol 1e-5, the bound of its bf16 hi/lo split (the bar of its own tests);
against ``sgl_tpu``'s segment SpMM, a float64 sum and the port's own other
paths at rtol 1e-5, atol 1e-6 (f32 sums of the same terms in other
orders); bf16 within 3e-2 of max|y| against ``sgl_tpu`` (the bar of
``__graft_entry__.dryrun_multichip``) and within three bf16 roundings (3 x
2^-8 of max|y|) of a float64 sum of the same bf16 inputs: a part's f32 sum
rounds once, the host adds of cut rows and of the self-loop term once
each.
"""

import os
import warnings

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sgl_tpu.datasets.synthetic import random_power_law_graph as j_random_power_law_graph
from sgl_tpu.graph import symmetric_normalized_weights as j_sym
from sgl_tpu.kernels import k_hop_out_of_core as j_k_hop_out_of_core
from sgl_tpu.kernels import prepare_out_of_core as j_prepare_out_of_core
from sgl_tpu.kernels import prepare_out_of_core_2d as j_prepare_out_of_core_2d
from sgl_tpu.kernels import spmm as j_spmm
from sgl_tpu.kernels import spmm_out_of_core as j_spmm_out_of_core
from sgl_tpu.kernels import spmm_out_of_core_2d as j_spmm_out_of_core_2d
from sgl_tpu.kernels.pallas_spmm import CHUNK
from sgl_tpu.ops.graph_ops import LaplacianGraphOp as JLaplacianGraphOp
import sgl_tpu_torch.kernels.spmm_ooc as ooc
from sgl_tpu_torch.kernels import (
    PinnedRing,
    SparseAdj,
    auto_src_blocks,
    hop_transfer_bytes,
    k_hop_out_of_core,
    prepare_csr,
    prepare_out_of_core,
    prepare_out_of_core_2d,
    spmm_2d_resident,
    spmm_csr_reference,
    spmm_out_of_core,
    spmm_out_of_core_2d,
)
from sgl_tpu_torch.ops import LaplacianGraphOp
from tests.conftest import random_graph
from tests.test_torch_graph import to_port_graph

CPU = "cpu"
F32 = dict(rtol=1e-5, atol=1e-6)
HILO = dict(rtol=1e-4, atol=1e-5)
BF16_BAR = 3e-2
BF16_ROUNDINGS = 3 * 2.0**-8


def _edges(jadj):
    """The same normalized edges for both packages: host numpy arrays."""
    return (np.asarray(jadj.src), np.asarray(jadj.dst), np.asarray(jadj.w), jadj.num_nodes)


def _f64(edges, x):
    src, dst, w, n = edges
    a = sp.csr_matrix((w.astype(np.float64), (dst, src)), shape=(n, n))
    return a @ np.asarray(x, np.float64)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _graph_700():
    g = random_graph(n=700, avg_deg=10, d=12, seed=17)
    return g, _edges(j_sym(g)), np.asarray(g.x)


def _power_law(n=3_000, deg=4, d=6, seed=17, alpha=1.4):
    g = j_random_power_law_graph(n, deg, d, seed=seed, alpha=alpha, pad_multiple=1024)
    return _edges(j_sym(g)), np.asarray(g.x)


def _bf16(x):
    """The same bf16 values for both packages: a torch bf16 tensor and its
    ml_dtypes twin."""
    xt = torch.as_tensor(x).to(torch.bfloat16)
    return xt, xt.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


# -- 1-D ------------------------------------------------------------------------


@pytest.mark.parametrize("split_diag", [True, False], ids=["diag", "no_diag"])
def test_out_of_core_matches_sgl_tpu(split_diag):
    g, edges, x = _graph_700()
    oc = prepare_out_of_core(edges, max_edges_per_part=2 * CHUNK, split_diag=split_diag)
    assert oc.num_parts > 1, "part size did not force splitting"
    assert (oc.diag is not None) == split_diag
    # every workspace is a strict subset of the feature rows
    assert all(p.cols.shape[0] < g.num_nodes for p in oc.parts)
    got = spmm_out_of_core(oc, x, device=CPU)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == x.shape
    joc = j_prepare_out_of_core(j_sym(g), max_edges_per_part=2 * CHUNK, split_diag=split_diag)
    np.testing.assert_allclose(got, j_spmm_out_of_core(joc, x, interpret=True), **HILO)
    np.testing.assert_allclose(got, np.asarray(j_spmm(j_sym(g), jnp.asarray(x))), **F32)
    np.testing.assert_allclose(got, _f64(edges, x), **F32)


def test_out_of_core_parts_cover_every_edge_once():
    _, edges, _ = _graph_700()
    src, dst, w, n = edges
    oc = prepare_out_of_core(edges, max_edges_per_part=1000, split_diag=False)
    rows, cols, vals = [], [], []
    for p in oc.parts:
        c = ooc._views(torch.from_numpy(np.array(p.csr.packed)), p.csr.counts, p.cols.shape[0], 0)
        rows.append(p.row_offset + np.repeat(np.arange(c.num_rows), np.diff(c.rowptr.numpy())))
        cols.append(p.cols[c.col.numpy()])
        vals.append(c.val.numpy())
        assert np.all(np.diff(p.cols) > 0)  # sorted, unique
    sizes = [p.csr.nnz for p in oc.parts]
    assert max(sizes) - min(sizes) <= 1 and sum(sizes) == int(np.count_nonzero(w))
    keep = w != 0  # the graph's padding edges
    src, dst, w = src[keep], dst[keep], w[keep]
    order = np.argsort(dst, kind="stable")
    np.testing.assert_array_equal(np.concatenate(rows), dst[order])
    np.testing.assert_array_equal(np.concatenate(cols), src[order])
    np.testing.assert_array_equal(np.concatenate(vals), w[order])


def test_out_of_core_k_hop_and_sink():
    g = random_graph(n=500, avg_deg=8, d=8, seed=23)
    x = np.asarray(g.x)
    want = np.asarray(JLaplacianGraphOp(3).propagate(g, g.x, backend="segment"))
    oc = prepare_out_of_core(_edges(j_sym(g)), max_edges_per_part=2 * CHUNK)
    hops = k_hop_out_of_core(oc, x, 3, device=CPU)
    np.testing.assert_allclose(np.stack(hops), want, **F32)
    sunk = {}
    out = k_hop_out_of_core(oc, x, 3, hop_sink=sunk.__setitem__, device=CPU)
    assert out is None and sorted(sunk) == [0, 1, 2, 3]
    np.testing.assert_allclose(np.stack([sunk[k] for k in range(4)]), want, **F32)
    joc = j_prepare_out_of_core(j_sym(g), max_edges_per_part=2 * CHUNK)
    jhops = j_k_hop_out_of_core(joc, x, 3, interpret=True)
    np.testing.assert_allclose(np.stack(hops), np.stack(jhops), **HILO)


def test_out_of_core_bf16():
    g = random_graph(n=400, avg_deg=8, d=8, seed=29)
    edges = _edges(j_sym(g))
    x = np.asarray(g.x)
    xt, xj = _bf16(x)
    oc = prepare_out_of_core(edges, max_edges_per_part=2 * CHUNK)
    assert oc.num_parts > 1
    got = spmm_out_of_core(oc, xt, device=CPU)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
    joc = j_prepare_out_of_core(j_sym(g), max_edges_per_part=2 * CHUNK)
    want = j_spmm_out_of_core(joc, xj, interpret=True)
    assert _rel(got.float(), want.astype(np.float32)) <= BF16_BAR
    assert _rel(got.float(), _f64(edges, xt.float().numpy())) <= BF16_ROUNDINGS


def test_out_of_core_device_edge_cache():
    g = random_graph(n=400, avg_deg=8, d=8, seed=31)
    edges, x = _edges(j_sym(g)), np.asarray(g.x)
    oc = prepare_out_of_core(edges, max_edges_per_part=2 * CHUNK)
    first = spmm_out_of_core(oc, x, device=CPU)  # fills the cache
    assert len(oc._dev_edges) == oc.num_parts
    cached = dict(oc._dev_edges)
    np.testing.assert_array_equal(first, spmm_out_of_core(oc, x, device=CPU))
    assert all(oc._dev_edges[i] is part for i, part in cached.items())  # served from the cache
    oc2 = prepare_out_of_core(edges, max_edges_per_part=2 * CHUNK)
    np.testing.assert_array_equal(first, spmm_out_of_core(oc2, x, device=CPU, max_device_edge_bytes=0))
    assert len(oc2._dev_edges) == 0
    # a budget for the first two parts keeps exactly those
    two = sum(oc.part_edge_nbytes()[:2])
    np.testing.assert_array_equal(first, spmm_out_of_core(oc, x, device=CPU, max_device_edge_bytes=two))
    assert sorted(oc._dev_edges) == [0, 1]
    # a smaller budget on a later call evicts what an earlier call cached
    np.testing.assert_array_equal(first, spmm_out_of_core(oc, x, device=CPU, max_device_edge_bytes=0))
    assert len(oc._dev_edges) == 0


def test_out_of_core_null_transfer_mode():
    g = random_graph(n=400, avg_deg=8, d=8, seed=31)
    edges, x = _edges(j_sym(g)), np.asarray(g.x)
    oc = prepare_out_of_core(edges, max_edges_per_part=2 * CHUNK)
    assert oc.num_parts > 1
    spmm_out_of_core(oc, x, device=CPU, null_transfer=True)
    assert len(oc._dev_ws) == 1  # one shared workspace, not one a part
    ws = next(iter(oc._dev_ws.values()))
    assert ws.shape[0] == max(oc.workspace_rows)
    spmm_out_of_core(oc, x, device=CPU, null_transfer=True)
    assert next(iter(oc._dev_ws.values())) is ws
    np.testing.assert_allclose(spmm_out_of_core(oc, x, device=CPU), _f64(edges, x), **F32)


def test_out_of_core_into_given_out_and_refuses_bad_input():
    _, edges, x = _graph_700()
    oc = prepare_out_of_core(edges, max_edges_per_part=2 * CHUNK)
    out = np.full(x.shape, 7.0, np.float32)  # zeroed before the sum
    assert spmm_out_of_core(oc, x, out=out, device=CPU) is out
    np.testing.assert_allclose(out, _f64(edges, x), **F32)
    with pytest.raises(ValueError):
        spmm_out_of_core(oc, x[:-1], device=CPU)
    with pytest.raises(TypeError):
        spmm_out_of_core(oc, x.astype(np.float64), device=CPU)
    with pytest.raises(ValueError):
        spmm_out_of_core(oc, x, out=np.zeros((3, 3), np.float32), device=CPU)


# -- 2-D ------------------------------------------------------------------------


@pytest.mark.parametrize("src_blocks,part_edges", [(1, 8 * 128), (4, 4 * 128), (8, 2 * 128)])
def test_out_of_core_2d_matches_sgl_tpu_and_1d(src_blocks, part_edges):
    edges, x = _power_law()
    oc = prepare_out_of_core_2d(edges, max_edges_per_part=part_edges, src_blocks=src_blocks, feat_dim=6)
    assert oc.num_blocks == src_blocks and oc.num_parts > 1
    if src_blocks > 1:
        # cells that leave rows of their part untouched (the port's analog of
        # the TPU path's masked tiles): those rows must keep the accumulator
        untouched = [
            bool(np.any(np.diff(np.asarray(c.packed[4:4 + c.num_rows + 1])) == 0))
            for row in oc.parts for c in row if c.nnz
        ]
        assert any(untouched), "no cell leaves a row untouched"
    group = 2  # accumulators of two parts at a time: several groups
    got = spmm_out_of_core_2d(oc, x, device=CPU, max_device_acc_bytes=oc.n_rows * 6 * 4 * group)
    assert oc.num_parts > group
    assert got.dtype == np.float32 and np.isfinite(got).all()
    joc = j_prepare_out_of_core_2d(edges, max_edges_per_part=part_edges, src_blocks=src_blocks,
                                   chunk=128, tile_rows=128)
    want = j_spmm_out_of_core_2d(joc, x, interpret=True, max_device_acc_bytes=joc.n_rows * 6 * 4 * 2)
    np.testing.assert_allclose(got, want, **HILO)
    one_d = spmm_out_of_core(prepare_out_of_core(edges, max_edges_per_part=part_edges), x, device=CPU)
    np.testing.assert_allclose(got, one_d, **F32)
    np.testing.assert_allclose(got, _f64(edges, x), **F32)
    # every group sends each block a cell of it reads, once
    h2d, d2h = hop_transfer_bytes(oc, 6, 4, max_device_acc_bytes=oc.n_rows * 6 * 4 * group)
    assert d2h == x.nbytes and h2d >= x.nbytes * (1 if src_blocks == 1 else 0)


def test_out_of_core_2d_cells_are_block_relative_csrs():
    edges, _ = _power_law()
    src, dst, w, n = edges
    oc = prepare_out_of_core_2d(edges, max_edges_per_part=4 * 128, src_blocks=4, split_diag=False)
    sb = oc.block_rows
    assert sb == -(-n // 4) and oc.row_offsets[0] == 0
    assert oc.row_offsets[-1] + oc.valid_rows[-1] == n
    got = []
    for p, row in enumerate(oc.parts):
        for b, cell in enumerate(row):
            if not cell.nnz:
                continue
            c = ooc._views(torch.from_numpy(np.array(cell.packed)), cell.counts, oc.block_range(b)[1], 0)
            assert c.num_rows == oc.valid_rows[p]
            r = oc.row_offsets[p] + np.repeat(np.arange(c.num_rows), np.diff(c.rowptr.numpy()))
            assert np.all(np.diff(r) >= 0)  # dst order inside the cell
            s = c.col.numpy() + b * sb
            assert np.all((s >= b * sb) & (s < (b + 1) * sb))
            got.append(np.stack([r, s, c.val.numpy().view(np.int32)]))
    got = np.concatenate(got, axis=1)
    keep = w != 0
    want = np.stack([dst[keep], src[keep], w[keep].view(np.int32)])
    key = lambda a: np.lexsort(a[::-1])  # noqa: E731
    np.testing.assert_array_equal(got[:, key(got)], want[:, key(want)])


def test_out_of_core_2d_unsorted_input():
    g = random_graph(n=500, avg_deg=7, d=6, seed=13)
    src, dst, w, n = _edges(j_sym(g))
    x = np.asarray(g.x)
    a = spmm_out_of_core_2d(prepare_out_of_core_2d((src, dst, w, n), 512, 3), x, device=CPU)
    perm = np.random.default_rng(0).permutation(src.shape[0])
    shuf = (src[perm], dst[perm], w[perm], n)
    b = spmm_out_of_core_2d(prepare_out_of_core_2d(shuf, 512, 3), x, device=CPU)
    np.testing.assert_allclose(a, b, **F32)
    np.testing.assert_allclose(a, _f64((src, dst, w, n), x), **F32)
    c = spmm_out_of_core(prepare_out_of_core(shuf, 512), x, device=CPU)
    np.testing.assert_allclose(c, a, **F32)


def test_out_of_core_2d_bf16_and_no_diag():
    g = j_random_power_law_graph(2_000, 5, 8, seed=3, pad_multiple=1024)
    edges, x = _edges(j_sym(g)), np.asarray(g.x)
    oc = prepare_out_of_core_2d(edges, max_edges_per_part=512, src_blocks=4, split_diag=False)
    assert oc.diag is None
    want = spmm_out_of_core_2d(oc, x, device=CPU)
    np.testing.assert_allclose(want, _f64(edges, x), **F32)
    xt, xj = _bf16(x)
    got = spmm_out_of_core_2d(oc, xt, device=CPU)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), _f64(edges, xt.float().numpy())) <= BF16_ROUNDINGS
    joc = j_prepare_out_of_core_2d(edges, max_edges_per_part=512, src_blocks=4, split_diag=False, chunk=128)
    assert _rel(got.float(), j_spmm_out_of_core_2d(joc, xj, interpret=True).astype(np.float32)) <= BF16_BAR


def test_out_of_core_2d_edge_cache_budget():
    g = random_graph(n=600, avg_deg=8, d=6, seed=19)
    edges, x = _edges(j_sym(g)), np.asarray(g.x)
    oc = prepare_out_of_core_2d(edges, max_edges_per_part=512, src_blocks=3)
    first = spmm_out_of_core_2d(oc, x, device=CPU)
    assert len(oc._dev_edges) == oc.num_cells
    cached = dict(oc._dev_edges)
    np.testing.assert_array_equal(first, spmm_out_of_core_2d(oc, x, device=CPU))
    assert all(oc._dev_edges[k] is part for k, part in cached.items())  # served from the cache
    second = spmm_out_of_core_2d(oc, x, device=CPU, max_device_edge_bytes=0)
    assert len(oc._dev_edges) == 0
    np.testing.assert_array_equal(first, second)
    some = oc.subpart_edge_nbytes() // 2
    np.testing.assert_array_equal(first, spmm_out_of_core_2d(oc, x, device=CPU, max_device_edge_bytes=some))
    held = sum(oc.parts[p][b].nbytes for p, b in oc._dev_edges)
    assert 0 < held <= some and len(oc._dev_edges) < oc.num_cells


def test_out_of_core_2d_null_transfer_mode():
    edges, x = _power_law()
    oc = prepare_out_of_core_2d(edges, max_edges_per_part=4 * 128, src_blocks=4)
    spmm_out_of_core_2d(oc, x, device=CPU, null_transfer=True)
    assert len(oc._dev_ws) == 1  # one shared block, not one a block
    ws = next(iter(oc._dev_ws.values()))
    spmm_out_of_core_2d(oc, x, device=CPU, null_transfer=True)
    assert next(iter(oc._dev_ws.values())) is ws
    np.testing.assert_allclose(spmm_out_of_core_2d(oc, x, device=CPU), _f64(edges, x), **F32)


def test_out_of_core_2d_layout_cache(tmp_path):
    """Content-keyed on-disk cache: the second build loads the saved
    layout (read-only memmaps, the same arrays, the same product, no
    warning); a changed configuration misses."""
    g = j_random_power_law_graph(2_000, 4, 6, seed=5, alpha=1.3, pad_multiple=1024)
    edges, x = _edges(j_sym(g)), np.asarray(g.x)
    cd = str(tmp_path)
    oc1 = prepare_out_of_core_2d(edges, max_edges_per_part=4 * 128, src_blocks=4, cache_dir=cd)
    files = os.listdir(cd)
    assert len(files) == 1 and files[0].startswith("sglt_ooc2d_")
    oc2 = prepare_out_of_core_2d(edges, max_edges_per_part=4 * 128, src_blocks=4, cache_dir=cd)
    assert os.listdir(cd) == files  # a hit: no second entry
    assert (oc2.num_nodes, oc2.block_rows, oc2.num_blocks) == (oc1.num_nodes, oc1.block_rows, oc1.num_blocks)
    assert (oc2.row_offsets, oc2.valid_rows) == (oc1.row_offsets, oc1.valid_rows)
    np.testing.assert_array_equal(oc2.diag, oc1.diag)
    for r1, r2 in zip(oc1.parts, oc2.parts):
        for s1, s2 in zip(r1, r2):
            assert isinstance(s2.packed, np.memmap) and not s2.packed.flags.writeable
            np.testing.assert_array_equal(s1.packed, s2.packed)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # torch warns on a non-writable array
        got = spmm_out_of_core_2d(oc2, x, device=CPU)
        np.testing.assert_array_equal(got, spmm_out_of_core_2d(oc1, x, device=CPU))
        np.testing.assert_array_equal(spmm_2d_resident(oc2, torch.as_tensor(x)).numpy(),
                                      spmm_2d_resident(oc1, torch.as_tensor(x)).numpy())
    # another configuration or graph: another key
    prepare_out_of_core_2d(edges, max_edges_per_part=8 * 128, src_blocks=4, cache_dir=cd)
    assert len(os.listdir(cd)) == 2
    src, dst, w, n = edges
    prepare_out_of_core_2d((src, dst, w * 2, n), max_edges_per_part=4 * 128, src_blocks=4, cache_dir=cd)
    assert len(os.listdir(cd)) == 3


def test_out_of_core_2d_strict_guard_runs_on_cache_hit(tmp_path, monkeypatch):
    g = j_random_power_law_graph(2_000, 4, 6, seed=5, alpha=1.3, pad_multiple=1024)
    edges = _edges(j_sym(g))
    cd = str(tmp_path)
    monkeypatch.setattr(ooc, "_CELL_BYTE_BUDGET", 64)  # every cell trips it
    with pytest.warns(UserWarning, match="densest cell"):
        prepare_out_of_core_2d(edges, max_edges_per_part=4 * 128, src_blocks=4, cache_dir=cd)
    assert len(os.listdir(cd)) == 1  # the layout itself was cached
    with pytest.raises(ValueError, match="densest cell"):
        prepare_out_of_core_2d(edges, max_edges_per_part=4 * 128, src_blocks=4, cache_dir=cd, strict=True)
    with pytest.raises(ValueError, match="densest cell"):  # and on a cold build
        prepare_out_of_core_2d(edges, max_edges_per_part=4 * 128, src_blocks=4, strict=True)


def test_auto_src_blocks():
    # products scale (2.4M x 100, ~62.4M nonzeros): 960 MB f32 in 4 blocks
    # of <= 256 MiB, 480 MB bf16 in 2
    assert auto_src_blocks(2_400_000, 62_400_000, 100, torch.float32) == 4
    assert auto_src_blocks(2_400_000, 62_400_000, 100, torch.bfloat16) == 2
    assert auto_src_blocks(2_400_000, 62_400_000, 100, np.float32) == 4
    # papers100M: 57 GB of f32 features, capped at the mean degree (14)
    assert auto_src_blocks(111_059_956, 1_615_685_872, 128, torch.float32) == 14
    edges, x = _power_law()
    oc = prepare_out_of_core_2d(edges, max_edges_per_part=4 * 128)
    assert oc.num_blocks == 1  # 3k rows are far under the budget
    np.testing.assert_allclose(spmm_out_of_core_2d(oc, x, device=CPU), _f64(edges, x), **F32)


# -- the resident executor ------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_spmm_2d_resident_matches_one_shot(dtype):
    edges, x = _power_law()
    src, dst, w, n = edges
    oc = prepare_out_of_core_2d(edges, max_edges_per_part=4 * 128, src_blocks=4)
    assert oc.diag is not None and oc.num_blocks == 4
    xt = torch.as_tensor(x).to(dtype)
    got = spmm_2d_resident(oc, xt)
    assert got.dtype == dtype and got.shape == xt.shape
    csr = prepare_csr(SparseAdj(*(torch.as_tensor(np.array(a)) for a in (src, dst, w)), n))
    one_shot = spmm_csr_reference(csr, xt)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), one_shot.numpy(), **F32)
        np.testing.assert_allclose(got.numpy(), _f64(edges, x), **F32)
    else:
        # both round an f32 sum once (the resident one after the diag add)
        assert _rel(got.float(), one_shot.float()) <= 2 * 2.0**-8
    # the second call reuses the cached cells: the same bits
    assert torch.equal(spmm_2d_resident(oc, xt), got)
    with pytest.raises(ValueError):
        spmm_2d_resident(oc, xt[:-1])


# -- the graph op ---------------------------------------------------------------


def test_graph_op_propagate_out_of_core_matches_sgl_tpu():
    g = random_graph(n=400, avg_deg=8, d=8, seed=37)
    pg, x = to_port_graph(g), np.asarray(g.x)
    jop, op = JLaplacianGraphOp(2), LaplacianGraphOp(2)
    want = np.stack(jop.propagate_out_of_core(g, x, interpret=True))
    got = op.propagate_out_of_core(pg, x, device=CPU)
    np.testing.assert_allclose(np.stack(got), want, **HILO)
    in_memory = LaplacianGraphOp(2).propagate(pg, x, device=CPU).numpy()
    np.testing.assert_allclose(np.stack(got), in_memory, **F32)
    oc_first = op._adj_cache[2]
    op.propagate_out_of_core(pg, x, device=CPU)
    assert op._adj_cache[2] is oc_first  # cached per graph
    got2 = op.propagate_out_of_core(pg, x, layout="2d", src_blocks=3, device=CPU)
    want2 = np.stack(jop.propagate_out_of_core(g, x, interpret=True, layout="2d", src_blocks=3))
    np.testing.assert_allclose(np.stack(got2), want2, **HILO)
    assert op._adj_cache[2] is not oc_first and op._adj_cache[2].num_blocks == 3
    with pytest.raises(ValueError):
        op.propagate_out_of_core(pg, x, layout="3d", device=CPU)


def test_propagate_out_of_core_rebuilds_on_new_features():
    """The layout is cached under the features' width and dtype (the
    2-D auto block sizing depends on them): a hit for the same features,
    a rebuild for another dtype or width."""
    g = j_random_power_law_graph(2_000, 4, 6, seed=3, alpha=1.3, pad_multiple=512)
    pg, x32 = to_port_graph(g), np.asarray(g.x, np.float32)
    op = LaplacianGraphOp(1)
    kw = dict(max_edges_per_part=4 * 128, layout="2d", device=CPU)
    op.propagate_out_of_core(pg, x32, **kw)
    oc_a = op._adj_cache[2]
    op.propagate_out_of_core(pg, x32, **kw)
    assert op._adj_cache[2] is oc_a
    hops = op.propagate_out_of_core(pg, torch.as_tensor(x32).to(torch.bfloat16), **kw)
    assert op._adj_cache[2] is not oc_a and hops[1].dtype == torch.bfloat16
    oc_b = op._adj_cache[2]
    op.propagate_out_of_core(pg, np.ascontiguousarray(x32[:, :4]), **kw)
    assert op._adj_cache[2] is not oc_b


# -- no fallback without a card -------------------------------------------------


def test_entry_points_refuse_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    edges, x = _power_law()
    oc1 = prepare_out_of_core(edges, max_edges_per_part=4 * 128)
    oc2 = prepare_out_of_core_2d(edges, max_edges_per_part=4 * 128)
    for call in (
        lambda: spmm_out_of_core(oc1, x),
        lambda: spmm_out_of_core_2d(oc2, x),
        lambda: k_hop_out_of_core(oc2, x, 2),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # pinning needs CUDA: it raises, never hands out pageable memory
    with pytest.raises(RuntimeError):
        PinnedRing().take((4, 4), torch.float32)


@pytest.mark.parametrize("layout", ["1d", "2d"])
def test_products_demo_ooc_matches_in_memory(layout):
    """The products demo's ``--ooc`` mode at a small size: host hops equal
    the demo's in-memory streaming hops (two f32 orders, of max|hop|)."""
    from sgl_tpu_torch.examples import products_scale_demo

    small = dict(n=3000, avg_deg=10, d=16, hops=3, part_edges=2048, device=CPU)
    got = products_scale_demo.main(**small, ooc=True, layout=layout)
    want = products_scale_demo.main(**small)["hops"]
    assert len(got["hops"]) == 4 and len(got["hop_seconds"]) == 3
    assert got["layout"].num_parts > 1 and got["nnz"] == int(np.count_nonzero(got["graph"].val)) + 3000
    for k in range(4):
        assert _rel(got["hops"][k], want[k].numpy()) <= 1e-5
