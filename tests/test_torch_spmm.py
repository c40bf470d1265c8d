"""SpMM and k-hop propagation of the PyTorch port against ``sgl_tpu``, on
the CPU (the plain versions; the CUDA kernel is held against the same plain
versions on the card in ``test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_tpu.graph import Graph as JGraph
from sgl_tpu.graph import symmetric_normalized_weights as j_sym
from sgl_tpu.graph import to_undirected as j_to_undirected
from sgl_tpu.kernels import prepare_chunked, spmm_pallas
from sgl_tpu.kernels.sparse import spmm as j_spmm
from sgl_tpu.kernels.sparse import spmm_segment as j_spmm_segment
from sgl_tpu.ops.graph_ops import k_hop_aggregate as j_k_hop_aggregate
from sgl_tpu.ops.graph_ops import k_hop_propagate as j_k_hop_propagate
from sgl_tpu_torch.dev.tune_spmm_csr import SOURCE as TUNE_SOURCE
from sgl_tpu_torch.dev.tune_spmm_csr import VARIANTS, source_constants, variant_source
from sgl_tpu_torch.dev.tune_spmm_csr import main as tune_main
from sgl_tpu_torch.graph import symmetric_normalized_weights
from sgl_tpu_torch.kernels import CsrAdj, SparseAdj, prepare_csr, spmm, spmm_csr, spmm_csr_reference, spmm_segment
from sgl_tpu_torch.kernels.spmm_csr import LIST_MAX_NNZ, SPLIT_NNZ, _make_plan
from sgl_tpu_torch.ops import LaplacianGraphOp, k_hop_aggregate, k_hop_propagate
from tests.conftest import random_graph
from tests.test_torch_graph import to_port_graph

CPU = torch.device("cpu")
PROP_STEPS = 3
HOP_WEIGHTS = np.array([0.1, 0.2, 0.3, 0.4], np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _graphs(n=300, seed=0, weighted=False, d=16):
    jg = random_graph(n=n, seed=seed, weighted=weighted, d=d)
    return jg, to_port_graph(jg)


@pytest.mark.parametrize("layout", ["coo", "csr"])
@pytest.mark.parametrize("weighted", [False, True])
def test_spmm_f32_matches_segment(layout, weighted):
    jg, g = _graphs(seed=2, weighted=weighted)
    adj = symmetric_normalized_weights(g, device=CPU)
    if layout == "csr":
        adj = prepare_csr(adj)
    got = spmm(adj, torch.as_tensor(g.x))
    want = j_spmm_segment(j_sym(jg), jnp.asarray(jg.x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_spmm_bf16_matches_pallas_kernel_semantics():
    # the TPU kernel's own bf16 path (one bf16 message pass, f32 sum), run in
    # interpret mode as tests/test_kernels.py runs it
    jg = random_graph(n=500, avg_deg=14, d=24, seed=23)
    want = spmm_pallas(prepare_chunked(j_sym(jg)), jnp.asarray(jg.x, jnp.bfloat16), interpret=True)
    g = to_port_graph(jg)
    got = spmm_csr(
        prepare_csr(symmetric_normalized_weights(g, device=CPU)),
        torch.as_tensor(g.x).to(torch.bfloat16),
    )
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) <= 2e-2


def test_spmm_csr_cpu_runs_the_plain_version_without_counting():
    _, g = _graphs(n=64, seed=1)
    adj = prepare_csr(symmetric_normalized_weights(g, device=CPU))
    before = dict(spmm_csr.launches)
    spmm_csr(adj, torch.as_tensor(g.x))
    assert spmm_csr.launches == before


def test_spmm_empty_rows_are_zero():
    src = torch.tensor([0, 1, 3], dtype=torch.int32)
    dst = torch.tensor([1, 0, 1], dtype=torch.int32)
    w = torch.tensor([0.5, 2.0, 1.0])
    x = torch.randn(4, 3)
    y = spmm(prepare_csr(SparseAdj(src, dst, w, 4)), x)
    want = torch.zeros_like(x)
    want[1] = 0.5 * x[0] + x[3]
    want[0] = 2.0 * x[1]
    torch.testing.assert_close(y, want)


def test_k_hop_propagate_f32_matches():
    jg, g = _graphs(seed=4)
    got = k_hop_propagate(
        prepare_csr(symmetric_normalized_weights(g, device=CPU)), torch.as_tensor(g.x), PROP_STEPS
    )
    want = j_k_hop_propagate(j_sym(jg), jnp.asarray(jg.x), PROP_STEPS, backend="segment")
    assert got.shape == (PROP_STEPS + 1, g.num_nodes, g.num_features)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_k_hop_aggregate_f32_matches():
    jg, g = _graphs(seed=6)
    got = k_hop_aggregate(
        prepare_csr(symmetric_normalized_weights(g, device=CPU)),
        torch.as_tensor(g.x), HOP_WEIGHTS, PROP_STEPS,
    )
    want = j_k_hop_aggregate(
        j_sym(jg), jnp.asarray(jg.x), jnp.asarray(HOP_WEIGHTS), PROP_STEPS, backend="segment"
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _pallas_bf16_hops(jg):
    """Hop-by-hop bf16 propagation through the TPU kernel in interpret mode
    (``sgl_tpu.ops.k_hop_propagate`` reaches Pallas without ``interpret``)."""
    ch = prepare_chunked(j_sym(jg))
    h = jnp.asarray(jg.x, jnp.bfloat16)
    hops = [h]
    for _ in range(PROP_STEPS):
        h = spmm_pallas(ch, h, interpret=True)
        hops.append(h)
    return [np.asarray(a, np.float32) for a in hops]


def test_k_hop_bf16_matches_pallas_kernel_semantics():
    jg = random_graph(n=400, avg_deg=10, d=24, seed=8)
    g = to_port_graph(jg)
    adj = prepare_csr(symmetric_normalized_weights(g, device=CPU))
    x16 = torch.as_tensor(g.x).to(torch.bfloat16)
    want = _pallas_bf16_hops(jg)
    hops = k_hop_propagate(adj, x16, PROP_STEPS)
    assert hops.dtype == torch.bfloat16
    for k in range(PROP_STEPS + 1):
        assert _rel(hops[k].float().numpy(), want[k]) < 3e-2, k
    agg = k_hop_aggregate(adj, x16, HOP_WEIGHTS, PROP_STEPS)
    assert agg.dtype == torch.bfloat16
    want_agg = sum(w * h for w, h in zip(HOP_WEIGHTS, want))
    assert _rel(agg.float().numpy(), want_agg) < 3e-2


def test_graph_op_caches_layout_per_graph_and_device():
    _, g = _graphs(n=80, seed=21)
    op = LaplacianGraphOp(2)
    a1 = op._adj_for(g, CPU)
    assert op._adj_for(g, CPU) is a1
    _, g2 = _graphs(n=80, seed=22)
    assert op._adj_for(g2, CPU) is not a1


def test_graph_op_propagate_matches_and_checks_shapes():
    jg, g = _graphs(seed=9)
    op = LaplacianGraphOp(PROP_STEPS)
    got = op.propagate(g, g.x, device="cpu")
    want = j_k_hop_propagate(j_sym(jg), jnp.asarray(jg.x), PROP_STEPS, backend="segment")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    agg = op.propagate_aggregate(g, g.x, HOP_WEIGHTS, device="cpu")
    np.testing.assert_allclose(
        agg.numpy(), np.tensordot(HOP_WEIGHTS, np.asarray(want), axes=1), rtol=1e-5, atol=1e-6
    )
    with pytest.raises(ValueError):
        op.propagate(g, g.x[:-1], device="cpu")


# -- long rows: the split plan and the kernel's summation order --------------

L = SPLIT_NNZ


def _rowptr(lengths) -> torch.Tensor:
    return torch.as_tensor(np.concatenate([[0], np.cumsum(lengths)]), dtype=torch.int32)


def check_plan_covers_rows(rowptr: torch.Tensor, plan) -> None:
    """Every nonzero of ``rowptr`` is covered once, in order: by its row's
    own task when the row holds at most ``plan.split`` nonzeros, else by one
    of its row's consecutive segments of at most ``plan.split`` nonzeros."""
    r = rowptr.long()
    lengths = r[1:] - r[:-1]
    assert plan.split == L and plan.rowptr is rowptr
    assert torch.equal(plan.long_rows.long(), torch.nonzero(lengths > L).flatten())
    # the accumulating form's row tasks walk the rows neither empty nor long,
    # listed where the non-empty rows are short on average
    listed = torch.nonzero((lengths > 0) & (lengths <= L)).flatten()
    short = int(r[-1]) <= LIST_MAX_NNZ * int((lengths > 0).sum())
    assert torch.equal(plan.rows.long(), listed if short else listed[:0])
    for t in (plan.seg_beg, plan.seg_end, plan.seg_ptr, plan.long_rows, plan.rows):
        assert t.dtype == torch.int32 and t.is_contiguous()
    covered = torch.zeros(int(r[-1]), dtype=torch.int64)
    for row in torch.nonzero(lengths <= L).flatten().tolist():
        covered[int(r[row]):int(r[row + 1])] += 1
    seg_ptr = plan.seg_ptr.long()
    assert int(seg_ptr[0]) == 0 and int(seg_ptr[-1]) == plan.num_segments
    for k, row in enumerate(plan.long_rows.tolist()):
        beg = plan.seg_beg[seg_ptr[k]:seg_ptr[k + 1]].long()
        end = plan.seg_end[seg_ptr[k]:seg_ptr[k + 1]].long()
        assert len(beg) == -(-int(lengths[row]) // L)  # ceil(length / L) segments
        assert int(beg[0]) == int(r[row]) and int(end[-1]) == int(r[row + 1])
        assert torch.equal(beg[1:], end[:-1])  # consecutive, in order
        sizes = end - beg
        assert bool((sizes >= 1).all()) and bool((sizes[:-1] == L).all()) and int(sizes[-1]) <= L
        for b, e in zip(beg.tolist(), end.tolist()):
            covered[b:e] += 1
    assert bool((covered == 1).all())


@pytest.mark.parametrize("lengths", [
    [0, L, L + 1, 3 * L + 5, 0, 3],  # at the edges of the cut, and empty rows
    [2 * L, 1, 4 * L, L],  # whole multiples of L
    [L] * 5,  # no row is cut
    [0, 0, 0],  # no nonzero at all
    [7 * L + 1],  # one long row only
], ids=["edges", "multiples", "none-long", "empty", "one-row"])
def test_split_plan_covers_every_nonzero_once_in_order(lengths):
    rowptr = _rowptr(lengths)
    plan = _make_plan(rowptr, L)
    check_plan_covers_rows(rowptr, plan)
    assert plan.num_long == sum(n > L for n in lengths)
    assert plan.num_segments == sum(-(-n // L) for n in lengths if n > L)
    assert plan.workspace_bytes(16) == 4 * 16 * plan.num_segments


def test_split_length_is_the_kernel_source_constant():
    # the plans and the kernel's pass 1 must cut at the same length
    assert source_constants(TUNE_SOURCE.read_text())["kSplitNnz"] == SPLIT_NNZ
    assert _make_plan(_rowptr([1])).split == SPLIT_NNZ


@pytest.mark.parametrize("name, value", list(VARIANTS))
def test_tune_variant_changes_one_constant(name, value):
    text = TUNE_SOURCE.read_text()
    as_is = source_constants(text)
    assert as_is[name] != value
    variant = variant_source(text, name, value)
    assert source_constants(variant) == {**as_is, name: value}
    # one line changed
    assert sum(a != b for a, b in zip(text.splitlines(), variant.splitlines())) == 1


def test_tune_variant_refuses_an_unknown_or_ambiguous_constant():
    text = TUNE_SOURCE.read_text()
    with pytest.raises(ValueError, match="not one of"):
        variant_source(text, "kWarp", 16)
    with pytest.raises(ValueError, match="2 times"):
        source_constants(text + "\nconstexpr int kGroup = 8;\n")


def test_tune_refuses_to_run_without_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        tune_main([])


def test_prepare_csr_builds_the_plan_and_a_hand_built_csr_gets_it_on_first_use():
    _, g = _star_power_law(n=1200)
    adj = prepare_csr(symmetric_normalized_weights(g, device=CPU))
    check_plan_covers_rows(adj.rowptr, adj.plan)
    assert adj.plan.num_long >= 1
    hand = CsrAdj(adj.rowptr, adj.col, adj.val, adj.num_nodes)
    assert hand.plan is None and hand == adj  # the plan takes no part in ==
    x = torch.as_tensor(g.x)
    assert torch.equal(spmm_csr(hand, x), spmm_csr(adj, x))
    check_plan_covers_rows(hand.rowptr, hand.plan)


def _star_power_law(n=2000, deg=6, d=16, seed=3):
    """A power-law graph (Zipf in-degrees) plus a star on node 0, made
    undirected: node 0's row holds about ``n`` nonzeros, several ``L``."""
    rng = np.random.default_rng(seed)
    e = n * deg // 2
    src = np.concatenate([rng.integers(0, n, e), np.arange(1, n)])
    dst = np.concatenate([np.minimum(rng.zipf(1.5, e) - 1, n - 1), np.zeros(n - 1, np.int64)])
    keep = src != dst
    x = rng.normal(size=(n, d)).astype(np.float32)
    jg = JGraph.from_coo(src[keep], dst[keep], None, num_nodes=n, x=x, pad_multiple=256)
    jg = j_to_undirected(jg).replace(x=x)
    return jg, to_port_graph(jg)


def _hub_csr(g):
    adj = prepare_csr(symmetric_normalized_weights(g, device=CPU))
    assert int(torch.diff(adj.rowptr.long()).max()) > 3 * L  # a hub row of several L
    return adj


def test_spmm_long_rows_f32_match_segment():
    jg, g = _star_power_law()
    got = spmm_csr_reference(_hub_csr(g), torch.as_tensor(g.x))
    want = j_spmm(j_sym(jg), jnp.asarray(jg.x), backend="segment")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_k_hop_propagate_long_rows_f32_matches():
    jg, g = _star_power_law(seed=4)
    got = k_hop_propagate(_hub_csr(g), torch.as_tensor(g.x), PROP_STEPS)
    want = j_k_hop_propagate(j_sym(jg), jnp.asarray(jg.x), PROP_STEPS, backend="segment")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_spmm_long_rows_bf16_match_pallas_kernel_semantics():
    jg, g = _star_power_law(seed=5)
    want = spmm_pallas(prepare_chunked(j_sym(jg)), jnp.asarray(jg.x, jnp.bfloat16), interpret=True)
    got = spmm_csr(_hub_csr(g), torch.as_tensor(g.x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) <= 2e-2


def test_split_order_is_no_further_from_float64_than_one_f32_sequence():
    # one row of 2e5 positive terms (the worst case for a running f32 sum)
    # and a few short rows
    rng = np.random.default_rng(0)
    n, d, hub = 64, 4, 200_000
    lengths = rng.integers(0, 20, n)
    lengths[7] = hub
    rowptr = _rowptr(lengths)
    e = int(rowptr[-1])
    col = torch.as_tensor(rng.integers(0, n, e), dtype=torch.int32)
    val = torch.as_tensor(rng.random(e).astype(np.float32) + 0.5)
    x = torch.as_tensor(rng.random((n, d)).astype(np.float32) + 0.5)
    rows = torch.repeat_interleave(torch.arange(n, dtype=torch.int32), torch.diff(rowptr.long()))
    exact = torch.zeros(n, d, dtype=torch.float64).index_add_(
        0, rows.long(), x.double()[col.long()] * val.double()[:, None])
    split = spmm_csr(CsrAdj(rowptr, col, val, n), x)
    sequence = spmm_segment(SparseAdj(col, rows, val, n, True), x)  # one f32 sum per row
    err_split = float((split.double() - exact).abs().max() / exact.abs().max())
    err_sequence = float((sequence.double() - exact).abs().max() / exact.abs().max())
    assert err_split <= err_sequence, (err_split, err_sequence)
    assert err_split <= 1e-6
