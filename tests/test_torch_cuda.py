"""The port's CUDA kernels on the card, held against their plain twins.

These tests need a CUDA GPU and skip elsewhere.  The file imports no JAX, so
it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from sgl_tpu_torch.datasets import PlantedPartition, random_power_law_graph
from sgl_tpu_torch.graph import symmetric_normalized_weights
from sgl_tpu_torch.kernels import (
    CsrAdj,
    gather_sum,
    gather_sum_reference,
    prepare_csr,
    prepare_csr_parts,
    segment_reduce,
    segment_reduce_reference,
    spmm,
    spmm_csr,
    spmm_csr_acc,
    spmm_csr_acc_reference,
    spmm_csr_reference,
    spmm_csr_streaming,
    spmm_csr_streaming_reference,
)
from sgl_tpu_torch.kernels.segment_reduce import COLUMN_WINDOW, INSTANTIATIONS, TILE_MESSAGES, tiling
from sgl_tpu_torch.kernels.spmm_csr import SPLIT_NNZ, _make_plan
from sgl_tpu_torch.models import SGC, SIGN
from sgl_tpu_torch.tasks import NodeClassification

pytestmark = pytest.mark.cuda

# f32: the twin adds each row's messages in the kernel's order, so the two
# differ only by the kernel's fused multiply-add; bf16: both sum in f32 and
# round once, so they differ by at most one ulp
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [128, 96, 37])  # full-warp packets, narrower packets, scalar
def test_spmm_csr_kernel_matches_plain(cuda, dtype, d):
    g = random_power_law_graph(5000, 12, d, seed=3)
    adj = prepare_csr(symmetric_normalized_weights(g, device=cuda))
    x = torch.as_tensor(g.x, device=cuda).to(dtype)
    before = spmm_csr.launches[{torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]]
    got = spmm_csr(adj, x)
    torch.cuda.synchronize()
    assert spmm_csr.launches[{torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]] == before + 1
    want = spmm_csr_reference(adj, x)
    assert got.dtype == dtype and got.shape == x.shape
    err = (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()
    assert err <= TOL[dtype], err


def test_plain_twin_is_deterministic_on_the_card(cuda):
    # the yardstick must not move between runs (index_add_ on CUDA would)
    g = random_power_law_graph(5000, 12, 64, seed=4)
    adj = prepare_csr(symmetric_normalized_weights(g, device=cuda))
    x = torch.as_tensor(g.x, device=cuda)
    assert torch.equal(spmm_csr_reference(adj, x), spmm_csr_reference(adj, x))


def test_spmm_empty_rows_write_zeros(cuda):
    # node 2 has no in-edges: its output row must be zeros, not stale memory
    src = torch.tensor([0, 1, 3], dtype=torch.int32, device=cuda)
    dst = torch.tensor([1, 0, 1], dtype=torch.int32, device=cuda)
    w = torch.tensor([0.5, 2.0, 1.0], device=cuda)
    from sgl_tpu_torch.kernels import SparseAdj

    adj = prepare_csr(SparseAdj(src, dst, w, 4))
    x = torch.randn(4, 8, device=cuda)
    y = spmm(adj, x)
    want = torch.zeros_like(x)
    want[1] = 0.5 * x[0] + x[3]
    want[0] = 2.0 * x[1]
    np.testing.assert_allclose(y.cpu().numpy(), want.cpu().numpy(), rtol=1e-6, atol=1e-6)


def test_spmm_csr_rejects_bad_input(cuda):
    g = random_power_law_graph(300, 6, 16, seed=1)
    adj = prepare_csr(symmetric_normalized_weights(g, device=cuda))
    x = torch.as_tensor(g.x, device=cuda)
    with pytest.raises(TypeError):
        spmm_csr(adj, x.double())
    with pytest.raises(ValueError):
        spmm_csr(adj, x.t())
    with pytest.raises(ValueError):
        spmm_csr(adj, x[:-1])


def test_node_classification_defaults_to_cuda(cuda):
    ds = PlantedPartition()
    model = SGC(3, ds.num_features, ds.num_classes)
    before = spmm_csr.launches["f32"]
    task = NodeClassification(ds, model, lr=0.1, weight_decay=5e-5, epochs=30, verbose=False)
    assert model.processed_feature.is_cuda
    assert spmm_csr.launches["f32"] >= before + 3
    assert task.test_acc >= 0.8


@pytest.mark.parametrize("d", [32, 37])  # full packets, scalar
def test_sign_preprocess_on_the_card_matches_the_cpu(cuda, d):
    """A zoo model's pre-propagation through the CSR kernel, against the
    port's CPU path on the same graph: SIGN's concat of 4 hops."""
    g = random_power_law_graph(4000, 10, d, seed=5)
    models = {dev: SIGN(3, d, 8, 32, 2) for dev in ("cuda", "cpu")}
    before = spmm_csr.launches["f32"]
    for dev, model in models.items():
        model.preprocess(g, device=dev)
    assert spmm_csr.launches["f32"] == before + 3
    got, want = models["cuda"].processed_feature, models["cpu"].processed_feature
    assert got.is_cuda and got.shape == want.shape == (4000, 4 * d)
    err = (got.cpu() - want).abs().max().item() / want.abs().max().item()
    assert err <= TOL[torch.float32], err


def _parts(cuda, d, n_parts=8, seed=3):
    """A power-law graph split so that its hub row is cut between parts."""
    g = random_power_law_graph(5000, 12, d, seed=seed)
    adj = prepare_csr(symmetric_normalized_weights(g, device=cuda))
    parts = prepare_csr_parts(adj, -(-adj.nnz // n_parts))
    return adj, parts, torch.as_tensor(g.x, device=cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
# full-warp packets, 16-byte accumulator packets at a width that leaves lanes
# idle, scalar, and 32-byte accumulator packets (bf16 at VEC = 8)
@pytest.mark.parametrize("d", [128, 100, 37, 256])
def test_spmm_csr_acc_kernel_matches_plain(cuda, dtype, d):
    adj, parts, x = _parts(cuda, d)
    x = x.to(dtype)
    key = {torch.float32: "acc_f32", torch.bfloat16: "acc_bf16"}[dtype]
    acc0 = torch.randn(adj.num_nodes, d, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    for part in parts:
        before = spmm_csr.launches[key]
        got = spmm_csr_acc(part, x, acc0.clone())
        assert spmm_csr.launches[key] == before + 1
        want = spmm_csr_acc_reference(part, x, acc0.clone())
        torch.cuda.synchronize()
        touched = torch.zeros(adj.num_nodes, dtype=torch.bool, device=cuda)
        touched[part.row_offset : part.row_offset + part.num_rows] = torch.diff(part.rowptr) > 0
        # rows the part does not touch keep the accumulator bit for bit
        assert torch.equal(got[~touched], acc0[~touched])
        # both sum in f32 in the same order: only the fused multiply-add differs
        err = (got[touched] - want[touched]).abs().max().item() / want[touched].abs().max().item()
        assert err <= 1e-5, (int(part.row_offset), err)
    # rows cut between consecutive parts were among those checked
    pairs = zip(parts.parts[:-1], parts.parts[1:])
    assert sum(a.row_offset + a.num_rows - 1 == b.row_offset for a, b in pairs) >= 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_spmm_csr_streaming_matches_one_shot_and_twin(cuda, dtype):
    adj, parts, x = _parts(cuda, 128, n_parts=5)
    x = x.to(dtype)
    key = {torch.float32: "acc_f32", torch.bfloat16: "acc_bf16"}[dtype]
    before = spmm_csr.launches[key]
    got = spmm_csr_streaming(parts, x)
    torch.cuda.synchronize()
    assert spmm_csr.launches[key] == before + len(parts)
    assert got.dtype == dtype and got.shape == x.shape
    for want in (spmm_csr(adj, x), spmm_csr_streaming_reference(parts, x)):
        err = (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()
        assert err <= TOL[dtype], err


def test_spmm_csr_acc_rejects_bad_input(cuda):
    adj, parts, x = _parts(cuda, 16)
    part = parts.parts[1]
    acc = torch.zeros(adj.num_nodes, 16, device=cuda)
    with pytest.raises(TypeError):
        spmm_csr_acc(part, x, acc.double())
    with pytest.raises(ValueError):  # ends before the part's last row
        spmm_csr_acc(part, x, acc[: part.row_offset + part.num_rows - 1])
    with pytest.raises(ValueError):
        spmm_csr_acc(part, x, acc.cpu())
    with pytest.raises(ValueError):
        spmm_csr_acc(part, x.t().contiguous().t(), acc)
    with pytest.raises(ValueError):  # fewer rows than the graph's nodes
        spmm_csr_acc(part, x[:-1], acc)


# -- long rows: the split plan, the fix-up and their fixed order ---------------

KEYS = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _star_csr(cuda, n=20_000, seed=0):
    """A CSR built by hand (so its plan is made on first use) with rows of
    10^5 and 10^6 nonzeros, rows at the split's edges (SPLIT_NNZ, + 1,
    3·SPLIT_NNZ + 5, 4·SPLIT_NNZ), empty rows (every 9th) and short random
    rows; weights 1/sqrt(row length) keep every row's sum of one size."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 30, n)
    lengths[::9] = 0
    lengths[[1, 2, 3, 4, 5, 7]] = [SPLIT_NNZ, SPLIT_NNZ + 1, 3 * SPLIT_NNZ + 5, 4 * SPLIT_NNZ,
                                   100_000, 1_000_000]
    rowptr = np.concatenate([[0], np.cumsum(lengths)])
    e = int(rowptr[-1])
    val = (rng.random(e) + 0.5) / np.sqrt(np.repeat(lengths, lengths))
    return CsrAdj(
        torch.as_tensor(rowptr, dtype=torch.int32, device=cuda),
        torch.as_tensor(rng.integers(0, n, e), dtype=torch.int32, device=cuda),
        torch.as_tensor(val, dtype=torch.float32, device=cuda),
        n,
    )


def _features(cuda, n, d, dtype, seed=1):
    return torch.randn(n, d, device=cuda, generator=torch.Generator(cuda).manual_seed(seed)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [128, 100, 37, 256])
def test_spmm_csr_long_rows_match_plain(cuda, dtype, d):
    adj = _star_csr(cuda)
    x = _features(cuda, adj.num_nodes, d, dtype)
    key = KEYS[dtype]
    before, fixups = spmm_csr.launches[key], spmm_csr.fixup_launches[key]
    got = spmm_csr(adj, x)
    torch.cuda.synchronize()
    assert spmm_csr.launches[key] == before + 1 and spmm_csr.fixup_launches[key] == fixups + 1
    plan = adj.plan  # made by the first call
    assert plan.split == SPLIT_NNZ and plan.num_long == 5 and plan.num_segments > 2000
    want = spmm_csr_reference(adj, x)
    assert got.dtype == dtype and got.shape == x.shape
    # the twin sums each segment in edge order and the partials in segment
    # order, as the kernel does
    err = (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()
    assert err <= TOL[dtype], err
    assert not got[torch.diff(adj.rowptr) == 0].any()  # empty rows written as zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [128, 100, 37, 256])
def test_spmm_csr_acc_long_rows_match_plain(cuda, dtype, d):
    adj = _star_csr(cuda)
    parts = prepare_csr_parts(adj, -(-adj.nnz // 5))
    x = _features(cuda, adj.num_nodes, d, dtype)
    key = "acc_" + KEYS[dtype]
    acc0 = torch.randn(adj.num_nodes, d, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    for part in parts:
        before, fixups = spmm_csr.launches[key], spmm_csr.fixup_launches[key]
        got = spmm_csr_acc(part, x, acc0.clone())
        assert spmm_csr.launches[key] == before + 1
        assert spmm_csr.fixup_launches[key] == fixups + (part.plan.num_long > 0)
        want = spmm_csr_acc_reference(part, x, acc0.clone())
        torch.cuda.synchronize()
        touched = torch.zeros(adj.num_nodes, dtype=torch.bool, device=cuda)
        touched[part.row_offset : part.row_offset + part.num_rows] = torch.diff(part.rowptr) > 0
        assert torch.equal(got[~touched], acc0[~touched])
        err = (got[touched] - want[touched]).abs().max().item() / want[touched].abs().max().item()
        assert err <= 1e-5, (int(part.row_offset), err)
    # the 10^6-nonzero row is cut between parts, and each share is long
    assert sum(p.plan.num_long > 0 for p in parts) >= 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_spmm_csr_runs_give_the_same_bits(cuda, dtype):
    adj = _star_csr(cuda)
    parts = prepare_csr_parts(adj, -(-adj.nnz // 5))
    x = _features(cuda, adj.num_nodes, 128, dtype)
    # no atomics: the partials are added in a fixed order, parts in turn
    assert torch.equal(spmm_csr(adj, x), spmm_csr(adj, x))
    assert torch.equal(spmm_csr_streaming(parts, x), spmm_csr_streaming(parts, x))


def test_spmm_csr_rejects_a_plan_of_another_csr(cuda):
    adj = _star_csr(cuda)
    other = prepare_csr(symmetric_normalized_weights(random_power_law_graph(20_000, 12, 8, seed=2),
                                                     device=cuda))
    x = _features(cuda, adj.num_nodes, 8, torch.float32)
    with pytest.raises(ValueError, match="another row pointer"):
        spmm_csr(dataclasses.replace(adj, plan=other.plan), x)
    part, other_part = prepare_csr_parts(adj, 10**6).parts[0], prepare_csr_parts(other, 10**6).parts[0]
    acc = torch.zeros(adj.num_nodes, 8, device=cuda)
    with pytest.raises(ValueError, match="another row pointer"):
        spmm_csr_acc(dataclasses.replace(part, plan=other_part.plan), x, acc)
    assert not acc.any()


def test_spmm_csr_rejects_a_plan_of_another_split_length(cuda):
    # the kernel cuts rows of more than SPLIT_NNZ itself, so a plan cut at
    # another length would leave rows to no task or to two
    adj = _star_csr(cuda)
    x = _features(cuda, adj.num_nodes, 8, torch.float32)
    for split in (SPLIT_NNZ // 2, 2 * SPLIT_NNZ):
        with pytest.raises(ValueError, match="segments of"):
            spmm_csr(dataclasses.replace(adj, plan=_make_plan(adj.rowptr, split)), x)
        part = prepare_csr_parts(adj, 10**6).parts[0]
        with pytest.raises(ValueError, match="segments of"):
            spmm_csr_acc(dataclasses.replace(part, plan=_make_plan(part.rowptr, split)), x,
                         torch.zeros(adj.num_nodes, 8, device=cuda))


# -- column panels and the short rows' path ------------------------------------


def _mixed_csr(cuda, n=6000, short=8, seed=0):
    """A CSR built by hand with empty rows (every 5th), short rows (1 to
    ``short`` nonzeros), medium rows (9 to 199, every 41st) and rows cut
    into segments (SPLIT_NNZ + 1, 3·SPLIT_NNZ + 5, 20,000 nonzeros)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, short + 1, n)
    lengths[3::41] = rng.integers(9, 200, lengths[3::41].shape[0])
    lengths[::5] = 0
    lengths[[7, 8, 2001]] = [SPLIT_NNZ + 1, 3 * SPLIT_NNZ + 5, 20_000]
    rowptr = np.concatenate([[0], np.cumsum(lengths)])
    e = int(rowptr[-1])
    return CsrAdj(
        torch.as_tensor(rowptr, dtype=torch.int32, device=cuda),
        torch.as_tensor(rng.integers(0, n, e), dtype=torch.int32, device=cuda),
        torch.as_tensor(rng.random(e) + 0.5, dtype=torch.float32, device=cuda),
        n,
    )


def _one_shot(adj, x, panel):
    from sgl_tpu_torch.kernels.spmm_csr import _library, _plan, run_passes

    y = torch.empty_like(x)
    run_passes(_library(), KEYS[x.dtype], _plan(adj), adj.rowptr, adj.col, adj.val, x, y, adj.num_nodes,
               x.shape[1], panel=panel)
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d, panels", [(42, (8, 16, 32)), (100, (16, 32, 64)), (500, (32, 64, 128))],
                         ids=["d42", "d100", "d500"])
def test_spmm_csr_panels_match_plain(cuda, dtype, d, panels):
    # forced panels at small N: D = 42 has D % 4 = 2, as Reddit's 602 has
    adj = _mixed_csr(cuda)
    x = _features(cuda, adj.num_nodes, d, dtype)
    whole = _one_shot(adj, x, d)
    want = spmm_csr_reference(adj, x)
    assert adj.plan.num_long == 3
    for panel in panels:
        got = _one_shot(adj, x, panel)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()
        assert err <= TOL[dtype], (panel, err)
        assert torch.equal(got, _one_shot(adj, x, panel))  # two runs, the same bits
        # each element summed in the same order with or without panels
        assert torch.equal(got, whole), panel
        assert not got[torch.diff(adj.rowptr) == 0].any()  # empty rows written as zeros


def test_spmm_csr_takes_the_rules_panels(cuda):
    # a graph whose x is larger than the L2 budget goes through the panels
    from sgl_tpu_torch.kernels.spmm_csr import L2_BUDGET, panel_columns

    n, d = 60_000, 602
    assert panel_columns(n, d, 4) < d and n * d * 4 > L2_BUDGET
    adj = prepare_csr(symmetric_normalized_weights(random_power_law_graph(n, 6, 4, seed=1), device=cuda))
    x = _features(cuda, n, d, torch.float32)
    before = spmm_csr.launches["f32"]
    got = spmm_csr(adj, x)
    assert spmm_csr.launches["f32"] == before + 1 and spmm_csr.panels["f32"] == panel_columns(n, d, 4)
    assert torch.equal(got, _one_shot(adj, x, d))
    want = spmm_csr_reference(adj, x)
    assert (got - want).abs().max().item() <= TOL[torch.float32] * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [100, 42, 256])
def test_spmm_csr_acc_short_rows_match_plain(cuda, dtype, d):
    # the ring's buckets: one to three nonzeros a row, a fifth of the rows
    # empty; every part's empty rows keep the accumulator's bits
    adj = _mixed_csr(cuda, n=20_000, short=3)
    parts = prepare_csr_parts(adj, -(-adj.nnz // 3))
    x = _features(cuda, adj.num_nodes, d, dtype)
    key = "acc_" + KEYS[dtype]
    acc0 = torch.randn(adj.num_nodes, d, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    for part in parts:
        lengths = torch.diff(part.rowptr.long())
        listed = torch.nonzero((lengths > 0) & (lengths <= SPLIT_NNZ)).flatten()
        # the plan lists its rows where they are short on average
        assert torch.equal(part.plan.rows.long(), listed) or part.plan.num_listed == 0
        before, fixups = spmm_csr.launches[key], spmm_csr.fixup_launches[key]
        got = spmm_csr_acc(part, x, acc0.clone())
        assert spmm_csr.launches[key] == before + 1
        assert spmm_csr.fixup_launches[key] == fixups + (part.plan.num_long > 0)
        want = spmm_csr_acc_reference(part, x, acc0.clone())
        torch.cuda.synchronize()
        touched = torch.zeros(adj.num_nodes, dtype=torch.bool, device=cuda)
        touched[part.row_offset: part.row_offset + part.num_rows] = lengths > 0
        assert torch.equal(got[~touched], acc0[~touched])
        err = (got[touched] - want[touched]).abs().max().item() / want[touched].abs().max().item()
        assert err <= 1e-5, (int(part.row_offset), err)
        assert torch.equal(got, spmm_csr_acc(part, x, acc0.clone()))


def test_spmm_csr_acc_part_without_listed_rows(cuda):
    # every row empty: one launch of one idle block, the accumulator unchanged
    from sgl_tpu_torch.kernels.spmm_csr import CsrPart

    n = 1000
    part = CsrPart(torch.zeros(n + 1, dtype=torch.int32, device=cuda), torch.zeros(0, dtype=torch.int32, device=cuda),
                   torch.zeros(0, dtype=torch.float32, device=cuda), 0, n, n)
    x = _features(cuda, n, 64, torch.float32)
    acc = torch.randn(n, 64, device=cuda)
    before = spmm_csr.launches["acc_f32"]
    got = spmm_csr_acc(part, x, acc.clone())
    torch.cuda.synchronize()
    assert part.plan.num_listed == 0 and spmm_csr.launches["acc_f32"] == before + 1
    assert torch.equal(got, acc)


# -- the segment reduce (dev/ kernels D2-D6) and the gather sum (D1) ----------


def _segment_inputs(cuda, key, d, n=3000, seed=0):
    """Dst-ordered random messages for instantiation ``key`` on the card: a
    hub row of 25,000 messages (49 tiles), rows of T-1, T, T+1 and 3T+5
    messages (T = TILE_MESSAGES), empty rows (every 7th, two at tile edges
    and the last three), bf16 weight halves where the form takes them."""
    dtype, halves, n_w, _, _ = INSTANTIATIONS[key]
    rng = np.random.default_rng(seed)
    t = TILE_MESSAGES
    lengths = rng.integers(1, 12, n)
    lengths[5] = 25_000
    lengths[::7] = 0
    lengths[10:14] = [t - 1, t, t + 1, 3 * t + 5]
    for row in (n // 3, 2 * n // 3):  # an empty row whose offset is a multiple of T
        lengths[row - 1] = t - lengths[:row - 1].sum() % t
        lengths[row] = 0
    lengths[-3:] = 0
    rowptr = torch.as_tensor(np.concatenate([[0], np.cumsum(lengths)]), dtype=torch.int32, device=cuda)
    e = int(rowptr[-1])
    gen = torch.Generator(cuda).manual_seed(seed)
    m = torch.randn(e, halves * d, device=cuda, generator=gen).to(dtype)
    w = torch.rand(e, device=cuda, generator=gen) + 0.5
    wh = w.to(torch.bfloat16)
    wl = (w - wh.float()).to(torch.bfloat16)
    return rowptr, m, dict(halves=halves, wh=wh if n_w >= 1 else None, wl=wl if n_w == 2 else None)


def _segment_run(rowptr, m, kw, key, d):
    """The kernel and its twin on the same inputs: ``(got, want, touched)``,
    the accumulating form into a random window at a row offset (its
    untouched rows, and the rows outside the window, checked bit for bit)."""
    n = rowptr.shape[0] - 1
    if INSTANTIATIONS[key][3]:
        off = 7
        acc0 = torch.randn(off + n + 5, d, device=m.device, generator=torch.Generator(m.device).manual_seed(1))
        acc = acc0.clone()
        got = segment_reduce(rowptr, m, out=acc, row_offset=off, **kw)
        want = segment_reduce_reference(rowptr, m, out=acc0.clone(), row_offset=off, **kw)
        torch.cuda.synchronize()
        assert got is acc and got.data_ptr() == acc.data_ptr()
        touched = torch.zeros(acc.shape[0], dtype=torch.bool, device=m.device)
        touched[off:off + n] = torch.diff(rowptr) > 0
        # outside the window and the window's empty rows: bit for bit
        assert torch.equal(got[~touched], acc0[~touched])
        return got, want, touched
    got = segment_reduce(rowptr, m, **kw)
    want = segment_reduce_reference(rowptr, m, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (n, d)
    assert not got[torch.diff(rowptr) == 0].any()  # empty rows written as zeros
    return got, want, torch.diff(rowptr) > 0


def _rel_to_max(got, want) -> float:
    return (got - want).abs().max().item() / want.abs().max().item()


@pytest.mark.parametrize("key", sorted(INSTANTIATIONS))
# 16-byte rows streamed by bulk copy (D = 128, 256, and 100 but for bf16
# rows of 200 bytes), the others by cp.async (D = 37, bf16 D = 100); D =
# 1100: two column windows, each row's window by cp.async, a launch each
@pytest.mark.parametrize("d", [128, 100, 37, 256, 1100])
def test_segment_reduce_kernel_matches_plain(cuda, key, d):
    rowptr, m, kw = _segment_inputs(cuda, key, d)
    before = segment_reduce.launches[key], segment_reduce.fixup_launches[key]
    got, want, touched = _segment_run(rowptr, m, kw, key, d)
    windows = 2 if d > COLUMN_WINDOW else 1
    assert segment_reduce.launches[key] == before[0] + windows
    assert segment_reduce.fixup_launches[key] == before[1] + windows
    path = tiling(rowptr, m, kw["halves"])["path"]
    assert path == ("windows" if d > COLUMN_WINDOW
                    else "bulk" if m.shape[1] * m.element_size() % 16 == 0 else "cp.async")
    # the same messages summed in the same order: only fused multiply-adds
    # inside a message differ
    err = _rel_to_max(got[touched], want[touched])
    assert err <= 1e-5, err


@pytest.mark.parametrize("key", sorted(INSTANTIATIONS))
def test_segment_reduce_walks_long_runs_of_empty_rows(cuda, key):
    # runs of 700 empty rows inside tiles (past the T + 8 row pointers a
    # block keeps, so the kernel searches rowptr for the next row), a run
    # where a tile starts, and 5,000 trailing empty rows
    dtype, halves, n_w, _, _ = INSTANTIATIONS[key]
    t = TILE_MESSAGES
    lengths = []
    for i in range(12):
        lengths += [3, 0] + [0] * 700 + [t // 2 + 7 * i, 1] + [0] * (i % 3)
    lengths += [t - sum(lengths) % t] + [0] * 700 + [5] + [0] * 5000
    rng = np.random.default_rng(7)
    rowptr = torch.as_tensor(np.concatenate([[0], np.cumsum(lengths)]), dtype=torch.int32, device=cuda)
    e = int(rowptr[-1])
    gen = torch.Generator(cuda).manual_seed(3)
    m = torch.randn(e, halves * 64, device=cuda, generator=gen).to(dtype)
    w = torch.as_tensor(rng.random(e).astype(np.float32) + 0.5, device=cuda)
    wh = w.to(torch.bfloat16)
    kw = dict(halves=halves, wh=wh if n_w >= 1 else None,
              wl=(w - wh.float()).to(torch.bfloat16) if n_w == 2 else None)
    starts = rowptr[:-1].cpu().numpy()
    assert ((np.diff(rowptr.cpu().numpy()) == 0) & (starts % t == 0) & (starts > 0)).any()
    got, want, touched = _segment_run(rowptr, m, kw, key, 64)
    assert _rel_to_max(got[touched], want[touched]) <= 1e-5


@pytest.mark.parametrize("key", sorted(INSTANTIATIONS))
def test_segment_reduce_misaligned_messages_give_the_same_bits(cuda, key):
    # a slice one element into a buffer: m is no longer 16-byte aligned, so
    # the kernel streams it with cp.async; the order of the sum is the same
    rowptr, m, kw = _segment_inputs(cuda, key, 128)
    buf = torch.empty(m.numel() + 1, dtype=m.dtype, device=cuda)
    shifted = buf[1:].view(m.shape)
    shifted.copy_(m)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    assert tiling(rowptr, shifted, kw["halves"])["path"] == "cp.async"
    assert tiling(rowptr, m, kw["halves"])["path"] == "bulk"
    aligned, _, _ = _segment_run(rowptr, m, kw, key, 128)
    got, want, touched = _segment_run(rowptr, shifted, kw, key, 128)
    assert torch.equal(got, aligned)
    assert _rel_to_max(got[touched], want[touched]) <= 1e-5


@pytest.mark.parametrize("key", sorted(INSTANTIATIONS))
def test_segment_reduce_is_deterministic_and_counts_its_fixup(cuda, key):
    rowptr, m, kw = _segment_inputs(cuda, key, 100)
    # weights one element into a buffer: not 16-byte aligned, so loaded
    # without the bulk copy
    for name in ("wh", "wl"):
        if kw[name] is not None:
            buf = torch.empty(kw[name].numel() + 1, dtype=torch.bfloat16, device=cuda)
            buf[1:] = kw[name]
            kw[name] = buf[1:]
    before = dict(segment_reduce.launches), dict(segment_reduce.fixup_launches)
    first, _, _ = _segment_run(rowptr, m, kw, key, 100)
    second, _, _ = _segment_run(rowptr, m, kw, key, 100)
    assert torch.equal(first, second)  # no atomics: the same bits every run
    assert segment_reduce.launches[key] == before[0][key] + 2
    assert segment_reduce.fixup_launches[key] == before[1][key] + 2
    # one tile: no cut row, no fix-up
    small = torch.tensor([0, 3, 3, TILE_MESSAGES], dtype=torch.int32, device=cuda)
    got, want, touched = _segment_run(small, m, kw, key, 100)
    assert segment_reduce.fixup_launches[key] == before[1][key] + 2
    assert segment_reduce.launches[key] == before[0][key] + 3
    assert _rel_to_max(got[touched], want[touched]) <= 1e-5


@pytest.mark.parametrize("key", sorted(INSTANTIATIONS))
# rows wider than a ring stage (12,289 f32 columns: 49,156 bytes a half),
# 13 windows; 1,037 columns one element into a buffer, so that each row's
# window, and each half, lies at another offset of its 16-byte words
@pytest.mark.parametrize("d, shift", [(12_289, 0), (1_037, 1)])
def test_segment_reduce_streams_wide_rows_by_column_window(cuda, key, d, shift):
    rowptr, m, kw = _segment_inputs(cuda, key, d, n=300)
    if shift:
        buf = torch.empty(m.numel() + shift, dtype=m.dtype, device=cuda)
        m = buf[shift:].view(m.shape).copy_(m)
    assert tiling(rowptr, m, kw["halves"])["path"] == "windows"
    windows = -(-d // COLUMN_WINDOW)
    before = segment_reduce.launches[key], segment_reduce.fixup_launches[key]
    got, want, touched = _segment_run(rowptr, m, kw, key, d)
    assert segment_reduce.launches[key] == before[0] + windows
    assert segment_reduce.fixup_launches[key] == before[1] + windows
    assert _rel_to_max(got[touched], want[touched]) <= 1e-5
    assert torch.equal(_segment_run(rowptr, m, kw, key, d)[0], got)


@pytest.mark.parametrize("d", [128, 100, 37])
def test_gather_sum_kernel_matches_plain_and_is_deterministic(cuda, d):
    n, e = 50_000, 100_003  # E a multiple of no block size
    gen = torch.Generator(cuda).manual_seed(2)
    x = torch.randn(n, d, device=cuda, generator=gen)
    src = torch.randint(0, n, (e,), device=cuda, generator=gen, dtype=torch.int32)
    before = gather_sum.launches["f32"]
    got = gather_sum(x, src)
    torch.cuda.synchronize()
    assert gather_sum.launches["f32"] == before + 1
    assert got.shape == (1, d) and got.dtype == torch.float32
    want = gather_sum_reference(x, src)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert torch.equal(gather_sum(x, src), got)  # no atomics: the same bits every run
    one = gather_sum(x, src[:1])
    assert torch.equal(one, x[src[:1].long()])


def test_segment_reduce_rejects_bad_input(cuda):
    rowptr, m, _ = _segment_inputs(cuda, "f32", 16, n=50)
    n = rowptr.shape[0] - 1
    out = torch.zeros(n + 2, 16, device=cuda)
    wh = torch.ones(m.shape[0], dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):
        segment_reduce(rowptr, m.half())
    with pytest.raises(ValueError):  # short rowptr
        segment_reduce(rowptr[:0], m)
    with pytest.raises(ValueError):  # rowptr names more message rows than m holds
        segment_reduce(rowptr, m[:-1].contiguous())
    with pytest.raises(ValueError):
        segment_reduce(rowptr, m.t().contiguous().t())
    with pytest.raises(ValueError):  # out too short for the window
        segment_reduce(rowptr, m, out=out, row_offset=3)
    with pytest.raises(ValueError):
        segment_reduce(rowptr.cpu(), m)
    with pytest.raises(ValueError):  # f32 messages with one weight: no such kernel
        segment_reduce(rowptr, m, wh=wh)
    with pytest.raises(TypeError):
        gather_sum(m.double(), rowptr)
    with pytest.raises(ValueError):
        gather_sum(m, rowptr.cpu())


# -- the label and NAFS paths: K1 at label widths, its gradient ---------------


@pytest.mark.parametrize("d", [3, 47, 64])  # pubmed's classes, an odd width, the main path's
def test_spmm_csr_at_label_widths_matches_plain(cuda, d):
    g = random_power_law_graph(20_000, 12, d, seed=6)
    adj = prepare_csr(symmetric_normalized_weights(g, device=cuda))
    assert adj.plan.num_long > 0  # the hub rows take the fix-up at these widths too
    x = torch.as_tensor(g.x, device=cuda)
    before = spmm_csr.launches["f32"]
    got = spmm_csr(adj, x)
    torch.cuda.synchronize()
    assert spmm_csr.launches["f32"] == before + 1
    assert _rel_to_max(got, spmm_csr_reference(adj, x)) <= TOL[torch.float32]
    assert torch.equal(spmm_csr(adj, x), got)


@pytest.mark.parametrize("r", [0.5, 0.3])
def test_spmm_gradient_on_the_card_matches_the_cpu(cuda, r):
    """``dx = Aᵀ g`` by the CSR kernel on the transposed CSR: one forward
    and one backward launch, against the CPU path's gradient."""
    from sgl_tpu_torch.kernels import transposed

    g = random_power_law_graph(20_000, 12, 16, seed=7)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        adj = symmetric_normalized_weights(g, r=r, device=dev)
        if dev.type == "cuda":
            adj = prepare_csr(adj)
        x = torch.as_tensor(g.x, device=dev).requires_grad_(True)
        before = spmm_csr.launches["f32"]
        y = spmm(adj, x)
        if dev.type == "cuda":
            assert spmm_csr.launches["f32"] == before + 1
        (y ** 2).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert spmm_csr.launches["f32"] == before + 2
            assert transposed(adj).plan.num_long > 0
        grads[dev.type] = x.grad
    assert grads["cuda"].is_cuda
    assert _rel_to_max(grads["cuda"].cpu(), grads["cpu"]) <= TOL[torch.float32]


@pytest.mark.parametrize("kind", ["integer", "soft_masked", "correct_and_smooth"])
def test_label_propagation_on_the_card_matches_the_cpu(cuda, kind):
    from sgl_tpu_torch.tricks import CorrectAndSmooth, label_propagation

    ds = PlantedPartition()
    y = torch.as_tensor(np.asarray(ds.y).reshape(-1))
    rng = np.random.default_rng(0)
    y_soft = torch.softmax(torch.as_tensor(rng.normal(size=(ds.num_node, ds.num_classes)),
                                           dtype=torch.float32), dim=1)
    mask = np.asarray(ds.train_idx)
    out, launches = {}, {}
    for dev in (cuda, torch.device("cpu")):
        adj = symmetric_normalized_weights(ds.graph, device=dev)
        before = spmm_csr.launches["f32"]
        if kind == "integer":
            out[dev.type] = label_propagation(y.to(dev), adj, 6, 0.9)
        elif kind == "soft_masked":
            out[dev.type] = label_propagation(y_soft.to(dev), adj, 6, 0.9, mask=mask)
        else:
            cs = CorrectAndSmooth(5, 0.8, 4, 0.8)
            c = cs.correct(y_soft.to(dev), y.to(dev), mask, adj)
            out[dev.type] = cs.smooth(c, y.to(dev), mask, adj)
        launches[dev.type] = spmm_csr.launches["f32"] - before
    assert out["cuda"].is_cuda
    assert launches == {"cuda": 9 if kind == "correct_and_smooth" else 6, "cpu": 0}
    assert _rel_to_max(out["cuda"].cpu(), out["cpu"]) <= TOL[torch.float32]


def test_nafs_sweep_on_the_card_matches_the_cpu(cuda):
    from sgl_tpu_torch.tasks import nafs_smooth_sweep

    g = random_power_law_graph(8000, 10, 32, seed=8)
    r_list = (0.5, 0.3, 0.0)
    before = spmm_csr.launches["f32"]
    got = list(nafs_smooth_sweep(g, g.x, [0, 2, 5], r_list, "mean", device=cuda))
    torch.cuda.synchronize()
    assert spmm_csr.launches["f32"] == before + 5 * len(r_list)
    want = list(nafs_smooth_sweep(g, g.x, [0, 2, 5], r_list, "mean", device="cpu"))
    for (hop, a), (_, b) in zip(got, want):
        assert a.is_cuda and a.shape == b.shape
        assert _rel_to_max(a.cpu(), b) <= TOL[torch.float32], hop


def test_link_prediction_gae_on_the_card(cuda):
    from sgl_tpu_torch.tasks import LinkPredictionGAE

    ds = PlantedPartition()
    before = spmm_csr.launches["f32"]
    task = LinkPredictionGAE(ds, SGC(2, ds.num_features, 16), lr=0.01, weight_decay=5e-5, epochs=10,
                             verbose=False)
    assert spmm_csr.launches["f32"] == before + 2
    assert task.test_roc_auc > 0.7, task.test_roc_auc


# -- the NARS path and graph classification: card against the CPU path -------


@pytest.mark.parametrize("name", ["Fast_NARS_SGC_WithLearnableWeights", "NARS_SIGN"])
def test_nars_on_the_card_matches_the_cpu(cuda, name):
    """One block-diagonal propagation of the relation subgraphs (two of
    two relations, 2 hops): 2 launches of K1 and no fix-up; the same
    subsets, features and logits from the same weights as the CPU path."""
    from sgl_tpu_torch.datasets import SyntheticHeteroDataset
    from sgl_tpu_torch.models import hetero

    ds = SyntheticHeteroDataset(seed=1)
    card, host = (getattr(hetero, name)(2, 16, ds.num_classes, 16, 2, 2) for _ in range(2))
    before, fixups = spmm_csr.launches["f32"], spmm_csr.fixup_launches["f32"]
    card.preprocess(ds, "paper", random_subgraph_num=2, subgraph_edge_type_num=2, device=cuda)
    torch.cuda.synchronize()
    assert (spmm_csr.launches["f32"] - before, spmm_csr.fixup_launches["f32"] - fixups) == (2, 0)
    host.preprocess(ds, "paper", random_subgraph_num=2, subgraph_edge_type_num=2, device="cpu")
    assert card.subgraph_keys == host.subgraph_keys
    assert card.processed_feature.is_cuda
    assert _rel_to_max(card.processed_feature.cpu(), host.processed_feature) <= TOL[torch.float32]
    host.init(torch.Generator().manual_seed(0))
    card.net.load_state_dict(host.net.state_dict())
    card.net.to(cuda)
    idx = torch.arange(0, ds.data.num_node["paper"], 2)
    got = card.apply(idx.to(cuda)).detach().cpu()
    assert _rel_to_max(got, host.apply(idx).detach()) <= TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_graph_classification_on_the_card_matches_the_cpu(cuda, dtype):
    """GraphSIGN (f32) or GraphSGC (bf16 precompute) over the batch of 200
    graphs: 2 launches of K1 or K2, pooled features and logits as on the
    CPU path."""
    from sgl_tpu_torch.datasets import SyntheticGraphClassification
    from sgl_tpu_torch.models import GraphSGC, GraphSIGN
    from sgl_tpu_torch.tasks import GraphClassification

    ds = SyntheticGraphClassification(200)
    key = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]

    def make():
        if dtype == torch.float32:
            return GraphSIGN(2, ds.num_features, ds.num_classes, hidden_dim=16)
        return GraphSGC(2, ds.num_features, ds.num_classes, readout="max")

    card, host = make(), make()
    before = spmm_csr.launches[key]
    card.preprocess(ds.batch(), dtype=dtype if key == "bf16" else None, device=cuda)
    torch.cuda.synchronize()
    assert spmm_csr.launches[key] == before + 2
    host.preprocess(ds.batch(), dtype=dtype if key == "bf16" else None, device="cpu")
    assert card.processed_feature.is_cuda and card.processed_feature.dtype == dtype
    assert _rel_to_max(card.processed_feature.cpu(), host.processed_feature) <= TOL[dtype]
    host.init(torch.Generator().manual_seed(0))
    card.net.load_state_dict(host.net.state_dict())
    card.net.to(cuda)
    got = card.net(card.net_inputs()[0]).detach().cpu()
    assert _rel_to_max(got, host.net(host.net_inputs()[0]).detach()) <= TOL[dtype]
    task = GraphClassification(ds, make(), lr=0.05, weight_decay=5e-5, epochs=5, verbose=False,
                               precompute_dtype=dtype if key == "bf16" else None)
    assert 0.0 <= task.test_acc <= 1.0


# -- out of core: K3/K4 on host-streamed parts, card against the CPU path ------


def _ooc_graph():
    from sgl_tpu_torch.graph import symmetric_normalized_weights_host

    g = random_power_law_graph(6000, 10, 40, seed=5)
    return symmetric_normalized_weights_host(g), g.x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["1d", "2d", "resident"])
def test_out_of_core_on_the_card_matches_the_cpu(cuda, layout, dtype):
    """Each layout's hop on the card (pinned slots, copy streams, K3/K4)
    against its CPU path; two runs bit-equal; one launch a part or
    non-empty cell, and a fix-up for each that holds a long row."""
    from sgl_tpu_torch.kernels import (
        prepare_out_of_core, prepare_out_of_core_2d, spmm_2d_resident, spmm_out_of_core,
        spmm_out_of_core_2d,
    )

    adj, x = _ooc_graph()
    xt = torch.as_tensor(x).to(dtype)
    key = "acc_" + {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    if layout == "1d":
        oc = prepare_out_of_core(adj, max_edges_per_part=8192)
        cells = [p.csr for p in oc.parts]
        run = lambda dev: spmm_out_of_core(oc, xt, device=dev)  # noqa: E731
    else:
        oc = prepare_out_of_core_2d(adj, max_edges_per_part=8192, src_blocks=3, feat_dim=40, feat_dtype=dtype)
        cells = [c for row in oc.parts for c in row if c.nnz]
        if layout == "2d":
            run = lambda dev: spmm_out_of_core_2d(oc, xt, device=dev, max_device_acc_bytes=1 << 20)  # noqa: E731
        else:
            run = lambda dev: spmm_2d_resident(oc, xt.to(dev)).cpu()  # noqa: E731
    want = run("cpu")
    before, fixups = spmm_csr.launches[key], spmm_csr.fixup_launches[key]
    got = run(cuda)
    torch.cuda.synchronize()
    assert spmm_csr.launches[key] - before == len(cells) > 1
    assert spmm_csr.fixup_launches[key] - fixups == sum(c.counts[3] > 0 for c in cells)
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert got.dtype == dtype and not got.is_cuda
    assert _rel_to_max(got.float(), want.float()) <= TOL[dtype]
    assert torch.equal(torch.as_tensor(run(cuda)), got)


def test_out_of_core_null_transfer_and_edge_cache_on_the_card(cuda):
    from sgl_tpu_torch.kernels import prepare_out_of_core_2d, spmm_out_of_core_2d

    adj, x = _ooc_graph()
    oc = prepare_out_of_core_2d(adj, max_edges_per_part=8192, src_blocks=3, feat_dim=40)
    want = spmm_out_of_core_2d(oc, x, device="cpu")
    spmm_out_of_core_2d(oc, x, device=cuda, null_transfer=True)
    cached = dict(oc._dev_edges)
    assert len(cached) == oc.num_cells and all(p.rowptr.is_cuda for p in cached.values())
    spmm_out_of_core_2d(oc, x, null_transfer=True)  # device=None: the same card, served from the cache
    assert all(oc._dev_edges[k] is p for k, p in cached.items())
    got = spmm_out_of_core_2d(oc, x, device=cuda, max_device_edge_bytes=0)
    assert len(oc._dev_edges) == 0
    assert _rel_to_max(torch.as_tensor(got), torch.as_tensor(want)) <= TOL[torch.float32]


def test_host_hops_rows_on_the_card(cuda):
    from sgl_tpu_torch.utils import HostHops

    rng = np.random.default_rng(0)
    hops = [rng.normal(size=(500, 24)).astype(np.float32) for _ in range(3)]
    store = HostHops(hops, device=cuda)
    batches = [rng.integers(0, 500, 100) for _ in range(5)]
    # five batches through two pinned slots, read only after all are issued
    got = [store.rows(torch.as_tensor(b, device=cuda)) for b in batches]
    for b, g in zip(batches, got):
        assert g.is_cuda
        assert torch.equal(g.cpu(), torch.from_numpy(np.stack(hops)[:, b]))


@pytest.mark.parametrize("kind", ["laplacian", "ppr"])
def test_prop_cache_on_the_card_is_direct_propagation(cuda, kind):
    """The cache's first request, a prefix and an extension equal
    ``GraphOp.propagate`` on the card: the extension runs the same kernel
    launches on the same inputs, so bit for bit."""
    from sgl_tpu_torch.ops import LaplacianGraphOp, PprGraphOp
    from sgl_tpu_torch.search import PropagationCache

    make = (lambda k: LaplacianGraphOp(k)) if kind == "laplacian" else (lambda k: PprGraphOp(k, alpha=0.2))
    g = random_power_law_graph(6000, 12, 64, seed=5)
    direct = make(5).propagate(g, g.x, device=cuda)
    cache = PropagationCache()
    before = spmm_csr.launches["f32"]
    for k in (3, 2, 5):
        hops, est = cache.hops_for(g, g.x, make(k), device=cuda)
        assert hops.is_cuda and torch.equal(hops, direct[: k + 1]) and est > 0
    assert spmm_csr.launches["f32"] - before == 5 == cache.hops_computed
    assert (cache.misses, cache.hits) == (1, 2)


def test_resumable_precompute_on_the_card(cuda, tmp_path):
    """Stopped after hop 2 and resumed to 5: bit-equal to an uninterrupted
    run on the card, within 1e-5 of the CPU path."""
    from sgl_tpu_torch.utils import HopCheckpointer

    g = random_power_law_graph(6000, 12, 64, seed=6)
    adj = prepare_csr(symmetric_normalized_weights(g, device=cuda))
    HopCheckpointer(str(tmp_path / "a")).propagate_resumable(adj, g.x, 2, device=cuda)
    resumed = HopCheckpointer(str(tmp_path / "a")).propagate_resumable(adj, g.x, 5, device=cuda)
    whole = HopCheckpointer(str(tmp_path / "b")).propagate_resumable(adj, g.x, 5, device=cuda)
    assert resumed.is_cuda and torch.equal(resumed, whole)
    adj_cpu = prepare_csr(symmetric_normalized_weights(g, device="cpu"))
    on_cpu = HopCheckpointer(str(tmp_path / "c")).propagate_resumable(adj_cpu, g.x, 5, device="cpu")
    torch.testing.assert_close(resumed.cpu(), on_cpu, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("msg", range(9))
def test_search_model_on_the_card_matches_the_cpu(cuda, msg):
    """One arch of each message type through a propagation cache: the
    card's features and logits against the CPU path, the same weights."""
    from sgl_tpu_torch.search import PropagationCache, SearchModel

    arch = (1 + msg % 3, 1 + msg % 4, msg, 1 + msg % 3, 2, 1 + msg % 4, msg % 6)
    ds = PlantedPartition(num_nodes=200, feat_dim=12, p_in=0.08, seed=4)
    cpu_model = SearchModel(arch, ds.num_features, ds.num_classes, 16)
    card_model = SearchModel(arch, ds.num_features, ds.num_classes, 16)
    cpu_model.init(torch.Generator().manual_seed(msg))
    card_model.net.load_state_dict(cpu_model.net.state_dict())
    card_model.net.to(cuda)
    out = []
    for m, where in ((cpu_model, torch.device("cpu")), (card_model, cuda)):
        m.preprocess(ds.graph, ds.x, device=where, prop_cache=PropagationCache())
        with torch.no_grad():
            logits = m.net(m.batch_input(torch.arange(ds.num_node, device=where)))
        out.append((m.processed_feature.cpu(), logits.cpu(), m.postprocess(ds.graph, logits).cpu()))
    for got, want in zip(out[1], out[0]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ring_buckets_on_the_card_match_the_cpu_path(cuda, dtype):
    """Every (owner, source block) bucket of the chunked ring layout, reduced
    by K3/K4 on the card into each owner's rows, against the CPU path."""
    from sgl_tpu_torch.parallel import partition_adj_chunked

    g = random_power_law_graph(20_000, 3, 8, seed=0, alpha=1.5)
    dadj = partition_adj_chunked(symmetric_normalized_weights(g, device="cpu"), 4)
    x = torch.randn(4, dadj.block, 32, generator=torch.Generator().manual_seed(0)).to(dtype)
    for o in range(4):
        got = torch.zeros(dadj.block, 32, device=cuda)
        want = torch.zeros(dadj.block, 32)
        for b in range(4):
            spmm_csr_acc(dadj.local(o, cuda).buckets[b], x[b].to(cuda), got)
            spmm_csr_acc(dadj.local(o, "cpu").buckets[b], x[b], want)
        err = ((got.cpu() - want).abs().max() / want.abs().max()).item()
        assert err <= 1e-5, (o, err)


def test_two_gloo_ranks_share_the_card(cuda, tmp_path):
    """Two gloo ranks on cuda:0 (``dev/dist_worker.py``): the ring's blocks go
    through pinned host copies, and both layouts' hops match the one-device
    K1 hops."""
    from sgl_tpu_torch.dev import dist_worker
    from sgl_tpu_torch.ops.graph_ops import k_hop_propagate

    g = random_power_law_graph(20_000, 3, 8, seed=0, alpha=1.5)
    adj = symmetric_normalized_weights(g, device="cpu")
    x = np.asarray(g.x, np.float32)
    np.savez(tmp_path / "in.npz", src=adj.src.numpy(), dst=adj.dst.numpy(), w=adj.w.numpy(),
             num_nodes=g.num_nodes, x=x, prop_steps=2, ids=np.array([0, 5, g.num_nodes - 1]))
    ranks = dist_worker.launch(2, (1, 2), {"checks": ["ring"], "inputs": str(tmp_path / "in.npz")},
                               str(tmp_path / "out"), device="cuda", backend="gloo", limit_s=240)
    want = k_hop_propagate(prepare_csr(symmetric_normalized_weights(g, device=cuda)),
                           torch.as_tensor(x, device=cuda), 2).cpu().numpy()
    for r in ranks:
        for layout in ("segment", "chunked"):
            assert r[f"{layout}_f32_route"] == "gloo, pinned host copies"
            got = r["arrays"][f"{layout}_f32_full"]
            assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5, layout
            got = r["arrays"][f"{layout}_bf16_gather"]
            assert np.abs(got - want).max() / np.abs(want).max() <= 3e-2, layout


def test_tsne_on_the_card_matches_the_cpu(cuda):
    """The port's t-SNE (``tasks/tsne.py``) on the card against the CPU at
    N = 500: the kNN and P (within 1e-6), the gradient at a random y
    (1e-5 of its largest entry) and the embedding after 5 iterations of
    the exaggerated descent (1e-4 of its largest entry).  After 50 the two
    differ by 2.1 × max|y| (measured on an H100): the exaggerated descent
    amplifies rounding, as scikit-learn's does its own from an init one
    float32 ulp away (``tests/test_torch_tsne.py``)."""
    from sgl_tpu_torch.tasks import tsne as T

    rng = np.random.default_rng(0)
    centers = rng.normal(0, 4, (3, 16))
    x = torch.as_tensor((centers[rng.integers(0, 3, 500)] + rng.normal(size=(500, 16))).astype(np.float32))
    y = torch.as_tensor(rng.normal(size=(500, 2)).astype(np.float32) * 5)
    parts = {}
    for dev in (torch.device("cpu"), cuda):
        dist, idx = T.knn_sq_distances(x.to(dev), 91)
        P = T.joint_p(T.conditional_p(dist, 30.0), idx)
        exaggerated = P.scaled(12.0)
        y5 = T.gradient_descent(lambda p, compute_error: T.kl_grad(p, exaggerated, 1, compute_error),
                                 T.pca_init(x.to(dev)), 0, 5, n_iter_check=50, n_iter_without_progress=250,
                                 momentum=0.5, learning_rate=50.0)[0]
        parts[dev.type] = dict(idx=idx.cpu(), rowptr=P.rowptr.cpu(), col=P.col.cpu(), val=P.val.cpu(),
                               grad=T.kl_grad(y.to(dev), P)[1].cpu(), y5=y5.cpu())
    cpu, card = parts["cpu"], parts["cuda"]
    assert torch.equal(cpu["idx"], card["idx"])
    assert torch.equal(cpu["col"], card["col"]) and torch.equal(cpu["rowptr"], card["rowptr"])
    assert (cpu["val"] - card["val"]).abs().max().item() <= 1e-6
    assert ((cpu["grad"] - card["grad"]).abs().max() / cpu["grad"].abs().max()).item() <= 1e-5
    assert ((cpu["y5"] - card["y5"]).abs().max() / cpu["y5"].abs().max()).item() <= 1e-4
