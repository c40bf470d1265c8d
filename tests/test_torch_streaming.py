"""Streaming SpMM and the products-scale pipeline of the PyTorch port against
``sgl_tpu``, on the CPU (the plain versions; the CUDA kernels are held
against the same plain versions on the card in ``test_torch_cuda.py``).

The TPU path runs its Pallas kernels with ``interpret=True``, as
``tests/test_kernels.py`` runs them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_tpu.datasets.synthetic import random_power_law_graph as j_random_power_law_graph
from sgl_tpu.graph import symmetric_normalized_weights as j_sym
from sgl_tpu.kernels import prepare_chunked_parts, spmm_pallas_streaming
from sgl_tpu.kernels.pallas_spmm import CHUNK
from sgl_tpu.models.homo import GAMLP as JGAMLP
from sgl_tpu.tasks.utils import adam_l2 as j_adam_l2
from sgl_tpu.tasks.utils import init_train_state
from sgl_tpu.tasks.utils import make_eval_step as j_make_eval_step
from sgl_tpu.tasks.utils import make_train_step as j_make_train_step
from sgl_tpu_torch import convert
from sgl_tpu_torch.datasets import random_power_law_graph
from sgl_tpu_torch.examples import products_scale_demo
from sgl_tpu_torch.graph import symmetric_normalized_weights
from sgl_tpu_torch.kernels import (
    SparseAdj,
    prepare_csr,
    prepare_csr_parts,
    spmm_csr,
    spmm_csr_acc,
    spmm_csr_acc_reference,
    spmm_csr_reference,
    spmm_csr_streaming,
    spmm_csr_streaming_reference,
    spmm_segment,
)
from sgl_tpu_torch.kernels.spmm_csr import SPLIT_NNZ
from sgl_tpu_torch.models import GAMLP
from tests.conftest import random_graph
from tests.test_torch_graph import to_port_graph
from tests.test_torch_spmm import _star_power_law, check_plan_covers_rows

CPU = torch.device("cpu")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _power_law_csr(n=600, deg=10, d=8, seed=5):
    """A CSR whose node 0 is a hub (a row many parts cut), with its features."""
    g = random_power_law_graph(n, deg, d, seed=seed)
    return prepare_csr(symmetric_normalized_weights(g, device=CPU)), torch.as_tensor(g.x)


def _gappy_csr(n=40, nnz=400, d=8, seed=1):
    """A CSR with a hub row (3) and empty rows (every 5th), not normalized."""
    rng = np.random.default_rng(seed)
    dst = np.where(rng.random(nnz) < 0.4, 3, rng.integers(0, n, nnz))
    dst = np.where(dst % 5 == 0, dst + 1, dst)  # rows 0, 5, 10, ... stay empty
    src = rng.integers(0, n, nnz)
    w = rng.random(nnz).astype(np.float32) + 0.5
    adj = SparseAdj(
        torch.as_tensor(src, dtype=torch.int32), torch.as_tensor(dst, dtype=torch.int32),
        torch.as_tensor(w), n,
    )
    return prepare_csr(adj), torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32))


def _global_rows(rowptr, row_offset=0):
    return row_offset + torch.repeat_interleave(
        torch.arange(rowptr.shape[0] - 1), torch.diff(rowptr.long())
    )


# -- (a) the split ------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 7, 100, 333, 1000, 10**9])
def test_prepare_csr_parts_covers_every_nonzero_once_in_order(m):
    adj, _ = _power_law_csr()
    parts = prepare_csr_parts(adj, max_edges_per_part=m)
    assert len(parts) == -(-adj.nnz // m)
    sizes = [p.nnz for p in parts]
    assert max(sizes) - min(sizes) <= 1
    assert parts.nnz == adj.nnz and parts.num_nodes == adj.num_nodes
    # the parts' nonzeros, in order, are the CSR's, each in its own row
    assert torch.equal(torch.cat([p.col for p in parts]), adj.col)
    assert torch.equal(torch.cat([p.val for p in parts]), adj.val)
    rows = torch.cat([_global_rows(p.rowptr, p.row_offset) for p in parts])
    assert torch.equal(rows, _global_rows(adj.rowptr))
    e_lo = 0
    for p in parts:
        # views of the global arrays, not copies
        assert p.col.data_ptr() == adj.col.data_ptr() + 4 * e_lo
        assert p.val.data_ptr() == adj.val.data_ptr() + 4 * e_lo
        assert p.rowptr.dtype == torch.int32 and p.rowptr.shape == (p.num_rows + 1,)
        assert int(p.rowptr[0]) == 0 and int(p.rowptr[-1]) == p.nnz
        # the accumulating kernel checks x's rows against it before it gathers
        assert p.num_nodes == adj.num_nodes
        e_lo += p.nnz


def test_prepare_csr_parts_cuts_rows_between_consecutive_parts():
    adj, _ = _power_law_csr()
    parts = prepare_csr_parts(adj, max_edges_per_part=100)
    glob = _global_rows(adj.rowptr)
    e, cuts = 0, 0
    for a, b in zip(parts.parts[:-1], parts.parts[1:]):
        e += a.nnz
        if glob[e - 1] == glob[e]:  # the boundary falls inside a row
            cuts += 1
            last_a = a.row_offset + a.num_rows - 1
            assert last_a == b.row_offset == int(glob[e])
            assert int(torch.diff(a.rowptr)[-1]) > 0 and int(torch.diff(b.rowptr)[0]) > 0
    assert cuts >= 5  # the hub row alone spans many parts


@pytest.mark.parametrize("m", [100, 2 * SPLIT_NNZ + 3, 10**9])
def test_prepare_csr_parts_gives_each_part_its_own_plan(m):
    # the hub row (several SPLIT_NNZ) is cut between parts, and each share
    # of it longer than SPLIT_NNZ is cut into segments of its own part
    _, g = _star_power_law(n=3000)
    adj = prepare_csr(symmetric_normalized_weights(g, device=CPU))
    parts = prepare_csr_parts(adj, m)
    for part in parts:
        check_plan_covers_rows(part.rowptr, part.plan)
    long_parts = sum(p.plan.num_long > 0 for p in parts)
    if m == 10**9:
        assert parts.parts[0].plan.num_segments == adj.plan.num_segments
    elif m < SPLIT_NNZ:
        assert long_parts == 0  # no share can pass SPLIT_NNZ
    else:
        assert long_parts >= 2, [p.plan.num_long for p in parts]


@pytest.mark.parametrize("m", [0, -3])
def test_prepare_csr_parts_rejects_empty_parts(m):
    adj, _ = _power_law_csr(n=50)
    with pytest.raises(ValueError):
        prepare_csr_parts(adj, max_edges_per_part=m)


# -- (b) the accumulate contract ------------------------------------------------


def _numpy_acc(part, x, acc):
    """A loop over the part's rows, in f32, touching only non-empty rows."""
    rowptr, col, val = part.rowptr.numpy(), part.col.numpy(), part.val.numpy()
    xs = x.float().numpy()
    out = acc.numpy().copy()
    for r in range(part.num_rows):
        if rowptr[r] == rowptr[r + 1]:
            continue
        s = np.zeros(xs.shape[1], np.float32)
        for e in range(rowptr[r], rowptr[r + 1]):
            s += val[e] * xs[col[e]]
        out[part.row_offset + r] += s
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fn", [spmm_csr_acc, spmm_csr_acc_reference], ids=["wrapper", "twin"])
def test_accumulate_adds_the_part_and_keeps_other_rows(fn, dtype):
    adj, x = _gappy_csr()
    x = x.to(DTYPES[dtype])
    parts = prepare_csr_parts(adj, max_edges_per_part=90)
    assert len(parts) >= 4
    acc0 = torch.as_tensor(np.random.default_rng(2).normal(size=(adj.num_nodes, x.shape[1])).astype(np.float32))
    for part in parts:
        want = _numpy_acc(part, x, acc0)
        acc = acc0.clone()
        assert fn(part, x, acc) is acc  # in place
        lo, hi = part.row_offset, part.row_offset + part.num_rows
        touched = np.zeros(adj.num_nodes, bool)
        touched[lo:hi] = (torch.diff(part.rowptr) > 0).numpy()
        # rows the part does not touch, inside or outside its window: bit-exact
        untouched = torch.as_tensor(~touched)
        assert torch.equal(acc[untouched], acc0[untouched])
        np.testing.assert_allclose(acc.numpy()[touched], want[touched], rtol=1e-5, atol=1e-6)


def test_accumulate_window_keeps_its_empty_rows():
    adj, x = _gappy_csr()
    (part,) = prepare_csr_parts(adj, max_edges_per_part=10**6).parts
    empty = torch.diff(part.rowptr) == 0
    assert empty.sum() >= 5  # rows 5, 10, ... lie inside the window
    acc0 = torch.full((adj.num_nodes, x.shape[1]), -0.0)
    acc = spmm_csr_acc(part, x, acc0.clone())
    rows = torch.arange(part.num_rows)[empty] + part.row_offset
    assert torch.equal(torch.signbit(acc[rows]), torch.ones_like(acc[rows], dtype=torch.bool))


def test_accumulate_on_cpu_counts_no_launches_and_checks_devices():
    adj, x = _gappy_csr()
    part = prepare_csr_parts(adj, max_edges_per_part=100).parts[1]
    before = dict(spmm_csr.launches)
    spmm_csr_acc(part, x, torch.zeros(adj.num_nodes, x.shape[1]))
    assert spmm_csr.launches == before
    meta = x.to("meta")
    with pytest.raises(ValueError):
        spmm_csr_acc(part, meta, torch.zeros(adj.num_nodes, x.shape[1], device="meta"))


# -- (c, d) streaming against the TPU path --------------------------------------


def _jax_streaming(jg, x, m):
    bundle = prepare_chunked_parts(j_sym(jg), max_edges_per_part=m)
    return bundle[0].num_parts, np.asarray(spmm_pallas_streaming(bundle, x, interpret=True), np.float32)


# m = 2*CHUNK takes the TPU path's unrolled accumulate kernel (<= 24 parts),
# m = CHUNK its scan (more than 24 parts)
@pytest.mark.parametrize("m,branch", [(2 * CHUNK, "unrolled"), (CHUNK, "scan")])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_streaming_matches_pallas_streaming(m, branch, dtype):
    jg = random_graph(n=1500, avg_deg=10, d=12, seed=13)
    jx = jnp.asarray(jg.x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    n_parts, want = _jax_streaming(jg, jx, m)
    assert (n_parts > 24) == (branch == "scan"), n_parts
    g = to_port_graph(jg)
    parts = prepare_csr_parts(prepare_csr(symmetric_normalized_weights(g, device=CPU)), m)
    assert len(parts) > 1
    got = spmm_csr_streaming(parts, torch.as_tensor(g.x).to(DTYPES[dtype]))
    assert got.dtype == DTYPES[dtype] and got.shape == tuple(jg.x.shape)
    if dtype == "f32":
        # the TPU path's hi/lo halves carry 2^-16 relative error per message
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    else:
        assert np.abs(got.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_streaming_long_row_cut_matches_pallas_streaming(dtype):
    # node 0's row (several SPLIT_NNZ) spans parts that each hold more than
    # SPLIT_NNZ of it: each part cuts its share into segments and adds
    # their sum once
    jg, g = _star_power_law(n=3000, d=12, seed=6)
    m = 4 * CHUNK
    jx = jnp.asarray(jg.x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    _, want = _jax_streaming(jg, jx, m)
    parts = prepare_csr_parts(prepare_csr(symmetric_normalized_weights(g, device=CPU)), m)
    cut_long = [p.plan.num_long > 0 for p in parts]
    assert sum(cut_long) >= 2 and parts.parts[0].row_offset == parts.parts[1].row_offset == 0
    got = spmm_csr_streaming(parts, torch.as_tensor(g.x).to(DTYPES[dtype]))
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    else:
        assert np.abs(got.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()


# -- (e) streaming against the one-shot product ---------------------------------


@pytest.mark.parametrize("m", [1, 37, 512, 10**9])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_streaming_matches_one_shot(m, dtype):
    adj, x = _power_law_csr(n=400, deg=12, d=16, seed=7)
    x = x.to(DTYPES[dtype])
    parts = prepare_csr_parts(adj, m)
    got = spmm_csr_streaming(parts, x)
    want = spmm_csr(adj, x)
    assert got.dtype == x.dtype
    if m == 10**9:
        # one part: its plan is the one-shot plan, so every row sums in the
        # one-shot order and the results are the same bits
        assert torch.equal(got, want)
    elif m == 1:
        # one nonzero per part: streaming adds each row's terms one by one
        # in edge order, the same bits as one sequential f32 sum per row;
        # one-shot sums a row of more than SPLIT_NNZ (this graph's hub holds
        # 581) as segments added in order, another f32 order of those terms
        lengths = torch.diff(adj.rowptr.long())
        assert int(lengths.max()) > SPLIT_NNZ
        rows = torch.repeat_interleave(torch.arange(adj.num_nodes, dtype=torch.int32), lengths)
        assert torch.equal(got, spmm_segment(SparseAdj(adj.col, rows, adj.val, adj.num_nodes, True), x))
        assert torch.equal(want, spmm_csr_reference(adj, x))
        assert _rel(got.float().numpy(), want.float().numpy()) <= (1e-5 if dtype == "f32" else 1e-2)
    else:
        # a row cut between parts sums each share apart, then adds the
        # shares (1.1e-6 of max|y| on this graph's hub row at m = 37, the
        # limit the card holds the kernels to); bf16 rounds once more
        assert _rel(got.float().numpy(), want.float().numpy()) <= (1e-5 if dtype == "f32" else 1e-2)
    assert torch.equal(spmm_csr_streaming_reference(parts, x), got)


def test_streaming_checks_the_feature_rows():
    adj, x = _power_law_csr(n=60)
    with pytest.raises(ValueError):
        spmm_csr_streaming(prepare_csr_parts(adj, 50), x[:-1])


# -- (f, g) the products-scale pipeline at a small size ---------------------------

SMALL = dict(n=3000, avg_deg=10, d=16, hops=3, part_edges=2048)


@pytest.fixture(scope="module")
def small_run():
    return products_scale_demo.main(**SMALL, device="cpu")


def test_pipeline_hops_match_the_jax_composition(small_run):
    # the JAX demo returns nothing: compose the functions its main() calls
    # (its native host normalization is held equal to this one by
    # tests/test_native.py::test_full_build_matches_jax_normalize)
    jg = j_random_power_law_graph(SMALL["n"], SMALL["avg_deg"], SMALL["d"], seed=0)
    bundle = prepare_chunked_parts(j_sym(jg), max_edges_per_part=SMALL["part_edges"])
    h = jnp.asarray(jg.x)
    want = [np.asarray(h)]
    for _ in range(SMALL["hops"]):
        h = spmm_pallas_streaming(bundle, h, interpret=True)
        want.append(np.asarray(h))
    got = small_run["hops"]
    assert got.shape == (SMALL["hops"] + 1, SMALL["n"], SMALL["d"]) and got.dtype == torch.float32
    assert len(small_run["hop_seconds"]) == SMALL["hops"]
    assert len(small_run["parts"]) == -(-small_run["nnz"] // SMALL["part_edges"])
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=1e-4, atol=1e-5)


def test_pipeline_gamlp_step_and_eval_match(small_run):
    stack = small_run["hops"]
    k1, n, d = stack.shape
    classes, hidden = 47, 64
    jm = JGAMLP(k1 - 1, d, classes, hidden_dim=hidden, num_layers=3, dropout=0.0)
    jstack = jnp.asarray(stack.numpy())
    jm.processed_feature = jstack
    params = jm.init(jax.random.PRNGKey(0))
    m = GAMLP(k1 - 1, d, classes, hidden_dim=hidden, num_layers=3, dropout=0.0)
    convert.load_flax_params(m, jax.tree_util.tree_map(np.asarray, jax.device_get(params)))
    got = products_scale_demo.train_at_scale(m, stack, warmup=0, measured=1)

    # the same step in sgl_tpu, on the same stack, rows and labels
    rng = np.random.default_rng(0)
    tr_idx = rng.choice(n, size=min(products_scale_demo.TRAIN_ROWS, n), replace=False)
    labels = jnp.asarray(rng.integers(0, classes, tr_idx.shape[0]), jnp.int32)
    net = jm.net

    def apply(p, f, train, rngs):
        return net.apply(p, f, train=train, rngs=rngs)

    tx = j_adam_l2(0.1, 5e-5)
    state = init_train_state(jax.random.PRNGKey(0), params, tx)
    state, jloss, _ = j_make_train_step(apply, tx)(
        state, jm.batch_input(jnp.asarray(tr_idx)), labels, jnp.ones(tr_idx.shape[0])
    )
    assert len(got["losses"]) == 1
    np.testing.assert_allclose(got["losses"][0], float(jloss), rtol=1e-4)
    want_model = GAMLP(k1 - 1, d, classes, hidden_dim=hidden, num_layers=3, dropout=0.0)
    convert.load_flax_params(want_model, jax.tree_util.tree_map(np.asarray, jax.device_get(state.params)))
    want = want_model.net.state_dict()
    for name, value in m.net.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6, err_msg=name)
    correct, total = j_make_eval_step(apply)(state.params, jstack, jnp.zeros(n, jnp.int32), jnp.ones(n))
    assert float(total) == n
    assert abs(got["eval_correct"] - float(correct)) <= 2  # argmax near-ties only
    assert got["train_ms_per_step"] > 0 and got["eval_ms"] > 0


def test_pipeline_runs_on_the_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU refusal; this machine has a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        products_scale_demo.main(**SMALL)
