"""K1's gradient and the sparse helpers of the port, on the CPU.

``spmm``'s backward (``dx = Aᵀ g``) against ``jax.grad`` of ``sgl_tpu``'s
``spmm`` and of ``spmm_pallas`` on a split layout (interpret mode, as
``tests/test_kernels.py`` runs it), a float64 ``gradcheck`` of the plain
path, the transposed CSR against a dense transpose, and ``spmm_multi``,
``sddmm`` and ``ensure_device_layout`` against ``sgl_tpu``.  The card's
cases are in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_tpu.graph import symmetric_normalized_weights as j_sym
from sgl_tpu.kernels import prepare_chunked, spmm_pallas
from sgl_tpu.kernels.sparse import sddmm as j_sddmm
from sgl_tpu.kernels.sparse import spmm as j_spmm
from sgl_tpu.kernels.sparse import spmm_multi as j_spmm_multi
from sgl_tpu_torch.graph import symmetric_normalized_weights
from sgl_tpu_torch.kernels import (
    SparseAdj,
    ensure_device_layout,
    prepare_csr,
    sddmm,
    spmm,
    spmm_csr,
    spmm_multi,
    transpose_csr,
    transposed,
)
from sgl_tpu_torch.kernels.spmm_csr import SPLIT_NNZ
from tests.conftest import random_graph
from tests.test_torch_graph import to_port_graph

CPU = torch.device("cpu")
RTOL = 1e-5


def _graphs(n=200, avg_deg=10, d=8, seed=19, weighted=False):
    jg = random_graph(n=n, avg_deg=avg_deg, d=d, seed=seed, weighted=weighted)
    return jg, to_port_graph(jg)


def _port_grad(adj, x: np.ndarray) -> np.ndarray:
    xt = torch.tensor(x, requires_grad=True)
    (spmm(adj, xt) ** 2).sum().backward()
    return xt.grad.numpy()


def _dense(csr) -> np.ndarray:
    rows = np.repeat(np.arange(csr.num_nodes), np.diff(csr.rowptr.numpy()))
    a = np.zeros((csr.num_nodes, csr.num_nodes), np.float32)
    np.add.at(a, (rows, csr.col.numpy()), csr.val.numpy())
    return a


@pytest.mark.parametrize("r", [0.5, 0.3])
@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_spmm_grad_matches_jax_grad(layout, r):
    jg, g = _graphs(weighted=True)
    x = np.asarray(jg.x)
    jadj = j_sym(jg, r=r)
    want = np.asarray(jax.grad(lambda v: jnp.sum(j_spmm(jadj, v) ** 2))(jnp.asarray(x)))
    adj = symmetric_normalized_weights(g, r=r, device=CPU)
    got = _port_grad(prepare_csr(adj) if layout == "csr" else adj, x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_spmm_grad_matches_the_pallas_vjp_on_a_split_layout():
    """``spmm_pallas``'s custom VJP with its diag/hub carriers
    (``tests/test_kernels.py::test_pallas_spmm_split_grad``'s layout),
    against the port's, which carries every edge in its CSR."""
    jg, g = _graphs()
    x = np.asarray(jg.x)
    ch = prepare_chunked(j_sym(jg, sort=True), split_diag=True, hub_k=16)
    assert ch.hub_ids is not None and ch.diag is not None
    want = np.asarray(jax.grad(lambda v: jnp.sum(spmm_pallas(ch, v, True) ** 2))(jnp.asarray(x)))
    got = _port_grad(prepare_csr(symmetric_normalized_weights(g, device=CPU)), x)
    # the TPU kernel's hi/lo bf16 halves carry ~2^-16 of each message
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_spmm_gradcheck_float64_on_the_plain_path(layout):
    _, g = _graphs(n=40, avg_deg=4, d=3, seed=5, weighted=True)
    adj = symmetric_normalized_weights(g, r=0.3, device=CPU)
    if layout == "csr":
        # the CSR twin sums in f32 like its kernel: gradcheck the float64
        # product on the same nonzeros as an edge list
        csr = prepare_csr(adj)
        rows = torch.repeat_interleave(torch.arange(csr.num_nodes, dtype=torch.int32),
                                       torch.diff(csr.rowptr.long()))
        adj = SparseAdj(csr.col, rows, csr.val, csr.num_nodes, True)
    x = torch.randn(g.num_nodes, 3, dtype=torch.float64, requires_grad=True,
                    generator=torch.Generator().manual_seed(0))
    assert torch.autograd.gradcheck(lambda v: spmm(adj, v), (x,))


def test_spmm_without_grad_records_nothing_and_keeps_the_bits():
    _, g = _graphs(seed=3)
    csr = prepare_csr(symmetric_normalized_weights(g, device=CPU))
    x = torch.as_tensor(g.x)
    plain = spmm(csr, x)
    assert plain.grad_fn is None
    with_grad = spmm(csr, x.clone().requires_grad_(True))
    assert with_grad.grad_fn is not None
    assert torch.equal(plain, with_grad.detach())
    with torch.no_grad():
        assert spmm(csr, x.clone().requires_grad_(True)).grad_fn is None


@pytest.mark.parametrize("r", [0.5, 0.3])
def test_transposed_csr_equals_the_dense_transpose(r):
    _, g = _graphs()
    csr = prepare_csr(symmetric_normalized_weights(g, r=r, device=CPU))
    t = transpose_csr(csr)
    a, at = _dense(csr), _dense(t)
    np.testing.assert_array_equal(at, a.T)
    # r = 0.5 on an undirected graph is symmetric (up to the order of the
    # products of the weights); r = 0.3 only in pattern
    assert np.allclose(a, a.T, rtol=1e-6, atol=0) == (r == 0.5)
    assert np.array_equal(a != 0, a.T != 0)
    # stable by column: each transposed row keeps the original row order
    rows = np.repeat(np.arange(t.num_nodes), np.diff(t.rowptr.numpy()))
    order = np.lexsort((t.col.numpy(), rows))
    np.testing.assert_array_equal(order, np.arange(t.nnz))
    assert t.plan.rowptr is t.rowptr and t.plan.split == SPLIT_NNZ
    assert transposed(csr) is transposed(csr)


def test_transposed_csr_cuts_a_long_column_into_segments():
    """One node gathered by 1,300 rows: a long row of ``Aᵀ`` (a hub source)."""
    n = 1400
    src = np.zeros(n - 1, np.int32)
    dst = np.arange(1, n, dtype=np.int32)
    w = np.linspace(0.1, 1.0, n - 1).astype(np.float32)
    csr = prepare_csr(SparseAdj(torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(w), n))
    t = transposed(csr)
    assert t.plan.num_long == 1 and t.plan.num_segments == -(-(n - 1) // SPLIT_NNZ)
    g = torch.randn(n, 5, generator=torch.Generator().manual_seed(1))
    x = torch.zeros(n, 5, requires_grad=True)
    (spmm(csr, x) * g).sum().backward()
    want = torch.zeros(n, 5)
    want[0] = (torch.as_tensor(w)[:, None] * g[1:]).sum(0)
    torch.testing.assert_close(x.grad, want, rtol=RTOL, atol=1e-5)
    torch.testing.assert_close(spmm_csr(t, g), want, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("shared_x", [False, True])
def test_spmm_multi_matches_sgl_tpu(shared_x):
    jg, g = _graphs(seed=7)
    rs = (0.5, 0.3, 0.0)
    rng = np.random.default_rng(2)
    x = np.asarray(jg.x) if shared_x else rng.normal(size=(3, g.num_nodes, 8)).astype(np.float32)
    want = np.asarray(j_spmm_multi([j_sym(jg, r=r) for r in rs], jnp.asarray(x)))
    got = spmm_multi([symmetric_normalized_weights(g, r=r, device=CPU) for r in rs], torch.as_tensor(x))
    assert got.shape == (3, g.num_nodes, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)


def test_spmm_multi_rejects_mismatched_inputs():
    _, g = _graphs(seed=7)
    adjs = [symmetric_normalized_weights(g, r=r, device=CPU) for r in (0.5, 0.3)]
    with pytest.raises(ValueError):
        spmm_multi(adjs, torch.zeros(3, g.num_nodes, 4))
    short = SparseAdj(adjs[1].src[:-1], adjs[1].dst[:-1], adjs[1].w[:-1], g.num_nodes)
    with pytest.raises(ValueError):
        spmm_multi([adjs[0], short], torch.zeros(g.num_nodes, 4))


def test_sddmm_matches_sgl_tpu():
    jg, g = _graphs(seed=8)
    rng = np.random.default_rng(3)
    a, b = (rng.normal(size=(g.num_nodes, 6)).astype(np.float32) for _ in range(2))
    want = np.asarray(j_sddmm(j_sym(jg), jnp.asarray(a), jnp.asarray(b)))
    got = sddmm(symmetric_normalized_weights(g, device=CPU), torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)


def test_ensure_device_layout_keeps_cpu_adjacencies_and_csrs():
    _, g = _graphs(seed=9)
    adj = symmetric_normalized_weights(g, device=CPU)
    assert ensure_device_layout(adj) is adj
    csr = prepare_csr(adj)
    assert ensure_device_layout(csr) is csr
