"""SpMM and k-hop propagation of the PyTorch port against ``sgl_tpu``, on
the CPU (the plain versions; the CUDA kernel is held against the same plain
versions on the card in ``test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_tpu.graph import symmetric_normalized_weights as j_sym
from sgl_tpu.kernels import prepare_chunked, spmm_pallas
from sgl_tpu.kernels.sparse import spmm_segment as j_spmm_segment
from sgl_tpu.ops.graph_ops import k_hop_aggregate as j_k_hop_aggregate
from sgl_tpu.ops.graph_ops import k_hop_propagate as j_k_hop_propagate
from sgl_tpu_torch.graph import symmetric_normalized_weights
from sgl_tpu_torch.kernels import SparseAdj, prepare_csr, spmm, spmm_csr
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
