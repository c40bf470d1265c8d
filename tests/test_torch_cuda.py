"""The port's CUDA kernels on the card, held against their plain twins.

These tests need a CUDA GPU and skip elsewhere.  The file imports no JAX, so
it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sgl_tpu_torch.datasets import PlantedPartition, random_power_law_graph
from sgl_tpu_torch.graph import symmetric_normalized_weights
from sgl_tpu_torch.kernels import (
    prepare_csr,
    prepare_csr_parts,
    spmm,
    spmm_csr,
    spmm_csr_acc,
    spmm_csr_acc_reference,
    spmm_csr_reference,
    spmm_csr_streaming,
    spmm_csr_streaming_reference,
)
from sgl_tpu_torch.models import SGC
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
