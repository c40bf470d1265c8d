"""Graph layer of the PyTorch port against ``sgl_tpu``: containers,
synthetic datasets, normalization and the CSR layout, on the CPU."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sgl_tpu.datasets.synthetic as jsyn
from sgl_tpu.graph import Graph as JGraph
from sgl_tpu.graph import ppr_weights as j_ppr
from sgl_tpu.graph import row_normalized_weights as j_row
from sgl_tpu.graph import symmetric_normalized_weights as j_sym
from sgl_tpu_torch.datasets import (
    PlantedPartition,
    SyntheticPowerLaw,
    random_power_law_graph,
    random_split,
)
from sgl_tpu_torch.graph import Graph, ppr_weights, row_normalized_weights, symmetric_normalized_weights
from sgl_tpu_torch.kernels import prepare_csr
from tests.conftest import random_graph

CPU = torch.device("cpu")


def to_port_graph(g: JGraph) -> Graph:
    """The same padded-COO arrays in the port's container."""
    return Graph(
        np.array(g.src), np.array(g.dst), np.array(g.val),
        None if g.x is None else np.array(g.x),
        None if g.y is None else np.array(g.y),
        g.num_nodes, g.num_edges,
    )


def assert_graphs_equal(got: Graph, want: JGraph) -> None:
    assert (got.num_nodes, got.num_edges) == (want.num_nodes, want.num_edges)
    for name in ("src", "dst", "val", "x", "y"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)), name)


@pytest.mark.parametrize("pad_multiple", [1, 256])
@pytest.mark.parametrize("weighted", [False, True])
def test_from_coo_matches(pad_multiple, weighted):
    rng = np.random.default_rng(0)
    n, e = 90, 700
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    val = rng.random(e).astype(np.float32) if weighted else None
    x = rng.normal(size=(n, 5)).astype(np.float32)
    y = rng.integers(0, 3, n)
    kw = dict(num_nodes=n, x=x, y=y, pad_multiple=pad_multiple)
    got = Graph.from_coo(src, dst, val, **kw)
    assert_graphs_equal(got, JGraph.from_coo(src, dst, val, **kw))
    s, d, v = got.edges()
    assert s.shape == (e,) and got.num_edges_padded % pad_multiple == 0
    assert np.all(np.diff(got.dst) >= 0)  # dst-sorted, padding included
    assert got.num_features == 5 and got.num_classes == 3


def test_from_coo_rejects_out_of_range():
    with pytest.raises(ValueError):
        Graph.from_coo([0, 5], [1, 2], num_nodes=5)


def test_planted_partition_matches():
    got, want = PlantedPartition(seed=3), jsyn.PlantedPartition(seed=3)
    assert_graphs_equal(got.graph, want.graph)
    for split in ("train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(got, split), getattr(want, split))
    assert (got.num_node, got.num_features, got.num_classes) == (
        want.num_node, want.num_features, want.num_classes)


def test_random_power_law_graph_matches():
    kw = dict(num_nodes=3000, avg_degree=10, feat_dim=12, seed=4)
    assert_graphs_equal(random_power_law_graph(**kw), jsyn.random_power_law_graph(**kw))


def test_synthetic_power_law_matches():
    kw = dict(num_nodes=4000, avg_degree=8, feat_dim=16, num_classes=6, seed=2)
    got, want = SyntheticPowerLaw(**kw), jsyn.SyntheticPowerLaw(**kw)
    assert_graphs_equal(got.graph, want.graph)
    np.testing.assert_array_equal(got.test_idx, want.test_idx)


def test_random_split_matches():
    from sgl_tpu.datasets.base import random_split as j_split

    for a, b in zip(random_split(101, 0.5, 0.2, seed=9), j_split(101, 0.5, 0.2, seed=9)):
        np.testing.assert_array_equal(a, b)


def test_dataset_to_device():
    ds = PlantedPartition()
    split = ds.to_device("cpu")
    assert split.y.dtype == torch.int64 and split.y.shape == (ds.num_node,)
    np.testing.assert_array_equal(split.train_idx.numpy(), ds.train_idx)


def _assert_adj_matches(got, want):
    np.testing.assert_array_equal(got.src.numpy(), np.asarray(want.src))
    np.testing.assert_array_equal(got.dst.numpy(), np.asarray(want.dst))
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=1e-5, atol=1e-7)
    assert got.sorted_by_dst and got.num_nodes == want.num_nodes


@pytest.mark.parametrize("r", [0.5, 0.3])
@pytest.mark.parametrize("weighted", [False, True])
def test_symmetric_normalized_weights_match(r, weighted):
    jg = random_graph(weighted=weighted, seed=1)
    got = symmetric_normalized_weights(to_port_graph(jg), r=r, device=CPU)
    _assert_adj_matches(got, j_sym(jg, r=r))


@pytest.mark.parametrize("alpha", [0.15, 0.3])
def test_ppr_weights_match(alpha):
    jg = random_graph(seed=5)
    got = ppr_weights(to_port_graph(jg), r=0.5, alpha=alpha, device=CPU)
    _assert_adj_matches(got, j_ppr(jg, r=0.5, alpha=alpha))


def test_row_normalized_weights_match():
    jg = random_graph(seed=7)
    _assert_adj_matches(row_normalized_weights(to_port_graph(jg), device=CPU), j_row(jg))


@pytest.mark.parametrize("sort", [True, False])
def test_prepare_csr_matches_scipy(sort):
    jg = random_graph(n=180, weighted=True, seed=11)
    adj = symmetric_normalized_weights(to_port_graph(jg), device=CPU, sort=sort)
    csr = prepare_csr(adj)
    n = jg.num_nodes
    # graph padding (w == 0) is gone: real edges plus one self-loop per node
    assert csr.nnz == jg.num_edges + n
    assert csr.rowptr.dtype == csr.col.dtype == torch.int32 and csr.val.dtype == torch.float32
    w = adj.w.numpy()
    keep = w != 0
    want = sp.csr_matrix(
        (w[keep], (adj.dst.numpy()[keep], adj.src.numpy()[keep])), shape=(n, n)
    )
    want.sort_indices()
    got = sp.csr_matrix((csr.val.numpy(), csr.col.numpy(), csr.rowptr.numpy()), shape=(n, n))
    got.sort_indices()
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=1e-6)
