"""The port's graph transforms, degrees and scipy interop against
``sgl_tpu``'s on the same graph, on the CPU.  The random transforms get a
numpy ``Generator`` made from the same seed in each package, so both draw
the same edges and nodes.  Every array is compared exactly; the
propagation after a node reordering within rtol 1e-5."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sgl_tpu.graph as J
import sgl_tpu_torch.graph as P
from sgl_tpu_torch.kernels import spmm
from tests.conftest import random_graph
from tests.test_torch_graph import assert_graphs_equal, to_port_graph

CPU = torch.device("cpu")


@pytest.fixture
def graphs():
    jg = random_graph(n=60, avg_deg=6, d=4, seed=8, weighted=True)
    return to_port_graph(jg), jg


def _both(name, graphs, *args, **kw):
    g, jg = graphs
    return getattr(P, name)(g, *args, **kw), getattr(J, name)(jg, *args, **kw)


def _rng(seed):
    return np.random.default_rng(seed)


def test_drop_edges_match(graphs):
    mask = _rng(0).random(graphs[0].num_edges) < 0.6
    for force in (False, True):
        assert_graphs_equal(*_both("drop_edges", graphs, mask, force_undirected=force))
    with pytest.raises(ValueError):
        P.drop_edges(graphs[0], mask[:-1])


@pytest.mark.parametrize("force_undirected", [False, True])
@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_random_drop_edges_match(graphs, p, force_undirected):
    g, jg = graphs
    got = P.random_drop_edges(g, p=p, force_undirected=force_undirected, seed=_rng(5))
    want = J.random_drop_edges(jg, p=p, force_undirected=force_undirected, seed=_rng(5))
    assert_graphs_equal(got, want)
    assert (got is g) == (p == 0.0)
    # an integer seed draws as a Generator made from it
    assert_graphs_equal(P.random_drop_edges(g, p=0.5, seed=3), J.random_drop_edges(jg, p=0.5, seed=3))
    with pytest.raises(ValueError):
        P.random_drop_edges(g, p=1.5)


def test_biased_drop_add_and_delete_repeated_match(graphs):
    g, jg = graphs
    mask = np.ones(g.num_edges, bool)
    mask[::7] = False
    assert_graphs_equal(*_both("biased_drop_edges", graphs, mask))
    s, d, v = g.edges()
    for del_repeated in (False, True):
        assert_graphs_equal(*_both("add_edges", graphs, s[:9], d[:9], v[:9] * 2, del_repeated=del_repeated))
    assert_graphs_equal(*_both("add_edges", graphs, [0, 1], [2, 3]))
    doubled = P.add_edges(g, s[:5], d[:5])
    assert_graphs_equal(P.delete_repeated_edges(doubled), J.delete_repeated_edges(J.add_edges(jg, s[:5], d[:5])))
    with pytest.raises(ValueError):
        P.add_edges(g, [0], [999])


@pytest.mark.parametrize("by_src", [True, False])
def test_sort_edges_match(graphs, by_src):
    got, want = _both("sort_edges", graphs, by_src=by_src)
    assert_graphs_equal(got, want)


def test_self_loops_match(graphs):
    g, jg = graphs
    assert_graphs_equal(*_both("add_self_loops", graphs))
    vals = _rng(2).random(g.num_nodes).astype(np.float32)
    with_loops = P.add_self_loops(g, vals)
    assert_graphs_equal(with_loops, J.add_self_loops(jg, vals))
    assert_graphs_equal(P.remove_self_loops(with_loops), J.remove_self_loops(J.add_self_loops(jg, vals)))
    with pytest.raises(ValueError):
        P.add_self_loops(g, vals[:-1])


@pytest.mark.parametrize("kind", [0, 1, 2])
def test_mask_features_match(graphs, kind):
    x = graphs[0].x
    shape = {0: x.shape[0], 1: x.shape[1], 2: x.shape}[kind]
    mask = _rng(kind).random(shape) < 0.3
    np.testing.assert_array_equal(P.mask_features(x, mask, kind), J.mask_features(x, mask, kind))
    with pytest.raises(ValueError):
        P.mask_features(x, mask, kind=5)


@pytest.mark.parametrize("keep_ids", [False, True])
def test_get_subgraph_match(graphs, keep_ids):
    keep = _rng(4).random(graphs[0].num_nodes) < 0.6
    assert_graphs_equal(*_both("get_subgraph", graphs, keep, keep_ids=keep_ids))


def test_random_drop_nodes_match(graphs):
    g, jg = graphs
    got, mask = P.random_drop_nodes(g, p=0.3, seed=_rng(9))
    want, jmask = J.random_drop_nodes(jg, p=0.3, seed=_rng(9))
    np.testing.assert_array_equal(mask, jmask)
    assert_graphs_equal(got, want)
    assert got.num_nodes == int(mask.sum())


def test_to_undirected_match():
    rng = _rng(11)
    src, dst = rng.integers(0, 50, 300), rng.integers(0, 50, 300)
    x = rng.normal(size=(50, 3)).astype(np.float32)
    g = P.Graph.from_coo(src, dst, num_nodes=50, x=x)
    jg = J.Graph.from_coo(src, dst, num_nodes=50, x=x)
    assert_graphs_equal(P.to_undirected(g), J.to_undirected(jg))


def test_orderings_and_reorder_match():
    jg = random_graph(n=120, avg_deg=8, d=6, seed=51)
    g = to_port_graph(jg)
    base = spmm(P.symmetric_normalized_weights(g, device=CPU), torch.as_tensor(g.x)).numpy()
    for descending in (True, False):
        np.testing.assert_array_equal(P.degree_ordering(g, descending), J.degree_ordering(jg, descending))
    np.testing.assert_array_equal(P.rcm_ordering(g), J.rcm_ordering(jg))
    for perm in (P.rcm_ordering(g), P.degree_ordering(g), _rng(0).permutation(120)):
        g2 = P.reorder_nodes(g, perm)
        assert_graphs_equal(g2, J.reorder_nodes(jg, perm))
        out = spmm(P.symmetric_normalized_weights(g2, device=CPU), torch.as_tensor(g2.x)).numpy()
        np.testing.assert_allclose(out[perm], base, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        P.reorder_nodes(g, np.zeros(120, np.int64))


def test_degrees_match(graphs):
    g, jg = graphs
    np.testing.assert_array_equal(g.node_degrees(), jg.node_degrees())
    np.testing.assert_array_equal(g.in_degrees(), jg.in_degrees())


def test_scipy_roundtrip_matches():
    rng = _rng(12)
    a = sp.random(80, 80, density=0.06, random_state=3, format="csr", dtype=np.float32)
    x = rng.normal(size=(80, 5)).astype(np.float32)
    y = rng.integers(0, 3, 80)
    for pad in (1, 256):
        g = P.from_scipy(a, x=x, y=y, pad_multiple=pad)
        assert_graphs_equal(g, J.from_scipy(a, x=x, y=y, pad_multiple=pad))
    back, jback = P.to_scipy(g), J.to_scipy(J.from_scipy(a, x=x, y=y))
    assert (back != jback).nnz == 0 and (back != a).nnz == 0
    assert back.shape == (80, 80)
