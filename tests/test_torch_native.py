"""The port's native graph builder (``sgl_tpu_torch/graph/native.py``, its
own copy of the C++ under ``sgl_tpu_torch/graph/csrc/``) against its numpy
fallback and against ``sgl_tpu.graph.native``, and the host normalization
against the device one, on the CPU.

Tolerances: sorts, gathers and edge orders exact; f32 degrees rtol 1e-6
(the threads' partial sums add in another order); weights rtol 1e-6 (powf
against torch's pow)."""

import numpy as np
import pytest
import torch

import sgl_tpu.datasets.synthetic as jsyn
from sgl_tpu.graph import Graph as JGraph
from sgl_tpu.graph import native as jnative
from sgl_tpu.graph import normalize as jnorm
from sgl_tpu_torch.datasets import random_power_law_graph
from sgl_tpu_torch.graph import (
    HOST_NORM_EDGE_THRESHOLD,
    Graph,
    native,
    ppr_weights,
    ppr_weights_host,
    symmetric_normalized_weights,
    symmetric_normalized_weights_host,
)
from sgl_tpu_torch.graph.graph import NATIVE_SORT_EDGES
from tests.test_torch_graph import assert_graphs_equal

CPU = torch.device("cpu")


@pytest.fixture
def fallback(monkeypatch):
    """The numpy fallbacks, as on a host without g++."""
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.native_available()


def _edges(n_nodes=500, n_edges=5000, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, n_nodes, n_edges).astype(np.int32),
        rng.integers(0, n_nodes, n_edges).astype(np.int32),
        rng.random(n_edges).astype(np.float32),
    )


def test_native_builds_from_the_ports_own_source():
    assert native.native_available()
    assert native.SOURCE.parts[-4:] == ("sgl_tpu_torch", "graph", "csrc", "graph_builder.cpp")
    assert "sgl_tpu_torch" in str(native._build.build_host(native.SOURCE)).replace("\\", "/")


def test_edge_order_above_one_million_edges_matches_sgl_tpu():
    """The fault of ROADMAP §3: above 1,000,000 edges the port's src order
    within a row differed from ``sgl_tpu``'s (1,376,468 positions)."""
    got = random_power_law_graph(60_000, 25, 64, seed=0)
    want = jsyn.random_power_law_graph(60_000, 25, 64, seed=0)
    assert got.num_edges == 1_499_972 > NATIVE_SORT_EDGES
    for name in ("src", "dst", "val"):
        assert np.array_equal(getattr(got, name), np.asarray(getattr(want, name))), name


@pytest.mark.parametrize("n_edges", [NATIVE_SORT_EDGES, NATIVE_SORT_EDGES + 1])
def test_from_coo_matches_sgl_tpu_at_the_threshold(n_edges):
    src, dst, val = _edges(50_000, n_edges, seed=n_edges)
    kw = dict(num_nodes=50_000, pad_multiple=4096)
    got = Graph.from_coo(src, dst, val, **kw)
    assert_graphs_equal(got, JGraph.from_coo(src, dst, val, **kw))
    s, d, _ = got.edges()
    assert np.all(np.diff(d) >= 0)
    first = np.r_[True, d[1:] != d[:-1]]
    by_src = np.all((np.diff(s) >= 0) | first[1:])  # src-sorted within each row
    assert by_src == (n_edges <= NATIVE_SORT_EDGES)


@pytest.mark.parametrize("use_fallback", [False, True], ids=["native", "fallback"])
def test_sort_is_stable_by_dst(request, use_fallback):
    if use_fallback:
        request.getfixturevalue("fallback")
    src, dst, val = _edges()
    s, d, v = native.sort_edges_by_dst(src, dst, val, 500)
    order = np.argsort(dst, kind="stable")
    for got, want in ((s, src[order]), (d, dst[order]), (v, val[order])):
        np.testing.assert_array_equal(got, want)
    for got, want in zip((s, d, v), jnative.sort_edges_by_dst(src, dst, val, 500)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("use_fallback", [False, True], ids=["native", "fallback"])
def test_degrees_and_weights_match(request, use_fallback):
    if use_fallback:
        request.getfixturevalue("fallback")
    src, dst, val = _edges(seed=3)
    deg = native.compute_degrees(src, val, 500)
    want = np.zeros(500, np.float32)
    np.add.at(want, src, val)
    np.testing.assert_allclose(deg, want, rtol=1e-6)
    np.testing.assert_allclose(deg, jnative.compute_degrees(src, val, 500), rtol=1e-6)
    deg[7] = 0.0  # a node of degree 0 gets weight 0 on its edges
    for r in (0.5, 0.0, 1.0):
        w = native.normalized_weights(src, dst, val, deg, r)
        np.testing.assert_allclose(w, jnative.normalized_weights(src, dst, val, deg, r), rtol=1e-6)
        assert np.all(w[(src == 7) | (dst == 7)] == 0)


@pytest.mark.parametrize("use_fallback", [False, True], ids=["native", "fallback"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint16, np.int64])
def test_gather_rows_matches(request, use_fallback, dtype):
    if use_fallback:
        request.getfixturevalue("fallback")
    rng = np.random.default_rng(1)
    x = (rng.random((300, 7)) * 1000).astype(dtype)
    idx = rng.integers(0, 300, 1000).astype(np.int32)
    np.testing.assert_array_equal(native.gather_rows(x, idx), x[idx])
    np.testing.assert_array_equal(native.gather_rows(x, idx), jnative.gather_rows(x, idx))
    out = np.empty((1000, 7), dtype)
    assert native.gather_rows(x, idx, out=out) is out


def test_gather_rows_refuses_bad_input():
    x = np.zeros((10, 3), np.float32)
    with pytest.raises(IndexError):
        native.gather_rows(x, np.array([0, 10], np.int32))
    with pytest.raises(ValueError):
        native.gather_rows(x, np.array([0, 1], np.int32), out=np.empty((2, 3), np.float64))


@pytest.mark.parametrize("use_fallback", [False, True], ids=["native", "fallback"])
def test_build_normalized_adj_host_matches(request, use_fallback):
    if use_fallback:
        request.getfixturevalue("fallback")
    src, dst, val = _edges(120, 800, seed=5)
    got = native.build_normalized_adj_host(src, dst, val, 120, r=0.5)
    want = jnative.build_normalized_adj_host(src, dst, val, 120, r=0.5)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["sym", "sym_r0", "ppr"])
def test_host_normalization_matches_device_and_sgl_tpu(kind, weighted):
    rng = np.random.default_rng(6)
    n, e = 700, 6000
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    val = rng.random(e).astype(np.float32) + 0.5 if weighted else None
    g = Graph.from_coo(src, dst, val, num_nodes=n, pad_multiple=1024)
    jg = JGraph.from_coo(src, dst, val, num_nodes=n, pad_multiple=1024)
    if kind == "ppr":
        host, dev = ppr_weights_host(g, alpha=0.2), ppr_weights(g, alpha=0.2, device=CPU)
        ref = jnorm.ppr_weights_host(jg, alpha=0.2)
    else:
        r = 0.5 if kind == "sym" else 0.0
        host, dev = symmetric_normalized_weights_host(g, r=r), symmetric_normalized_weights(g, r=r, device=CPU)
        ref = jnorm.symmetric_normalized_weights_host(jg, r=r)
    assert host.sorted_by_dst and host.src.device.type == "cpu" and host.w.dtype == torch.float32
    # the same edges in the same order as the device build; the weights
    # within powf's rounding
    torch.testing.assert_close(host.src, dev.src, rtol=0, atol=0)
    torch.testing.assert_close(host.dst, dev.dst, rtol=0, atol=0)
    np.testing.assert_allclose(host.w.numpy(), dev.w.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(host.src.numpy(), np.asarray(ref.src))
    np.testing.assert_array_equal(host.dst.numpy(), np.asarray(ref.dst))
    np.testing.assert_allclose(host.w.numpy(), np.asarray(ref.w), rtol=1e-6, atol=1e-7)


def test_host_norm_threshold_matches():
    assert HOST_NORM_EDGE_THRESHOLD == jnorm.HOST_NORM_EDGE_THRESHOLD == 8 << 20


@pytest.mark.parametrize("dst_sorted", [True, False], ids=["dst_sorted", "unsorted"])
@pytest.mark.parametrize("use_fallback", [False, True], ids=["native", "fallback"])
def test_classify_sort_cells_2d_matches_fallback_and_sgl_tpu(request, use_fallback, dst_sorted):
    """The 2-D out-of-core cell sort: a stable counting sort by cell key
    (dst part x src block) that keeps the input order inside a cell; the
    native library, its numpy fallback and ``sgl_tpu``'s native function
    give equal arrays on the same inputs."""
    src, dst, w = _edges(n_nodes=1000, n_edges=20_000, seed=9)
    if dst_sorted:
        order = np.argsort(dst, kind="stable")
        src, dst, w = src[order], dst[order], w[order]
    sb, k = 300, 4  # 1000 rows in 3 parts, 4 blocks (the last one short)
    part_of_row = np.repeat(np.arange(3, dtype=np.int32), [384, 256, 360])
    native_out = native.classify_sort_cells_2d(src, dst, w, sb, k, part_of_row)
    # sgl_tpu's takes a per-tile part table and returns each edge's tile
    # too: with one-row tiles the table is the per-row one and the tile is dst
    j_src, j_dst, j_tile, j_w, j_counts = jnative.classify_sort_cells_2d(src, dst, w, 1, sb, k, part_of_row)
    np.testing.assert_array_equal(j_tile, j_dst)
    want = (j_src, j_dst, j_w, j_counts)
    if use_fallback:
        request.getfixturevalue("fallback")
    got = native.classify_sort_cells_2d(src, dst, w, sb, k, part_of_row)
    assert got[3].shape == (3 * k,) and int(got[3].sum()) == src.shape[0]
    for a, b, c in zip(got, want, native_out):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    key = part_of_row[got[1]] * k + got[0] // sb
    assert np.all(np.diff(key) >= 0)
    if dst_sorted:  # dst order inside every cell
        same = key[1:] == key[:-1]
        assert np.all(got[1][1:][same] >= got[1][:-1][same])
