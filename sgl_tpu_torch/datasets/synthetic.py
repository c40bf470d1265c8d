"""Synthetic datasets: deterministic, network-free, used by tests and bench.

Counterpart of ``sgl_tpu/datasets/synthetic.py``.  Every generator is numpy
with the same draws in the same order, so both packages build the same
arrays from the same seed.
"""

from __future__ import annotations

import numpy as np

from sgl_tpu_torch.datasets.base import GraphDataset, HeteroNodeDataset, NodeDataset, random_split
from sgl_tpu_torch.graph.graph import Graph, HeteroGraph


class PlantedPartition(NodeDataset):
    """Stochastic block model with class-correlated Gaussian features."""

    def __init__(
        self,
        num_nodes: int = 600,
        num_classes: int = 4,
        feat_dim: int = 32,
        p_in: float = 0.05,
        p_out: float = 0.002,
        feature_noise: float = 2.0,
        seed: int = 0,
        train_ratio: float = 0.3,
        val_ratio: float = 0.2,
    ):
        self._n = num_nodes
        self._c = num_classes
        self._d = feat_dim
        self._p_in = p_in
        self._p_out = p_out
        self._noise = feature_noise
        self._seed = seed
        self._train_ratio = train_ratio
        self._val_ratio = val_ratio
        super().__init__(name=f"sbm_{num_nodes}_{seed}", use_cache=False)

    def _raw_exists(self) -> bool:
        return True

    def _process(self) -> Graph:
        rng = np.random.default_rng(self._seed)
        n, c, d = self._n, self._c, self._d
        y = rng.integers(0, c, n)
        centroids = rng.normal(size=(c, d)).astype(np.float32)
        x = centroids[y] + self._noise * rng.normal(size=(n, d)).astype(np.float32)
        same = y[:, None] == y[None, :]
        probs = np.where(same, self._p_in, self._p_out)
        upper = np.triu(rng.random((n, n)) < probs, k=1)
        s, t = np.nonzero(upper)
        src = np.concatenate([s, t]).astype(np.int32)
        dst = np.concatenate([t, s]).astype(np.int32)
        return Graph.from_coo(src, dst, num_nodes=n, x=x, y=y, pad_multiple=1024)

    def _split(self) -> None:
        self.train_idx, self.val_idx, self.test_idx = random_split(
            self._n, self._train_ratio, self._val_ratio, seed=self._seed
        )


def random_power_law_graph(
    num_nodes: int,
    avg_degree: int,
    feat_dim: int,
    num_classes: int = 16,
    seed: int = 0,
    alpha: float = 1.2,
    pad_multiple: int = 4096,
) -> Graph:
    """Degree-skewed random graph (Zipf-ish sources) for SpMM benchmarking."""
    rng = np.random.default_rng(seed)
    e = num_nodes * avg_degree // 2
    w = (np.arange(1, num_nodes + 1, dtype=np.float64)) ** (-alpha)
    w /= w.sum()
    src = rng.choice(num_nodes, size=e, p=w).astype(np.int32)
    dst = rng.integers(0, num_nodes, e).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    src_u = np.concatenate([src, dst])
    dst_u = np.concatenate([dst, src])
    x = rng.normal(size=(num_nodes, feat_dim)).astype(np.float32)
    y = rng.integers(0, num_classes, num_nodes)
    return Graph.from_coo(
        src_u, dst_u, num_nodes=num_nodes, x=x, y=y, pad_multiple=pad_multiple
    )


class SyntheticPowerLaw(NodeDataset):
    """Homophilous power-law graph in the ``NodeDataset`` lifecycle: Zipf
    sources (hubs), destinations redrawn within the source's class with
    probability ``homophily``, class-correlated features."""

    def __init__(
        self,
        num_nodes: int = 100_000,
        avg_degree: int = 14,
        feat_dim: int = 128,
        num_classes: int = 16,
        alpha: float = 1.2,
        homophily: float = 0.8,
        feature_noise: float = 2.0,
        seed: int = 0,
        train_ratio: float = 0.1,
        val_ratio: float = 0.05,
        pad_multiple: int = 4096,
    ):
        self._n = num_nodes
        self._deg = avg_degree
        self._d = feat_dim
        self._c = num_classes
        self._alpha = alpha
        self._hom = homophily
        self._noise = feature_noise
        self._seed = seed
        self._train_ratio = train_ratio
        self._val_ratio = val_ratio
        self._pad = pad_multiple
        super().__init__(name=f"powerlaw_{num_nodes}_{seed}", use_cache=False)

    def _raw_exists(self) -> bool:
        return True

    def _process(self) -> Graph:
        rng = np.random.default_rng(self._seed)
        n, c, d = self._n, self._c, self._d
        y = rng.integers(0, c, n)
        centroids = rng.normal(size=(c, d)).astype(np.float32)
        x = centroids[y] + self._noise * rng.normal(size=(n, d)).astype(np.float32)
        e = n * self._deg // 2
        w = np.arange(1, n + 1, dtype=np.float64) ** (-self._alpha)
        w /= w.sum()
        src = rng.choice(n, size=e, p=w).astype(np.int64)
        dst = rng.integers(0, n, e).astype(np.int64)
        hom = rng.random(e) < self._hom
        if hom.any():
            cls_nodes = [np.flatnonzero(y == k) for k in range(c)]
            src_cls = y[src]
            for k in range(c):
                m = hom & (src_cls == k)
                if m.any() and cls_nodes[k].size:
                    dst[m] = rng.choice(cls_nodes[k], size=int(m.sum()))
        keep = src != dst
        src, dst = src[keep], dst[keep]
        src_u = np.concatenate([src, dst]).astype(np.int32)
        dst_u = np.concatenate([dst, src]).astype(np.int32)
        return Graph.from_coo(src_u, dst_u, num_nodes=n, x=x, y=y, pad_multiple=self._pad)

    def _split(self) -> None:
        self.train_idx, self.val_idx, self.test_idx = random_split(
            self._n, self._train_ratio, self._val_ratio, seed=self._seed
        )


class SyntheticHeteroDataset(HeteroNodeDataset):
    """:func:`synthetic_hetero` in the ``HeteroNodeDataset`` lifecycle, with
    a random split over the predict-class nodes (local ids)."""

    def __init__(self, predict_class: str = "paper", seed: int = 0, **kw):
        self._gen_kw = dict(kw, seed=seed)
        self._predict_class = predict_class
        self._seed = seed
        super().__init__(name=f"synth_hetero_{seed}", use_cache=False)

    def _raw_exists(self) -> bool:
        return True

    def _process(self) -> HeteroGraph:
        return synthetic_hetero(**self._gen_kw)

    def _split(self) -> None:
        n = self.data.num_node[self._predict_class]
        self.train_idx, self.val_idx, self.test_idx = random_split(n, 0.5, 0.25, seed=self._seed)

    @property
    def num_classes(self) -> int:
        return int(np.asarray(self.data[self._predict_class].y).max()) + 1


def synthetic_hetero(
    counts=None,
    avg_degree: int = 6,
    feat_dim: int = 16,
    num_classes: int = 3,
    seed: int = 0,
) -> HeteroGraph:
    """Random heterogeneous graph with an ACM-like schema (paper cites
    paper, author writes paper, paper has subject) and class-correlated
    paper features."""
    rng = np.random.default_rng(seed)
    counts = counts or {"paper": 120, "author": 80, "subject": 20}
    schema = [("paper", "cite", "paper"), ("author", "writes", "paper"), ("paper", "has", "subject")]
    edges = {}
    for st, rel, dt in schema:
        e = counts[st] * avg_degree
        edges[(st, rel, dt)] = (rng.integers(0, counts[st], e), rng.integers(0, counts[dt], e))
    y = rng.integers(0, num_classes, counts["paper"])
    centroids = rng.normal(size=(num_classes, feat_dim)).astype(np.float32)
    x_dict = {t: rng.normal(size=(n, feat_dim)).astype(np.float32) for t, n in counts.items()}
    x_dict["paper"] = (
        centroids[y] + 1.0 * rng.normal(size=(counts["paper"], feat_dim))
    ).astype(np.float32)
    return HeteroGraph.build(counts, edges, x_dict=x_dict, y_dict={"paper": y})


class SyntheticGraphClassification(GraphDataset):
    """Graph classification whose signal is structural: classes differ only
    in edge density, node features are a constant column plus noise, so
    accuracy above chance comes through propagation."""

    def __init__(
        self,
        num_graphs: int = 200,
        num_classes: int = 2,
        nodes_per_graph=(20, 40),
        feat_dim: int = 8,
        base_p: float = 0.08,
        seed: int = 0,
    ):
        self._g = num_graphs
        self._c = num_classes
        self._nrange = nodes_per_graph
        self._d = feat_dim
        self._base_p = base_p
        self._seed = seed
        super().__init__(name=f"synth_graphs_{num_graphs}_{seed}", use_cache=False)

    def _raw_exists(self) -> bool:
        return True

    def _process(self):
        rng = np.random.default_rng(self._seed)
        graphs, ys = [], []
        lo, hi = self._nrange
        for _ in range(self._g):
            y = int(rng.integers(0, self._c))
            n = int(rng.integers(lo, hi + 1))
            p = self._base_p * (1 + 2 * y)  # density encodes the class
            upper = np.triu(rng.random((n, n)) < p, k=1)
            s, t = np.nonzero(upper)
            src = np.concatenate([s, t]).astype(np.int32)
            dst = np.concatenate([t, s]).astype(np.int32)
            x = np.concatenate(
                [np.ones((n, 1), np.float32), rng.normal(size=(n, self._d - 1)).astype(np.float32)],
                axis=1,
            )
            graphs.append(Graph.from_coo(src, dst, num_nodes=n, x=x, pad_multiple=64))
            ys.append(y)
        return graphs, np.asarray(ys, np.int64)

    def _split(self) -> None:
        self.train_idx, self.val_idx, self.test_idx = random_split(self._g, 0.5, 0.25, seed=self._seed)
