"""Planetoid citation datasets (cora, citeseer, pubmed) and NELL —
counterpart of ``sgl_tpu/datasets/planetoid.py``.

Parses the kimiyoung/planetoid pickle format: ``ind.<name>.{x,tx,allx,y,ty,
ally,graph,test.index}`` under ``<root>/Planetoid/<name>/raw/`` (NELL's
under ``<root>/Nell/<name>/raw/``).  A missing raw file is fetched from
the kimiyoung/planetoid repository (NELL's tarball from its authors' page)
and unpacked; offline the loader raises and names it.  Features are
row-normalized and
made dense (NELL at its real size, 65,755 × 61,278, is 16 GB of f32); the
graph is made undirected, without self loops or repeated edges.

:func:`write_raw_files` writes files of that format from a seed, at any
size (pubmed's by default), for runs without the real data.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle

import numpy as np
import scipy.sparse as sp

from sgl_tpu_torch.datasets.base import NodeDataset, random_split
from sgl_tpu_torch.datasets.utils import pkl_read_file, row_normalize, undirect_and_clean
from sgl_tpu_torch.graph.graph import Graph

RAW_NAMES = ["x", "tx", "allx", "y", "ty", "ally", "graph", "test.index"]


class Planetoid(NodeDataset):
    """``Planetoid(name, root, split)``; ``split`` is ``"official"`` (20
    training nodes a class, 500 validation, the last 1,000 for test) or
    ``"random"`` (60/20/20 by :func:`random_split`)."""

    RAW_NAMES = RAW_NAMES

    def __init__(self, name: str = "cora", root: str = "./data/", split: str = "official"):
        if name not in ("cora", "citeseer", "pubmed"):
            raise ValueError("Dataset name not supported!")
        self._split_mode = split
        super().__init__(name=name, root=osp.join(root, "Planetoid"))

    @property
    def raw_file_paths(self):
        return [osp.join(self.raw_dir, f"ind.{self.name}.{n}") for n in self.RAW_NAMES]

    @property
    def raw_urls(self):
        base = "https://github.com/kimiyoung/planetoid/raw/master/data"
        return {f"ind.{self.name}.{n}": f"{base}/ind.{self.name}.{n}" for n in self.RAW_NAMES}

    def _process(self) -> Graph:
        x, tx, allx, y, ty, ally = [pkl_read_file(p) for p in self.raw_file_paths[:6]]
        graph = pkl_read_file(self.raw_file_paths[6])
        with open(self.raw_file_paths[7]) as rf:
            test_idx_reorder = [int(line.strip()) for line in rf if line.strip()]
        test_idx_range = np.sort(test_idx_reorder)

        if self.name == "citeseer":
            # citeseer's test index has gaps (isolated nodes): pad tx/ty to
            # the full range with zero rows
            full = range(min(test_idx_reorder), max(test_idx_reorder) + 1)
            tx_ext = sp.lil_matrix((len(full), x.shape[1]))
            tx_ext[test_idx_range - min(test_idx_range), :] = tx
            tx = tx_ext
            ty_ext = np.zeros((len(full), y.shape[1]))
            ty_ext[test_idx_range - min(test_idx_range), :] = ty
            ty = ty_ext

        features = sp.vstack((allx, tx)).tolil()
        features[test_idx_reorder, :] = features[test_idx_range, :]
        features = np.asarray(row_normalize(features.tocsr()).todense(), np.float32)

        labels = np.vstack((ally, ty))
        labels[test_idx_reorder, :] = labels[test_idx_range, :]
        labels = np.argmax(labels, axis=1).astype(np.int64)

        src, dst = [], []
        for u, nbrs in graph.items():
            src += [u] * len(nbrs)
            dst += list(nbrs)
        s, d = undirect_and_clean(np.asarray(src, np.int64), np.asarray(dst, np.int64))
        return Graph.from_coo(s, d, num_nodes=features.shape[0], x=features, y=labels)

    def _split(self) -> None:
        if self._split_mode == "official":
            c = self.num_classes
            self.train_idx = np.arange(c * 20)
            self.val_idx = np.arange(c * 20, c * 20 + 500)
            self.test_idx = np.arange(self.num_node - 1000, self.num_node)
        elif self._split_mode == "random":
            self.train_idx, self.val_idx, self.test_idx = random_split(self.num_node)
        else:
            raise ValueError("Please input valid split pattern!")


class Nell(Planetoid):
    """NELL in the same pickle format (``ind.nell.0.001.*`` and the other
    label rates).  ``split="official"`` trains on the first ``c`` nodes
    (one a class), validates on the next 500 and tests on the last 1,000;
    any other ``split`` is :func:`random_split`'s."""

    def __init__(self, name: str = "nell.0.001", root: str = "./data/", split: str = "official"):
        self._split_mode = split
        NodeDataset.__init__(self, name=name, root=osp.join(root, "Nell"))

    @property
    def raw_urls(self):
        return {"nell_data.tar.gz": "http://www.cs.cmu.edu/~zhiliny/data/nell_data.tar.gz"}

    def _post_download(self) -> None:
        """Unpack the tarball and move this variant's files into ``raw/``."""
        import shutil
        import tarfile

        tar_path = osp.join(self.raw_dir, "nell_data.tar.gz")
        with tarfile.open(tar_path) as tf:
            tf.extractall(self.raw_dir, filter="data")
        os.unlink(tar_path)
        extracted = osp.join(self.raw_dir, "nell_data")
        for root_dir, _, files in os.walk(extracted, topdown=False):
            for f in files:
                if self.name in f:
                    shutil.move(osp.join(root_dir, f), self.raw_dir)
        shutil.rmtree(extracted, ignore_errors=True)

    def _split(self) -> None:
        if self._split_mode == "official":
            c = self.num_classes
            self.train_idx = np.arange(c)
            self.val_idx = np.arange(c, c + 500)
            self.test_idx = np.arange(self.num_node - 1000, self.num_node)
        else:
            self.train_idx, self.val_idx, self.test_idx = random_split(self.num_node)


def write_raw_files(
    raw_dir: str,
    name: str = "pubmed",
    num_nodes: int = 19_717,
    num_features: int = 500,
    num_classes: int = 3,
    num_edges: int = 44_324,
    num_test: int = 1_000,
    density: float = 0.1,
    homophily: float = 0.8,
    seed: int = 0,
) -> None:
    """Write ``ind.<name>.*`` raw files of the Planetoid format into
    ``raw_dir``, made from ``seed``; the defaults are pubmed's shape (19,717
    nodes, 500 features, 3 classes, 44,324 undirected edges, 1,000 test
    nodes).

    Labels are uniform; an edge joins two nodes of one class with
    probability ``homophily``; each class has its own 50 of the features,
    which its nodes use four times as often.  As in the real files, ``x``
    and ``y`` are the first ``20·num_classes`` rows of ``allx``/``ally``,
    the test rows (``tx``/``ty``) are the last ``num_test`` nodes, listed in
    ``test.index`` in a shuffled order, and ``graph`` maps a node to its
    neighbours."""
    rng = np.random.default_rng(seed)
    n, c = num_nodes, num_classes
    y = rng.integers(0, c, n)
    # features: row-sparse positive weights, class-biased columns
    bias = np.ones((c, num_features))
    for k in range(c):
        bias[k, rng.choice(num_features, size=min(50, num_features), replace=False)] = 4.0
    p = bias[y] / bias[y].sum(axis=1, keepdims=True)
    nnz_row = np.maximum(1, rng.binomial(num_features, density, n))
    cols = [rng.choice(num_features, size=k, replace=False, p=p_i) for k, p_i in zip(nnz_row, p)]
    rows = np.repeat(np.arange(n), nnz_row)
    vals = rng.random(rows.shape[0]).astype(np.float32)
    feats = sp.csr_matrix((vals, (rows, np.concatenate(cols))), shape=(n, num_features), dtype=np.float32)
    # edges: num_edges distinct undirected pairs without self loops
    members = [np.flatnonzero(y == k) for k in range(c)]
    pairs = np.empty((0, 2), np.int64)
    while pairs.shape[0] < num_edges:
        m = 2 * (num_edges - pairs.shape[0]) + 16
        u = rng.integers(0, n, m)
        v = rng.integers(0, n, m)
        same = rng.random(m) < homophily
        for k in range(c):
            sel = same & (y[u] == k)
            v[sel] = rng.choice(members[k], size=int(sel.sum()))
        keep = u != v
        new = np.sort(np.stack([u[keep], v[keep]], axis=1), axis=1)
        pairs = np.unique(np.concatenate([pairs, new]), axis=0)
    pairs = pairs[rng.permutation(pairs.shape[0])[:num_edges]]
    graph = {i: [] for i in range(n)}
    for a, b in pairs.tolist():
        graph[a].append(b)

    onehot = np.eye(c)[y]
    n_all = n - num_test
    n_train = 20 * c
    test_index = np.arange(n_all, n)
    order = rng.permutation(num_test)  # test.index lists the test nodes shuffled
    # the file's i-th test row describes node test_index[order[i]]
    tx = feats[n_all:][order]
    ty = onehot[n_all:][order]
    objects = {
        "x": feats[:n_train], "tx": tx, "allx": feats[:n_all],
        "y": onehot[:n_train], "ty": ty, "ally": onehot[:n_all], "graph": graph,
    }
    os.makedirs(raw_dir, exist_ok=True)
    for key, obj in objects.items():
        with open(osp.join(raw_dir, f"ind.{name}.{key}"), "wb") as f:
            pickle.dump(obj, f)
    with open(osp.join(raw_dir, f"ind.{name}.test.index"), "w") as f:
        f.write("\n".join(str(i) for i in test_index[order]))
