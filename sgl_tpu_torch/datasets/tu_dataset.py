"""TUDataset loader — counterpart of ``sgl_tpu/datasets/tu_dataset.py``:
the graph-classification corpus format (MUTAG, PROTEINS, NCI1, ...).
Parses the published raw text layout::

    <root>/<name>/raw/<name>_A.txt               # "row, col" 1-based edges
    <root>/<name>/raw/<name>_graph_indicator.txt # per node: 1-based graph id
    <root>/<name>/raw/<name>_graph_labels.txt    # per graph: class label
    <root>/<name>/raw/<name>_node_labels.txt     # optional: int per node
    <root>/<name>/raw/<name>_node_attributes.txt # optional: csv floats

Node features are the attribute rows when present, then a one-hot encoding
of the node labels when present; a graph with neither gets a constant
feature.  Graph labels are remapped to ``0..C-1`` in sorted order.  The
files are not downloaded: place them under ``raw/``.
"""

from __future__ import annotations

import os.path as osp
from typing import List

import numpy as np

from sgl_tpu_torch.datasets.base import GraphDataset, random_split
from sgl_tpu_torch.datasets.utils import read_csv_gz
from sgl_tpu_torch.graph.graph import Graph


class TUDataset(GraphDataset):
    def __init__(
        self,
        name: str,
        root: str = "./data/",
        split_seed: int = 0,
        train_ratio: float = 0.8,
        val_ratio: float = 0.1,
        use_cache: bool = True,
    ):
        self._split_seed = split_seed
        self._train_ratio = train_ratio
        self._val_ratio = val_ratio
        super().__init__(name=name, root=root, use_cache=use_cache)

    def _file(self, suffix: str) -> str:
        return osp.join(self.raw_dir, f"{self.name}_{suffix}.txt")

    @property
    def raw_file_paths(self) -> List[str]:
        return [self._file(s) for s in ("A", "graph_indicator", "graph_labels")]

    def _process(self):
        edges = read_csv_gz(self._file("A"), np.int64) - 1  # to 0-based
        indicator = read_csv_gz(self._file("graph_indicator"), np.int64).reshape(-1) - 1
        graph_labels = read_csv_gz(self._file("graph_labels"), np.int64).reshape(-1)
        classes = np.unique(graph_labels)
        y = np.searchsorted(classes, graph_labels).astype(np.int64)

        n_total = indicator.shape[0]
        feats = []
        if osp.exists(self._file("node_attributes")):
            attr = read_csv_gz(self._file("node_attributes"), np.float32)
            if attr.shape[0] != n_total:
                raise ValueError("node_attributes row count != node count")
            feats.append(attr)
        if osp.exists(self._file("node_labels")):
            nl = read_csv_gz(self._file("node_labels"), np.int64).reshape(-1)
            values = np.unique(nl)
            onehot = np.zeros((n_total, values.shape[0]), np.float32)
            onehot[np.arange(n_total), np.searchsorted(values, nl)] = 1.0
            feats.append(onehot)
        if not feats:
            feats.append(np.ones((n_total, 1), np.float32))
        x = np.concatenate(feats, axis=1)

        counts = np.bincount(indicator, minlength=int(indicator.max()) + 1)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        # edges grouped by their owning graph (the src node's), in file order
        owner = indicator[edges[:, 0]]
        if np.any(owner != indicator[edges[:, 1]]):
            raise ValueError("edge crosses graph boundary in TU file")
        order = np.argsort(owner, kind="stable")
        edges = edges[order]
        owner = owner[order]
        e_offsets = np.concatenate([[0], np.cumsum(np.bincount(owner, minlength=counts.shape[0]))])

        graphs = []
        for gid in range(counts.shape[0]):
            lo, hi = e_offsets[gid], e_offsets[gid + 1]
            n_lo, n_hi = offsets[gid], offsets[gid + 1]
            graphs.append(Graph.from_coo(
                edges[lo:hi, 0] - n_lo, edges[lo:hi, 1] - n_lo, num_nodes=int(counts[gid]),
                x=x[n_lo:n_hi], pad_multiple=64,
            ))
        return graphs, y

    def _split(self) -> None:
        self.train_idx, self.val_idx, self.test_idx = random_split(
            self.num_graphs, self._train_ratio, self._val_ratio, seed=self._split_seed
        )
