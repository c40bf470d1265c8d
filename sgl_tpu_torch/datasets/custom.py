"""A user's own graph from offline files — counterpart of
``sgl_tpu/datasets/custom.py``, over the same layout.

Homogeneous (:class:`Custom_Homo`), under ``<root>/<name>/raw/``::

    x.npy           # [N, D] features (optional when num_node is given)
    adj_matrix.npz  # arrays 'row', 'col', 'data' (COO, required)
    label.npy       # [N] ids or [N, C] one-hot (optional)
    indices.npz     # 'train_idx' / 'val_idx' / 'test_idx' (optional)

Heterogeneous (:class:`Custom_Hetero`): a node type's ``x_<type>.npy`` and
``label_<type>.npy``, an edge type's ``adj_<src>__<rel>__<dst>.npz``
(arrays 'row' and 'col', local ids), and ``indices.npz`` for the type to
predict.  Without ``indices.npz`` (or with ``splitted=False``) the split is
:func:`random_split`'s.
"""

from __future__ import annotations

import os.path as osp
from typing import List, Optional, Tuple

import numpy as np

from sgl_tpu_torch.datasets.base import HeteroNodeDataset, NodeDataset, random_split
from sgl_tpu_torch.graph.graph import Graph, HeteroGraph


def _labels(path: str) -> np.ndarray:
    """Class ids from a label file: ids as they are, one-hot rows argmaxed."""
    y = np.load(path)
    if y.ndim == 2:
        y = np.argmax(y, axis=1)
    return y.astype(np.int64)


def _read_split(ds, splitted: bool, num_node: int) -> None:
    ds.train_idx = ds.val_idx = ds.test_idx = None
    path = osp.join(ds.raw_dir, "indices.npz")
    if splitted and osp.exists(path):
        f = np.load(path)
        ds.train_idx, ds.val_idx, ds.test_idx = f.get("train_idx"), f.get("val_idx"), f.get("test_idx")
    if ds.train_idx is None:
        ds.train_idx, ds.val_idx, ds.test_idx = random_split(num_node)


class Custom_Homo(NodeDataset):  # noqa: N801 — the reference's name
    def __init__(
        self,
        name: str,
        root: str = "./data/",
        num_node: Optional[int] = None,
        node_type: str = "node",
        edge_type_tuple: Tuple[str, str, str] = ("node", "to", "node"),
        splitted: bool = True,
    ):
        self._num_node = num_node
        self._node_type = node_type
        self._edge_type_tuple = edge_type_tuple
        self._splitted = splitted
        super().__init__(name=name, root=root)

    @property
    def raw_file_paths(self):
        return [osp.join(self.raw_dir, "adj_matrix.npz")]

    def _process(self) -> Graph:
        x = None
        xp = osp.join(self.raw_dir, "x.npy")
        if osp.exists(xp):
            x = np.asarray(np.load(xp), np.float32)
            if self._num_node and self._num_node != x.shape[0]:
                raise ValueError("every node should have a feature vector")
            self._num_node = x.shape[0]
        elif not self._num_node:
            raise ValueError("please provide either feature matrix or number of node")
        f = np.load(self.raw_file_paths[0])
        lp = osp.join(self.raw_dir, "label.npy")
        y = _labels(lp) if osp.exists(lp) else None
        return Graph.from_coo(f["row"], f["col"], f["data"], num_nodes=self._num_node, x=x, y=y)

    def _split(self) -> None:
        # the cache may have skipped _process: the graph knows the count
        _read_split(self, self._splitted, self._num_node or self.num_node)


class Custom_Hetero(HeteroNodeDataset):  # noqa: N801
    def __init__(
        self,
        name: str,
        type_of_node_to_predict: str,
        node_types: List[str],
        edge_types_tuple: List[Tuple[str, str, str]],
        root: str = "./data/",
        splitted: bool = True,
    ):
        if type_of_node_to_predict not in node_types:
            raise ValueError("make sure that the type of center node is in type list")
        self.NODE_TYPES = list(node_types)
        self.TYPE_OF_NODE_TO_PREDICT = type_of_node_to_predict
        self.EDGE_TYPES_TUPLE = list(edge_types_tuple)
        self._splitted = splitted
        super().__init__(name=name, root=root)

    @property
    def raw_file_paths(self):
        return [osp.join(self.raw_dir, f"adj_{s}__{r}__{d}.npz") for s, r, d in self.EDGE_TYPES_TUPLE]

    def _process(self) -> HeteroGraph:
        counts, x_dict, y_dict = {}, {}, {}
        for nt in self.NODE_TYPES:
            xp = osp.join(self.raw_dir, f"x_{nt}.npy")
            if osp.exists(xp):
                x_dict[nt] = np.asarray(np.load(xp), np.float32)
                counts[nt] = x_dict[nt].shape[0]
            lp = osp.join(self.raw_dir, f"label_{nt}.npy")
            if osp.exists(lp):
                y_dict[nt] = _labels(lp)
        edge_index_dict = {}
        for (s, r, d), path in zip(self.EDGE_TYPES_TUPLE, self.raw_file_paths):
            f = np.load(path)
            edge_index_dict[(s, r, d)] = (f["row"], f["col"])
            counts[s] = max(counts.get(s, 0), int(f["row"].max()) + 1)
            counts[d] = max(counts.get(d, 0), int(f["col"].max()) + 1)
        return HeteroGraph.build(counts, edge_index_dict, x_dict=x_dict, y_dict=y_dict)

    def _split(self) -> None:
        _read_split(self, self._splitted, self.data.num_node[self.TYPE_OF_NODE_TO_PREDICT])

    @property
    def num_classes(self) -> int:
        y = np.asarray(self.data[self.TYPE_OF_NODE_TO_PREDICT].y)
        return int(y.max()) + 1
