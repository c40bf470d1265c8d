"""HGB-family heterogeneous loaders: ACM, DBLP, IMDB, Aminer — counterpart
of ``sgl_tpu/datasets/hetero_datasets.py``.

Each parses the PyG-layout ``geometric_data_processed.pt`` dict (one entry
per node type with ``x`` or ``num_nodes``, labels and masks; one entry per
``(src, relation, dst)`` tuple with ``edge_index``) under
``raw/hgb_<name>/raw/``.  Featureless node types get the mean of their
featured neighbours' features where such neighbours exist, else random
normals from ``default_rng(0)``, as ``sgl_tpu`` fills them.
"""

from __future__ import annotations

import os.path as osp
from typing import Dict, List, Tuple

import numpy as np
import torch

from sgl_tpu_torch.datasets.base import HeteroNodeDataset, random_split
from sgl_tpu_torch.graph.graph import HeteroGraph


class _HGBDataset(HeteroNodeDataset):
    NODE_TYPES: List[str] = []
    EDGE_TYPES_TUPLE: List[Tuple[str, str, str]] = []
    TYPE_OF_NODE_TO_PREDICT = ""

    def __init__(self, name: str, root: str = "./data/"):
        super().__init__(name=name, root=osp.join(root, "hgb"))

    @property
    def pt_path(self) -> str:
        return osp.join(self.raw_dir, f"hgb_{self.name}", "raw", "geometric_data_processed.pt")

    @property
    def raw_file_paths(self) -> List[str]:
        return [self.pt_path]

    def _load_src(self) -> Dict:
        obj = torch.load(self.pt_path, map_location="cpu", weights_only=False)
        if isinstance(obj, (list, tuple)):
            obj = obj[0]
        return obj  # a dict, or anything with dict-style access (PyG's HeteroData)

    def _process(self) -> HeteroGraph:
        src_ds = self._load_src()
        counts = {}
        x_dict, y_dict = {}, {}
        for nt in self.NODE_TYPES:
            store = src_ds[nt]
            if "x" in store:
                x = np.asarray(store["x"], np.float32)
                counts[nt] = x.shape[0]
                x_dict[nt] = x
            else:
                counts[nt] = int(store["num_nodes"])
            if "y" in store:
                y_dict[nt] = np.asarray(store["y"]).reshape(-1)
        edge_index_dict = {}
        for et in self.EDGE_TYPES_TUPLE:
            ei = np.asarray(src_ds[et]["edge_index"], np.int64)
            edge_index_dict[et] = (ei[0], ei[1])
        hg = HeteroGraph.build(counts, edge_index_dict, x_dict=x_dict, y_dict=y_dict)
        # featureless types: the mean of featured out-neighbours of the
        # first feature width, else random normals
        dims = [n.x.shape[1] for n in hg.nodes.values() if n.x is not None]
        d = dims[0] if dims else 64
        rng = np.random.default_rng(0)
        for nt in hg.node_types:
            if hg.nodes[nt].x is None:
                acc = np.zeros((hg.num_node[nt], d), np.float32)
                cnt = np.zeros(hg.num_node[nt], np.float32)
                for et_name, edge in hg.edges.items():
                    st, _, dt = hg.edge_type_parts(et_name)
                    if st == nt and hg.nodes[dt].x is not None and hg.nodes[dt].x.shape[1] == d:
                        np.add.at(acc, edge.src - hg.offset[st], hg.nodes[dt].x[edge.dst - hg.offset[dt]])
                        np.add.at(cnt, edge.src - hg.offset[st], 1.0)
                if cnt.sum() == 0:
                    acc = rng.normal(size=acc.shape).astype(np.float32)
                    cnt[:] = 1.0
                hg.nodes[nt].x = acc / np.maximum(cnt, 1.0)[:, None]
        return hg

    def _predict_type(self) -> str:
        pred = self.TYPE_OF_NODE_TO_PREDICT
        return pred[0] if isinstance(pred, list) else pred

    def _split(self) -> None:
        pred = self._predict_type()
        try:
            store = self._load_src()[pred]
            train_mask = np.asarray(store["train_mask"]).astype(bool)
            test_mask = np.asarray(store["test_mask"]).astype(bool)
            train_all = np.flatnonzero(train_mask)
            # HGB ships no validation mask: the first fifth of train is one
            n_val = max(len(train_all) // 5, 1)
            self.val_idx = train_all[:n_val]
            self.train_idx = train_all[n_val:]
            self.test_idx = np.flatnonzero(test_mask)
        except (KeyError, IOError):
            self.train_idx, self.val_idx, self.test_idx = random_split(self.data.num_node[pred])

    @property
    def num_classes(self) -> int:
        return int(np.asarray(self.data[self._predict_type()].y).max()) + 1


class Acm(_HGBDataset):
    NODE_TYPES = ["paper", "author", "subject", "term"]
    EDGE_TYPES_TUPLE = [
        ("paper", "cite", "paper"),
        ("paper", "ref", "paper"),
        ("paper", "to", "author"),
        ("author", "to", "paper"),
        ("paper", "to", "subject"),
        ("subject", "to", "paper"),
        ("paper", "to", "term"),
        ("term", "to", "paper"),
    ]
    TYPE_OF_NODE_TO_PREDICT = "paper"

    def __init__(self, root: str = "./data/"):
        super().__init__(name="acm", root=root)


class Dblp(_HGBDataset):
    NODE_TYPES = ["author", "paper", "term", "conference"]
    EDGE_TYPES_TUPLE = [
        ("author", "to", "paper"),
        ("paper", "to", "author"),
        ("paper", "to", "term"),
        ("paper", "to", "conference"),
        ("term", "to", "paper"),
        ("conference", "to", "paper"),
    ]
    TYPE_OF_NODE_TO_PREDICT = "author"

    def __init__(self, root: str = "./data/"):
        super().__init__(name="dblp", root=root)


class DblpOriginal(Dblp):
    """The original DBLP release: DBLP's schema, its own raw dump (place
    its ``geometric_data_processed.pt`` under
    ``raw/hgb_dblp_original/raw/``)."""

    def __init__(self, root: str = "./data/"):
        _HGBDataset.__init__(self, name="dblp_original", root=root)


class Imdb(_HGBDataset):
    NODE_TYPES = ["movie", "director", "actor"]
    EDGE_TYPES_TUPLE = [
        ("movie", "to", "director"),
        ("director", "to", "movie"),
        ("movie", "to", "actor"),
        ("actor", "to", "movie"),
    ]
    TYPE_OF_NODE_TO_PREDICT = "movie"

    def __init__(self, root: str = "./data/"):
        super().__init__(name="imdb", root=root)


class Aminer(_HGBDataset):
    NODE_TYPES = ["paper", "author", "venue"]
    EDGE_TYPES_TUPLE = [
        ("paper", "written_by", "author"),
        ("author", "writes", "paper"),
        ("paper", "published_in", "venue"),
        ("venue", "publishes", "paper"),
    ]
    TYPE_OF_NODE_TO_PREDICT = ["author", "venue"]

    def __init__(self, root: str = "./data/"):
        super().__init__(name="aminer", root=root)
