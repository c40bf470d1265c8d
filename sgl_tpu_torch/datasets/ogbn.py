"""OGB node-property datasets — counterpart of ``sgl_tpu/datasets/ogbn.py``:
ogbn-arxiv, -products and -papers100M (:class:`Ogbn`) and the
heterogeneous ogbn-mag (:class:`OgbnMag`).

The loaders parse the standard OGB raw layout, what the ``ogb`` package
unzips, with no ``ogb`` dependency::

    <root>/ogbn/<name>/ogbn_<name>/raw/edge.csv.gz         # src,dst a line
    <root>/ogbn/<name>/ogbn_<name>/raw/node-feat.csv.gz    # a row a node
    <root>/ogbn/<name>/ogbn_<name>/raw/node-label.csv.gz
    <root>/ogbn/<name>/ogbn_<name>/split/<split>/{train,valid,test}.csv.gz

Each raw file may also be a plain ``.csv`` or a ``.npy`` (papers100M ships
``.npy``).  The csv files go through the native parser
(``datasets/utils.py::read_csv_gz``).  Graphs are made undirected, self
loops dropped and duplicate edges merged.  Missing raw files are fetched
from the OGB archive (``raw_urls``) and unzipped; offline that raises an
``IOError`` naming the archive and where to put it.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from sgl_tpu_torch.datasets.base import HeteroNodeDataset, NodeDataset
from sgl_tpu_torch.datasets.utils import read_csv_gz, read_index_csv_gz, undirect_and_clean
from sgl_tpu_torch.graph.graph import Graph, HeteroGraph

# the official split of each dataset
_SPLIT_DIRS = {"arxiv": "time", "products": "sales_ranking", "papers100M": "time"}
_OGB_URL = "http://snap.stanford.edu/ogb/data/nodeproppred"


def _unzip_into(ds, zip_name: str, dataset_dir: str) -> None:
    """Extract ``raw_dir/<zip_name>.zip`` into ``ds.root``, delete it, and
    move the archive's top-level directory to ``dataset_dir``."""
    import shutil
    import zipfile

    path = osp.join(ds.raw_dir, f"{zip_name}.zip")
    with zipfile.ZipFile(path) as zf:
        zf.extractall(ds.root)
    os.unlink(path)
    extracted = osp.join(ds.root, zip_name)
    if osp.isdir(extracted) and not osp.isdir(dataset_dir):
        shutil.move(extracted, dataset_dir)


class Ogbn(NodeDataset):
    """ogbn-arxiv, ogbn-products or ogbn-papers100M, with the official split."""

    def __init__(self, name: str = "arxiv", root: str = "./data/", split: str = "official"):
        if name not in _SPLIT_DIRS:
            raise ValueError("Dataset name not found!")
        self._split_mode = split
        super().__init__(name=name, root=osp.join(root, "ogbn"))

    @property
    def dataset_dir(self) -> str:
        return osp.join(self.root, f"ogbn_{self.name}")

    def _raw_exists(self) -> bool:
        d = osp.join(self.dataset_dir, "raw")
        return osp.isdir(d) and any(f.startswith("edge") for f in os.listdir(d))

    @property
    def _zip_name(self) -> str:
        return {"papers100M": "papers100M-bin"}.get(self.name, self.name)

    @property
    def raw_urls(self) -> dict:
        return {f"{self._zip_name}.zip": f"{_OGB_URL}/{self._zip_name}.zip"}

    def _post_download(self) -> None:
        _unzip_into(self, self._zip_name, self.dataset_dir)

    def _read(self, stem: str, dtype) -> np.ndarray:
        raw = osp.join(self.dataset_dir, "raw")
        for ext in (".csv.gz", ".csv", ".npy"):
            p = osp.join(raw, stem + ext)
            if osp.exists(p):
                return np.load(p) if ext == ".npy" else read_csv_gz(p, dtype)
        raise IOError(f"missing OGB raw file {stem} under {raw}")

    def _process(self) -> Graph:
        edges = self._read("edge", np.int64)
        x = np.asarray(self._read("node-feat", np.float32), np.float32)
        y = np.asarray(self._read("node-label", np.float32)).reshape(-1)
        y = np.where(np.isnan(y), -1, y).astype(np.int64)  # papers100M: unlabeled nodes are nan
        src, dst = undirect_and_clean(edges[:, 0], edges[:, 1])
        return Graph.from_coo(src, dst, num_nodes=x.shape[0], x=x, y=y)

    def _split(self) -> None:
        if self._split_mode != "official":
            raise ValueError("Please input valid split pattern!")
        split_dir = osp.join(self.dataset_dir, "split", _SPLIT_DIRS[self.name])
        idx = {}
        for part in ("train", "valid", "test"):
            for ext in (".csv.gz", ".csv", ".npy"):
                p = osp.join(split_dir, part + ext)
                if osp.exists(p):
                    idx[part] = np.load(p) if ext == ".npy" else read_index_csv_gz(p)
                    break
            else:
                raise IOError(f"missing OGB split file {part} under {split_dir}")
        self.train_idx, self.val_idx, self.test_idx = idx["train"], idx["valid"], idx["test"]


class OgbnMag(HeteroNodeDataset):
    """ogbn-mag.  Raw layout: one edge file a relation,
    ``raw/relations/<src>___<rel>___<dst>/edge.csv.gz``, the paper features
    ``raw/node-feat/paper/node-feat.csv.gz``, the paper labels and the time
    split of the papers.  A node type without features gets the mean of its
    neighbours' features (the types are visited in order, so a type
    averaged earlier feeds a later one)."""

    def __init__(self, root: str = "./data/", split: str = "official"):
        self._split_mode = split
        super().__init__(name="mag", root=osp.join(root, "ogbn"))

    @property
    def dataset_dir(self) -> str:
        return osp.join(self.root, "ogbn_mag")

    def _raw_exists(self) -> bool:
        return osp.isdir(osp.join(self.dataset_dir, "raw", "relations"))

    @property
    def raw_urls(self) -> dict:
        return {"mag.zip": f"{_OGB_URL}/mag.zip"}

    def _post_download(self) -> None:
        _unzip_into(self, "mag", self.dataset_dir)

    def _process(self) -> HeteroGraph:
        raw = osp.join(self.dataset_dir, "raw")
        rel_dir = osp.join(raw, "relations")
        edge_index_dict, counts = {}, {}
        for rel in sorted(os.listdir(rel_dir)):
            st, rname, dt = rel.split("___")
            e = read_csv_gz(osp.join(rel_dir, rel, "edge.csv.gz"), np.int64)
            edge_index_dict[(st, rname, dt)] = (e[:, 0], e[:, 1])
            counts[st] = max(counts.get(st, 0), int(e[:, 0].max()) + 1)
            counts[dt] = max(counts.get(dt, 0), int(e[:, 1].max()) + 1)
        paper_x = np.asarray(read_csv_gz(osp.join(raw, "node-feat", "paper", "node-feat.csv.gz")), np.float32)
        paper_y = read_index_csv_gz(osp.join(raw, "node-label", "paper", "node-label.csv.gz"))
        counts["paper"] = paper_x.shape[0]
        hg = HeteroGraph.build(counts, edge_index_dict, x_dict={"paper": paper_x}, y_dict={"paper": paper_y})
        d = paper_x.shape[1]
        for ntype in hg.node_types:
            if hg.nodes[ntype].x is not None:
                continue
            acc = np.zeros((hg.num_node[ntype], d), np.float32)
            cnt = np.zeros(hg.num_node[ntype], np.float32)
            for et, edge in hg.edges.items():
                st, _, dt = hg.edge_type_parts(et)
                if st == ntype and hg.nodes[dt].x is not None:
                    mine, theirs, other = edge.src - hg.offset[st], edge.dst - hg.offset[dt], dt
                elif dt == ntype and hg.nodes[st].x is not None:
                    mine, theirs, other = edge.dst - hg.offset[dt], edge.src - hg.offset[st], st
                else:
                    continue
                np.add.at(acc, mine, hg.nodes[other].x[theirs])
                np.add.at(cnt, mine, 1.0)
            hg.nodes[ntype].x = acc / np.maximum(cnt, 1.0)[:, None]
        return hg

    def _split(self) -> None:
        split_dir = osp.join(self.dataset_dir, "split", "time", "paper")
        self.train_idx = read_index_csv_gz(osp.join(split_dir, "train.csv.gz"))
        self.val_idx = read_index_csv_gz(osp.join(split_dir, "valid.csv.gz"))
        self.test_idx = read_index_csv_gz(osp.join(split_dir, "test.csv.gz"))

    @property
    def num_classes(self) -> int:
        return int(np.asarray(self.data["paper"].y).max()) + 1
