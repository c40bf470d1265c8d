"""Loaders of npz-family homogeneous datasets — counterpart of
``sgl_tpu/datasets/npz_datasets.py``:

* :class:`Amazon` and :class:`Coauthor`: the gnn-benchmark npz files
  (``amazon_electronics_{computers,photo}.npz``, ``ms_academic_{cs,phy}.npz``);
* :class:`Reddit`: DGL's ``reddit.zip``, holding ``reddit_graph.npz`` (the
  sparse adjacency) and ``reddit_data.npz`` (``feature``, ``label``,
  ``node_types``: 1 train, 2 validation, 3 test);
* :class:`Flickr` and :class:`AmazonProduct`: GraphSAINT's ``adj_full.npz``,
  ``feats.npy``, ``class_map.json`` and ``role.json``.  A list-valued class
  (AmazonProduct is multi-label) is taken as its argmax.

Missing raw files are fetched from ``raw_urls`` (``reddit.zip`` is
unzipped); offline the loader raises an ``IOError`` naming them.
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np
import scipy.sparse as sp

from sgl_tpu_torch.datasets.base import NodeDataset, random_split
from sgl_tpu_torch.datasets.utils import read_npz, undirect_and_clean
from sgl_tpu_torch.graph.graph import Graph


class Amazon(NodeDataset):
    """``Amazon(name, root, split)``: ``name`` is ``"computers"`` or
    ``"photo"``; the only split is ``"random"`` (:func:`random_split`)."""

    def __init__(self, name: str = "photo", root: str = "./data/", split: str = "random"):
        if name not in ("computers", "photo"):
            raise ValueError("Dataset name not supported!")
        self._split_mode = split
        super().__init__(name=name, root=osp.join(root, "amazon"))

    @property
    def raw_file_paths(self):
        return [osp.join(self.raw_dir, f"amazon_electronics_{self.name}.npz")]

    @property
    def raw_urls(self):
        base = "https://github.com/shchur/gnn-benchmark/raw/master/data/npz"
        return {osp.basename(p): f"{base}/{osp.basename(p)}" for p in self.raw_file_paths}

    def _process(self) -> Graph:
        x, src, dst, y = read_npz(self.raw_file_paths[0])
        return Graph.from_coo(src, dst, num_nodes=x.shape[0], x=x, y=y)

    def _split(self):
        if self._split_mode != "random":
            raise ValueError("Please input valid split pattern!")
        self.train_idx, self.val_idx, self.test_idx = random_split(self.num_node)


class Coauthor(Amazon):
    """``Coauthor(name, root, split)``: ``name`` is ``"cs"`` or ``"phy"``."""

    def __init__(self, name: str = "cs", root: str = "./data/", split: str = "random"):
        if name not in ("cs", "phy"):
            raise ValueError("Dataset name not supported!")
        self._split_mode = split
        NodeDataset.__init__(self, name=name, root=osp.join(root, "coauthor"))

    @property
    def raw_file_paths(self):
        return [osp.join(self.raw_dir, f"ms_academic_{self.name}.npz")]


class Reddit(NodeDataset):
    """``Reddit(root, split)``: ``split="official"`` reads the split from
    ``node_types``; any other ``split`` is :func:`random_split`'s.  The
    adjacency is taken as stored (it is symmetric), its values as edge
    weights."""

    def __init__(self, root: str = "./data/", split: str = "official"):
        self._split_mode = split
        self._node_types = None
        super().__init__(name="reddit", root=osp.join(root, "reddit"))

    @property
    def raw_file_paths(self):
        return [osp.join(self.raw_dir, "reddit_graph.npz"), osp.join(self.raw_dir, "reddit_data.npz")]

    def _raw_exists(self):
        return osp.exists(self.raw_file_paths[0])

    @property
    def raw_urls(self):
        return {"reddit.zip": "https://data.dgl.ai/dataset/reddit.zip"}

    def _post_download(self) -> None:
        import zipfile

        path = osp.join(self.raw_dir, "reddit.zip")
        with zipfile.ZipFile(path) as zf:
            zf.extractall(self.raw_dir)
        os.unlink(path)

    def _process(self) -> Graph:
        adj = sp.load_npz(self.raw_file_paths[0]).tocoo()
        data = np.load(self.raw_file_paths[1])
        x = np.asarray(data["feature"], np.float32)
        y = np.asarray(data["label"], np.int64)
        self._node_types = np.asarray(data["node_types"])
        return Graph.from_coo(adj.row, adj.col, adj.data, num_nodes=x.shape[0], x=x, y=y)

    def _split(self):
        if self._split_mode == "official":
            nt = self._node_types
            if nt is None:  # the graph came from the processed cache
                nt = np.load(self.raw_file_paths[1])["node_types"]
            self.train_idx = np.flatnonzero(nt == 1)
            self.val_idx = np.flatnonzero(nt == 2)
            self.test_idx = np.flatnonzero(nt == 3)
        else:
            self.train_idx, self.val_idx, self.test_idx = random_split(self.num_node)


class Flickr(NodeDataset):
    """``Flickr(root, split)``, GraphSAINT's layout; ``split="official"``
    reads ``role.json`` (``tr``/``va``/``te``), any other ``split`` is
    :func:`random_split`'s.  The graph is made undirected, without self
    loops or repeated edges."""

    # GraphSAINT's Google Drive file ids
    _GDRIVE_IDS = {
        "adj_full.npz": "17qhNA8H1IpbkkR-T2BmPQm8QNW5do-aa",
        "feats.npy": "10SW8lCvAj-kb6ckkfTOC5y0l8XXdtMxj",
        "class_map.json": "1LIl4kimLfftj4-7NmValuWyCQE8AaE7P",
        "role.json": "1npK9xlmbnjNkV80hK2Q68wTEVOFjnt4K",
    }

    def __init__(self, root: str = "./data/", split: str = "official", name: str = "flickr"):
        self._split_mode = split
        super().__init__(name=name, root=osp.join(root, name))

    @property
    def raw_file_paths(self):
        return [osp.join(self.raw_dir, f) for f in self._GDRIVE_IDS]

    def _raw_exists(self):
        return osp.exists(osp.join(self.raw_dir, "adj_full.npz"))

    @property
    def raw_urls(self):
        url = "https://docs.google.com/uc?export=download&id={}&confirm=t"
        return {fname: url.format(fid) for fname, fid in self._GDRIVE_IDS.items()}

    def _process(self) -> Graph:
        x = np.asarray(np.load(osp.join(self.raw_dir, "feats.npy")), np.float32)
        n = x.shape[0]
        f = np.load(osp.join(self.raw_dir, "adj_full.npz"))
        adj = sp.csr_matrix((f["data"], f["indices"], f["indptr"]), f["shape"]).tocoo()
        with open(osp.join(self.raw_dir, "class_map.json")) as cf:
            class_map = json.load(cf)
        y = np.zeros(n, np.int64)
        for k, v in class_map.items():
            y[int(k)] = int(v) if np.isscalar(v) else int(np.argmax(v))
        src, dst = undirect_and_clean(adj.row.astype(np.int64), adj.col.astype(np.int64))
        return Graph.from_coo(src, dst, num_nodes=n, x=x, y=y)

    def _split(self):
        if self._split_mode == "official":
            with open(osp.join(self.raw_dir, "role.json")) as rf:
                role = json.load(rf)
            self.train_idx = np.asarray(role["tr"])
            self.val_idx = np.asarray(role["va"])
            self.test_idx = np.asarray(role["te"])
        else:
            self.train_idx, self.val_idx, self.test_idx = random_split(self.num_node)


class AmazonProduct(Flickr):
    """GraphSAINT's Amazon product graph, in Flickr's layout."""

    _GDRIVE_IDS = {
        "adj_full.npz": "1crmsTbd1-2sEXsGwa2IKnIB7Zd3TmUsy",
        "feats.npy": "1join-XdvX3anJU_MLVtick7MgeAQiWIZ",
        "class_map.json": "1uxIkbtg5drHTsKt-PAsZZ4_yJmgFmle9",
        "role.json": "1htXCtuktuCW8TR8KiKfrFDAxUgekQoV7",
    }

    def __init__(self, root: str = "./data/", split: str = "official"):
        super().__init__(root=root, split=split, name="amazon_product")
