"""The other homogeneous loaders — counterpart of
``sgl_tpu/datasets/web_datasets.py``:

* :class:`Actor` and :class:`WebKB`: geom-gcn's ``out1_node_feature_label.txt``
  and ``out1_graph_edges.txt`` (Actor's features are lists of one-hot
  columns, WebKB's dense comma-separated values);
* :class:`Airports`: struc2vec's ``<name>-airports.edgelist`` and
  ``labels-<name>-airports.txt``, identity features;
* :class:`Github`, :class:`Facebook` and :class:`Twitch`: the musae npz
  layout (``edges``, ``features``, ``target``);
* :class:`Wikics`: wiki-cs ``data.json`` (``features``, ``labels``,
  ``links``);
* :class:`LINKXDataset`: LINKX's facebook100 ``.mat`` files (``A`` and
  ``local_info``; the label is the gender column, every other column
  one-hot encoded as features);
* :class:`KarateClub`: Zachary's karate club, built in.

Every graph is made undirected, without self loops or repeated edges
(Wikics's only with ``is_undirected``).  Every split is
:func:`random_split`'s: ``split`` is accepted and not read, as in
``sgl_tpu``.
"""

from __future__ import annotations

import json
import os.path as osp

import numpy as np

from sgl_tpu_torch.datasets.base import NodeDataset, random_split
from sgl_tpu_torch.datasets.utils import undirect_and_clean
from sgl_tpu_torch.graph.graph import Graph

_GEOM_GCN = "https://raw.githubusercontent.com/graphdml-uiuc-jlu/geom-gcn/master"


def _tab_rows(path: str):
    """The tab-separated rows of a geom-gcn text file, header dropped."""
    with open(path) as f:
        return [r.split("\t") for r in f.read().split("\n")[1:] if r]


class _RandomSplit(NodeDataset):
    def _split(self):
        self.train_idx, self.val_idx, self.test_idx = random_split(self.num_node)


class Actor(_RandomSplit):
    """geom-gcn's film dataset: one-hot feature columns listed a node."""

    _GEOM_GCN_DIR = "film"

    def __init__(self, root: str = "./data/", split: str = "random", name: str = "actor"):
        self._split_mode = split
        super().__init__(name=name, root=osp.join(root, name))

    @property
    def raw_file_paths(self):
        return [
            osp.join(self.raw_dir, "out1_node_feature_label.txt"),
            osp.join(self.raw_dir, "out1_graph_edges.txt"),
        ]

    @property
    def raw_urls(self):
        return {
            osp.basename(p): f"{_GEOM_GCN}/new_data/{self._GEOM_GCN_DIR}/{osp.basename(p)}"
            for p in self.raw_file_paths
        }

    def _parse_features(self):
        rows = _tab_rows(self.raw_file_paths[0])
        n = len(rows)
        max_col = max(int(c) for _, cols, _ in rows for c in cols.split(","))
        x = np.zeros((n, max_col + 1), np.float32)
        y = np.zeros(n, np.int64)
        for nid, cols, label in rows:
            x[int(nid), [int(c) for c in cols.split(",")]] = 1.0
            y[int(nid)] = int(label)
        return x, y

    def _process(self) -> Graph:
        x, y = self._parse_features()
        e = np.asarray(_tab_rows(self.raw_file_paths[1]), np.int64)
        src, dst = undirect_and_clean(e[:, 0], e[:, 1])
        return Graph.from_coo(src, dst, num_nodes=x.shape[0], x=x, y=y)


class WebKB(Actor):
    """geom-gcn's webkb (``"cornell"``, ``"texas"``, ``"wisconsin"``): dense
    comma-separated features."""

    def __init__(self, name: str = "cornell", root: str = "./data/", split: str = "random"):
        if name not in ("cornell", "texas", "wisconsin"):
            raise ValueError("Dataset name not supported!")
        self._split_mode = split
        NodeDataset.__init__(self, name=name, root=osp.join(root, "webkb"))

    @property
    def _GEOM_GCN_DIR(self):  # noqa: N802 — Actor's class attribute, by name
        return self.name

    def _parse_features(self):
        rows = _tab_rows(self.raw_file_paths[0])
        x = np.asarray([[float(v) for v in cols.split(",")] for _, cols, _ in rows], np.float32)
        y = np.asarray([int(label) for _, _, label in rows], np.int64)
        return x, y


class Airports(_RandomSplit):
    """struc2vec's airports (``"usa"``, ``"brazil"``, ``"europe"``): the
    label file's order numbers the nodes; identity features."""

    def __init__(self, name: str = "usa", root: str = "./data/", split: str = "random"):
        if name not in ("usa", "brazil", "europe"):
            raise ValueError("Dataset name not supported!")
        self._split_mode = split
        super().__init__(name=name, root=osp.join(root, "airports"))

    @property
    def raw_file_paths(self):
        return [
            osp.join(self.raw_dir, f"{self.name}-airports.edgelist"),
            osp.join(self.raw_dir, f"labels-{self.name}-airports.txt"),
        ]

    @property
    def raw_urls(self):
        base = "https://github.com/leoribeiro/struc2vec/raw/master/graph"
        return {osp.basename(p): f"{base}/{osp.basename(p)}" for p in self.raw_file_paths}

    def _process(self) -> Graph:
        index_map, ys = {}, []
        with open(self.raw_file_paths[1]) as f:
            for i, row in enumerate(r for r in f.read().split("\n")[1:] if r):
                idx, y = row.split()
                index_map[int(idx)] = i
                ys.append(int(y))
        y = np.asarray(ys, np.int64)
        x = np.eye(len(y), dtype=np.float32)
        src, dst = [], []
        with open(self.raw_file_paths[0]) as f:
            for row in (r for r in f.read().split("\n") if r):
                a, b = row.split()
                src.append(index_map[int(a)])
                dst.append(index_map[int(b)])
        s, d = undirect_and_clean(np.asarray(src, np.int64), np.asarray(dst, np.int64))
        return Graph.from_coo(s, d, num_nodes=len(y), x=x, y=y)


class _MusaeNpz(_RandomSplit):
    """The musae npz layout: ``edges`` (E, 2), ``features``, ``target``."""

    _MUSAE_BASE = "https://graphmining.ai/datasets/ptg"

    @property
    def raw_file_paths(self):
        return [osp.join(self.raw_dir, f"{self.name}.npz")]

    @property
    def raw_urls(self):
        return {f"{self.name}.npz": f"{self._MUSAE_BASE}/{self.name}.npz"}

    def _process(self) -> Graph:
        data = np.load(self.raw_file_paths[0])
        x = np.asarray(data["features"], np.float32)
        y = np.asarray(data["target"], np.int64)
        e = np.asarray(data["edges"], np.int64)
        src, dst = undirect_and_clean(e[:, 0], e[:, 1])
        return Graph.from_coo(src, dst, num_nodes=x.shape[0], x=x, y=y)


class Github(_MusaeNpz):
    def __init__(self, root: str = "./data/", split: str = "random"):
        super().__init__(name="github", root=osp.join(root, "github"))


class Facebook(_MusaeNpz):
    def __init__(self, root: str = "./data/", split: str = "random"):
        super().__init__(name="facebook", root=osp.join(root, "facebook"))


class Twitch(_MusaeNpz):
    """``Twitch(name)``: one of ``"DE"``, ``"EN"``, ``"ES"``, ``"FR"``,
    ``"PT"``, ``"RU"``."""

    _MUSAE_BASE = "https://graphmining.ai/datasets/ptg/twitch"

    def __init__(self, name: str = "EN", root: str = "./data/", split: str = "random"):
        if name not in ("DE", "EN", "ES", "FR", "PT", "RU"):
            raise ValueError("Dataset name not supported!")
        super().__init__(name=name, root=osp.join(root, "twitch"))


class Wikics(_RandomSplit):
    """wiki-cs: ``links[i]`` lists node ``i``'s out-neighbours."""

    def __init__(self, root: str = "./data/", split: str = "random", is_undirected: bool = True):
        self._split_mode = split
        self._is_undirected = is_undirected
        super().__init__(name="wikics", root=osp.join(root, "wikics"))

    @property
    def raw_file_paths(self):
        return [osp.join(self.raw_dir, "data.json")]

    @property
    def raw_urls(self):
        return {"data.json": "https://github.com/pmernyei/wiki-cs-dataset/raw/master/dataset/data.json"}

    def _process(self) -> Graph:
        with open(self.raw_file_paths[0]) as f:
            data = json.load(f)
        x = np.asarray(data["features"], np.float32)
        y = np.asarray(data["labels"], np.int64)
        src = np.asarray([i for i, js in enumerate(data["links"]) for _ in js], np.int64)
        dst = np.asarray([j for js in data["links"] for j in js], np.int64)
        if self._is_undirected:
            src, dst = undirect_and_clean(src, dst)
        return Graph.from_coo(src, dst, num_nodes=x.shape[0], x=x, y=y)


class LINKXDataset(_RandomSplit):
    """LINKX's facebook100 graphs (``"penn94"``, ``"reed98"``,
    ``"amherst41"``, ``"cornell5"``, ``"johnshopkins55"``): ``A`` the
    adjacency, ``local_info`` the demographics; the label is the gender
    column less one (unlabeled: -1), every other column one-hot encoded."""

    NAMES = ("penn94", "reed98", "amherst41", "cornell5", "johnshopkins55")
    FILES = {
        "penn94": "Penn94.mat",
        "reed98": "Reed98.mat",
        "amherst41": "Amherst41.mat",
        "cornell5": "Cornell5.mat",
        "johnshopkins55": "Johns Hopkins55.mat",
    }

    def __init__(self, name: str = "penn94", root: str = "./data/", split: str = "random"):
        if name not in self.NAMES:
            raise ValueError("Dataset name not supported!")
        self._split_mode = split
        super().__init__(name=name, root=osp.join(root, "linkx"))

    @property
    def raw_file_paths(self):
        return [osp.join(self.raw_dir, self.FILES[self.name])]

    @property
    def raw_urls(self):
        base = "https://github.com/CUAI/Non-Homophily-Large-Scale/raw/master/data/facebook100"
        fname = self.FILES[self.name]
        return {fname: f"{base}/{fname.replace(' ', '%20')}"}

    def _process(self) -> Graph:
        from scipy.io import loadmat

        mat = loadmat(self.raw_file_paths[0])
        adj = mat["A"].tocoo()
        meta = np.asarray(mat["local_info"], np.int64)
        y = meta[:, 1] - 1
        feats = np.concatenate([meta[:, :1], meta[:, 2:]], axis=1)
        cols = []
        for j in range(feats.shape[1]):
            vals, inv = np.unique(feats[:, j], return_inverse=True)
            onehot = np.zeros((feats.shape[0], len(vals)), np.float32)
            onehot[np.arange(feats.shape[0]), inv] = 1.0
            cols.append(onehot)
        x = np.concatenate(cols, axis=1)
        src, dst = undirect_and_clean(adj.row.astype(np.int64), adj.col.astype(np.int64))
        return Graph.from_coo(src, dst, num_nodes=x.shape[0], x=x, y=y)


# Zachary's karate club: the 78 friendships, in the order
# networkx.karate_club_graph().edges() lists them
KARATE_EDGES = (
    (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 10), (0, 11), (0, 12), (0, 13), (0, 17),
    (0, 19), (0, 21), (0, 31), (1, 2), (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21), (1, 30), (2, 3), (2, 7),
    (2, 8), (2, 9), (2, 13), (2, 27), (2, 28), (2, 32), (3, 7), (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10),
    (5, 16), (6, 16), (8, 30), (8, 32), (8, 33), (9, 33), (13, 33), (14, 32), (14, 33), (15, 32), (15, 33), (18, 32),
    (18, 33), (19, 33), (20, 32), (20, 33), (22, 32), (22, 33), (23, 25), (23, 27), (23, 29), (23, 32), (23, 33),
    (24, 25), (24, 27), (24, 31), (25, 31), (26, 29), (26, 33), (27, 33), (28, 31), (28, 33), (29, 32), (29, 33),
    (30, 32), (30, 33), (31, 32), (31, 33), (32, 33),
)
KARATE_NODES = 34


class KarateClub(_RandomSplit):
    """Zachary's karate club (34 nodes, 78 friendships, four communities),
    built in: no raw files, no cache; identity features."""

    LABELS = np.asarray(
        [1, 1, 1, 1, 3, 3, 3, 1, 0, 1, 3, 1, 1, 1, 0, 0, 3, 1, 0, 1, 0, 1,
         0, 0, 2, 2, 0, 0, 2, 0, 0, 2, 0, 0],
        np.int64,
    )

    def __init__(self, root: str = "./data/", split: str = "random"):
        self._split_mode = split
        super().__init__(name="karateclub", root=osp.join(root, "karateclub"), use_cache=False)

    def _raw_exists(self):
        return True

    def _process(self) -> Graph:
        e = np.asarray(KARATE_EDGES, np.int64)
        s, d = undirect_and_clean(e[:, 0], e[:, 1])
        x = np.eye(KARATE_NODES, dtype=np.float32)
        return Graph.from_coo(s, d, num_nodes=KARATE_NODES, x=x, y=self.LABELS)
