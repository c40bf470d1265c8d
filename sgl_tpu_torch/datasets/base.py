"""Dataset abstractions with a process → cache lifecycle.

Counterpart of ``sgl_tpu/datasets/base.py``: ``NodeDataset``,
``HeteroNodeDataset`` (with the NARS machinery: relation-subset subgraphs,
metapath adjacencies, random relation subsets), ``GraphDataset`` (with its
lazy block-diagonal batch) and ``random_split``.  Processed data are
pickled host-numpy containers of this package.  A loader whose raw files
are missing fetches them from its ``raw_urls`` (``datasets/utils.py::
download_to``, then ``_post_download``, e.g. to unzip); offline, or with no
known source, it raises an ``IOError`` naming the file and where to put it.
"""

from __future__ import annotations

import os
import pickle
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.graph.batch import batch_graphs
from sgl_tpu_torch.graph.graph import Graph, HeteroGraph


class DeviceSplit(NamedTuple):
    """Labels and split indices of a node dataset as device tensors."""

    y: torch.Tensor  # [N] int64
    train_idx: torch.Tensor
    val_idx: torch.Tensor
    test_idx: torch.Tensor


class _CachedDataset:
    """The shared lifecycle: ``_process()`` once (raw files parsed, or data
    generated), its result pickle-cached under ``processed/``, then
    ``_split()``.  Subclasses name the cache file's suffix and where the
    result is kept (``_set_processed``/``_get_processed``)."""

    _CACHE_SUFFIX = "torchgraph.pkl"

    def __init__(self, name: str, root: str = "./data/", use_cache: bool = True):
        self.name = name
        self.root = os.path.join(root, name)
        self.raw_dir = os.path.join(self.root, "raw")
        self.processed_dir = os.path.join(self.root, "processed")
        self.train_idx = None
        self.val_idx = None
        self.test_idx = None
        self._use_cache = use_cache
        self._preprocess()
        self._split()

    @property
    def processed_path(self) -> str:
        return os.path.join(self.processed_dir, f"{self.name}.{self._CACHE_SUFFIX}")

    def _preprocess(self) -> None:
        if self._use_cache and os.path.exists(self.processed_path):
            with open(self.processed_path, "rb") as f:
                self._set_processed(pickle.load(f))
            return
        if not self._raw_exists():
            self._download()
        self._set_processed(self._process())
        if self._use_cache:
            os.makedirs(self.processed_dir, exist_ok=True)
            tmp = self.processed_path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(self._get_processed(), f)
            os.replace(tmp, self.processed_path)  # atomic: cache is idempotent

    def _set_processed(self, value) -> None:
        raise NotImplementedError

    def _get_processed(self):
        raise NotImplementedError

    @property
    def raw_file_paths(self) -> List[str]:
        """The raw files a loader parses (empty for generated datasets)."""
        return []

    def _raw_exists(self) -> bool:
        if self.raw_file_paths:
            return all(os.path.exists(p) for p in self.raw_file_paths)
        return os.path.isdir(self.raw_dir) and bool(os.listdir(self.raw_dir))

    @property
    def raw_urls(self) -> dict:
        """``{raw file name: source URL}`` to fetch missing raw files from;
        empty when the loader knows no source."""
        return {}

    def _post_download(self) -> None:
        """Runs after the raw files are fetched (archive extraction)."""

    def _download(self) -> None:
        """Fetch every missing ``raw_urls`` entry into ``raw_dir``, then
        ``_post_download``; raise ``IOError`` naming the missing raw files
        when no source is known."""
        urls = self.raw_urls
        if urls:
            from sgl_tpu_torch.datasets.utils import download_to

            for fname, url in urls.items():
                path = os.path.join(self.raw_dir, fname)
                if not os.path.exists(path):
                    download_to(url, path)
            self._post_download()
            return
        names = [os.path.relpath(p, self.raw_dir) for p in self.raw_file_paths]
        missing = [n for n in names if not os.path.exists(os.path.join(self.raw_dir, n))]
        wanted = f": {', '.join(missing)}" if missing else ""
        raise IOError(
            f"raw files for dataset {self.name!r} not found under {self.raw_dir}, and no download "
            f"source is known for this loader; place the raw files there{wanted}"
        )

    def _process(self):
        raise NotImplementedError

    def _split(self) -> None:
        raise NotImplementedError


class NodeDataset(_CachedDataset):
    """Homogeneous node-level dataset.

    Subclasses implement ``_process() -> Graph`` and ``_split()``;
    processing results are pickle-cached so repeated runs are instant.
    """

    def __init__(self, name: str, root: str = "./data/", use_cache: bool = True):
        self.graph: Optional[Graph] = None
        super().__init__(name, root, use_cache)

    def _set_processed(self, value: Graph) -> None:
        self.graph = value

    def _get_processed(self) -> Graph:
        return self.graph

    def to_device(self, device=None) -> DeviceSplit:
        """Labels and split indices on ``device`` (default: the GPU)."""
        device = resolve_device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

        return DeviceSplit(
            t(np.asarray(self.y).reshape(-1)), t(self.train_idx), t(self.val_idx), t(self.test_idx)
        )

    # -- accessors ---------------------------------------------------------
    @property
    def x(self):
        return self.graph.x

    @property
    def y(self):
        return self.graph.y

    @property
    def adj(self) -> Graph:
        return self.graph

    @property
    def data(self) -> Graph:
        return self.graph

    @property
    def num_node(self) -> int:
        return self.graph.num_nodes

    @property
    def num_features(self) -> int:
        return self.graph.num_features

    @property
    def num_classes(self) -> int:
        return self.graph.num_classes


class HeteroNodeDataset(_CachedDataset):
    """Heterogeneous node-level dataset over a :class:`HeteroGraph`, with
    the NARS machinery: relation-subset subgraph sampling
    (:meth:`sample_by_edge_type`), metapath adjacency
    (:meth:`sample_by_meta_path`) and random relation subsets
    (:meth:`nars_preprocess`).  All of it runs on the host."""

    _CACHE_SUFFIX = "torchhgraph.pkl"

    def __init__(self, name: str, root: str = "./data/", use_cache: bool = True):
        self.data: Optional[HeteroGraph] = None
        super().__init__(name, root, use_cache)

    def _set_processed(self, value: HeteroGraph) -> None:
        self.data = value

    def _get_processed(self) -> HeteroGraph:
        return self.data

    @property
    def node_types(self) -> List[str]:
        return self.data.node_types

    @property
    def edge_types(self) -> List[str]:
        return self.data.edge_types

    def sample_by_edge_type(self, edge_types: Sequence[str]):
        """Relation-subset subgraph, re-indexed and undirected:
        ``(graph, features, node_id)``, the features of the participating
        types stacked in local-id order."""
        g, node_id = self.data.sample_by_edge_type(edge_types)
        feats = []
        for t in self.data.node_types:
            ids = self.data.node_id_dict[t]
            if ids.size and np.isin(ids[0], node_id):
                feats.append(self.data[t].x)
        feature = np.concatenate(feats, axis=0) if feats else None
        return g, feature, node_id

    def sample_by_meta_path(self, meta_path: Sequence[str]):
        """Chained sparse products along a metapath: the (head type × tail
        type) adjacency as a scipy CSR over local ids."""
        import scipy.sparse as sp

        mats = []
        for et in meta_path:
            e = self.data.edges[et]
            st, _, dt = self.data.edge_type_parts(et)
            s = e.src - self.data.offset[st]
            d = e.dst - self.data.offset[dt]
            mats.append(sp.csr_matrix(
                (np.ones(len(s)), (s, d)), shape=(self.data.num_node[st], self.data.num_node[dt])
            ))
        out = mats[0]
        for m in mats[1:]:
            out = out @ m
        return out

    def nars_preprocess(
        self,
        edge_types: Sequence[str],
        predict_class: str,
        random_subgraph_num: int,
        subgraph_edge_type_num: int,
        seed: int = 42,
    ):
        """``random_subgraph_num`` distinct relation subsets of
        ``subgraph_edge_type_num`` types (from ``seed``), each mapped to its
        union subgraph ``(graph, features, node_id)``."""
        from sgl_tpu_torch.datasets.choose_edge_type import choose_multi_subgraphs

        combos = choose_multi_subgraphs(
            random_subgraph_num, subgraph_edge_type_num, list(edge_types), predict_class, seed=seed
        )
        return {tuple(combo): self.sample_by_edge_type(combo) for combo in combos}

    @property
    def num_classes(self) -> int:
        raise NotImplementedError


class GraphDataset(_CachedDataset):
    """Graph-level dataset: a list of :class:`Graph` with one label each.

    Subclasses provide ``_process() -> (List[Graph], labels)``; the
    block-diagonal :class:`~sgl_tpu_torch.graph.batch.GraphBatch` of all
    graphs is built on first use of :meth:`batch` and kept.
    """

    _CACHE_SUFFIX = "torchgraphs.pkl"

    def __init__(self, name: str, root: str = "./data/", use_cache: bool = True):
        self.graphs = None
        self.y = None
        self._batch = None
        super().__init__(name, root, use_cache)

    def _set_processed(self, value) -> None:
        graphs, y = value
        self.graphs, self.y = graphs, np.asarray(y)

    def _get_processed(self):
        return self.graphs, self.y

    def _split(self) -> None:
        self.train_idx, self.val_idx, self.test_idx = random_split(self.num_graphs, 0.6, 0.2, seed=0)

    def batch(self):
        """The block-diagonal :class:`GraphBatch` of all graphs (built once)."""
        if self._batch is None:
            self._batch = batch_graphs(self.graphs, y=self.y)
        return self._batch

    @property
    def num_graphs(self) -> int:
        return len(self.graphs)

    @property
    def num_features(self) -> int:
        return self.graphs[0].num_features

    @property
    def num_classes(self) -> int:
        y = np.asarray(self.y)
        return int(y.max()) + 1 if y.ndim == 1 else y.shape[1]


def random_split(
    num_node: int,
    train_ratio: float = 0.6,
    val_ratio: float = 0.2,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random train/val/test split (same permutation as ``sgl_tpu``)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_node)
    n_train = int(num_node * train_ratio)
    n_val = int(num_node * val_ratio)
    return (
        perm[:n_train],
        perm[n_train : n_train + n_val],
        perm[n_train + n_val :],
    )
