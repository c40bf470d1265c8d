"""Dataset abstractions with a download → process → cache lifecycle.

Counterpart of ``sgl_tpu/datasets/base.py::NodeDataset`` and
``random_split``.  Processed graphs are pickled host-numpy
:class:`~sgl_tpu_torch.graph.Graph` containers.  Downloading is not part of
this package: a loader whose raw files are missing raises, naming the files
to place under its ``raw/`` directory.
"""

from __future__ import annotations

import os
import pickle
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.graph.graph import Graph


class DeviceSplit(NamedTuple):
    """Labels and split indices of a node dataset as device tensors."""

    y: torch.Tensor  # [N] int64
    train_idx: torch.Tensor
    val_idx: torch.Tensor
    test_idx: torch.Tensor


class NodeDataset:
    """Homogeneous node-level dataset.

    Subclasses implement ``_process() -> Graph`` and ``_split()``;
    processing results are pickle-cached so repeated runs are instant.
    """

    def __init__(self, name: str, root: str = "./data/", use_cache: bool = True):
        self.name = name
        self.root = os.path.join(root, name)
        self.raw_dir = os.path.join(self.root, "raw")
        self.processed_dir = os.path.join(self.root, "processed")
        self.graph: Optional[Graph] = None
        self.train_idx = None
        self.val_idx = None
        self.test_idx = None
        self._use_cache = use_cache
        self._preprocess()
        self._split()

    # -- lifecycle ---------------------------------------------------------
    @property
    def processed_path(self) -> str:
        return os.path.join(self.processed_dir, f"{self.name}.torchgraph.pkl")

    def _preprocess(self) -> None:
        if self._use_cache and os.path.exists(self.processed_path):
            with open(self.processed_path, "rb") as f:
                self.graph = pickle.load(f)
            return
        if not self._raw_exists():
            self._download()
        self.graph = self._process()
        if self._use_cache:
            os.makedirs(self.processed_dir, exist_ok=True)
            tmp = self.processed_path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(self.graph, f)
            os.replace(tmp, self.processed_path)  # atomic: cache is idempotent

    @property
    def raw_file_paths(self) -> List[str]:
        """The raw files a loader parses (empty for generated datasets)."""
        return []

    def _raw_exists(self) -> bool:
        if self.raw_file_paths:
            return all(os.path.exists(p) for p in self.raw_file_paths)
        return os.path.isdir(self.raw_dir) and bool(os.listdir(self.raw_dir))

    def _download(self) -> None:
        names = [os.path.basename(p) for p in self.raw_file_paths]
        missing = [n for n in names if not os.path.exists(os.path.join(self.raw_dir, n))]
        wanted = f": {', '.join(missing)}" if missing else ""
        raise IOError(
            f"raw files for dataset {self.name!r} not found under {self.raw_dir}; "
            f"sgl_tpu_torch does not download datasets, place the raw files there{wanted}"
        )

    def _process(self) -> Graph:
        raise NotImplementedError

    def _split(self) -> None:
        raise NotImplementedError

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
