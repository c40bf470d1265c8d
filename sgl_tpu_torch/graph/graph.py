"""Homogeneous padded-COO graph container (host numpy).

Counterpart of ``sgl_tpu/graph/graph.py::Graph`` with the same layout and
padding convention, so both packages build identical arrays from the same
edges:

* edges are sorted by ``dst`` (then ``src``), three flat arrays
  ``(src, dst, val)``;
* padding edges are ``src=0, dst=num_nodes-1, val=0``: they contribute
  zero to degrees and products and keep ``dst`` sorted.

The graph stays in host memory; the graph ops build device tensors from it.
Sorting is numpy ``lexsort`` at every size (``sgl_tpu`` switches to a native
OpenMP sort above 1M edges; only the ``dst`` order matters to the kernels,
so the two agree on every array the kernels read).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_amount(num_edges: int, multiple: int) -> int:
    """Edges are padded to a bucket multiple (same buckets as ``sgl_tpu``)."""
    return max(_round_up(max(num_edges, 1), multiple) - num_edges, 0)


@dataclasses.dataclass(frozen=True)
class Graph:
    """Padded-COO homogeneous graph.

    ``src``/``dst``/``val`` have length ``num_edges_padded``; entries past
    ``num_edges`` are zero-valued padding.  Messages flow ``src -> dst``.
    """

    src: np.ndarray  # [E_pad] int32
    dst: np.ndarray  # [E_pad] int32
    val: np.ndarray  # [E_pad] float32, 0 on padding
    x: Optional[np.ndarray]  # [N, D] node features
    y: Optional[np.ndarray]  # [N] or [N, C] node labels
    num_nodes: int
    num_edges: int  # real (un-padded) edge count

    @staticmethod
    def from_coo(
        src,
        dst,
        val=None,
        *,
        num_nodes: int,
        x=None,
        y=None,
        pad_multiple: int = 1024,
        sort: bool = True,
    ) -> "Graph":
        src = np.asarray(src, dtype=np.int32).reshape(-1)
        dst = np.asarray(dst, dtype=np.int32).reshape(-1)
        if val is None:
            val = np.ones(src.shape[0], dtype=np.float32)
        else:
            val = np.asarray(val, dtype=np.float32).reshape(-1)
        if not (src.shape == dst.shape == val.shape):
            raise ValueError("src/dst/val must have identical 1-D shapes")
        if src.size and (src.min() < 0 or src.max() >= num_nodes):
            raise ValueError("src indices out of range")
        if dst.size and (dst.min() < 0 or dst.max() >= num_nodes):
            raise ValueError("dst indices out of range")
        num_edges = int(src.shape[0])
        if sort and num_edges:
            order = np.lexsort((src, dst))
            src, dst, val = src[order], dst[order], val[order]
        pad = pad_amount(num_edges, pad_multiple)
        if pad:
            src = np.concatenate([src, np.zeros(pad, np.int32)])
            dst = np.concatenate([dst, np.full(pad, max(num_nodes - 1, 0), np.int32)])
            val = np.concatenate([val, np.zeros(pad, np.float32)])
        if x is not None:
            x = np.asarray(x, dtype=np.float32)
            if x.shape[0] != num_nodes:
                raise ValueError("feature row count != num_nodes")
        if y is not None:
            y = np.asarray(y)
        return Graph(src, dst, val, x, y, num_nodes, num_edges)

    @property
    def num_edges_padded(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_features(self) -> int:
        if self.x is None:
            raise ValueError("graph has no node features")
        return int(self.x.shape[1])

    @property
    def num_classes(self) -> int:
        if self.y is None:
            raise ValueError("graph has no labels")
        y = np.asarray(self.y)
        if y.ndim > 1 and y.shape[-1] > 1:
            return int(y.shape[-1])
        return int(y.max()) + 1

    def replace(self, **kw) -> "Graph":
        return dataclasses.replace(self, **kw)

    def edges(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Real (un-padded) edges as numpy arrays."""
        e = self.num_edges
        return self.src[:e], self.dst[:e], self.val[:e]
