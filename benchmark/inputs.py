"""The benchmark's inputs, made from ``--seed``: a power-law, homophilous
graph at a configuration's published shape, class-centred features, labels
and a split of the published sizes.

The draws are a frozen copy of ``sgl_tpu_torch/datasets/raw_files.py``'s
``undirected_pairs``, ``class_features`` and ``_split_by_counts``, kept here
so that a change to the port's writers cannot change the benchmark's data.
The graph and the features are drawn on the card, in a few large calls.
``Inputs`` holds the arrays both sides are handed: the program gets them
through :func:`bench_dataset`, the plain reference reads them directly.

A configuration may bring inputs of its own (``make_inputs(cfg, seed,
device)`` in its ``configs/<config>.py``) and the program's dataset over
them (``dataset(cfg, inputs)`` in ``entries/<config>.py``).  Of an inputs
object the harness and the judge read only:

* ``num_rows``: the rows of the cached feature (the predict class's nodes
  of a heterogeneous graph);
* ``y``: those rows' labels (int64);
* ``train_idx``, ``val_idx``, ``test_idx``: the split, as indices into
  those rows;
* ``host_bytes``: the bytes on the host that a train job hands the
  program and its precompute uploads.

The rest (``num_nodes``, ``src``, ``dst``, ``x`` here) is read by the
configuration's own hooks, or by the defaults that stand in for them:
:func:`bench_dataset`, the judge's hops of one normalized adjacency and
its degree-ranked sample of rows, and the ``preprocess`` runner, which
takes one graph.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Inputs:
    """What the seed made: the edges in both directions (``src``, ``dst``,
    int32, no self loops), ``x`` (f32), ``y`` (int64) and the split."""

    num_nodes: int
    src: np.ndarray
    dst: np.ndarray
    x: np.ndarray
    y: np.ndarray
    train_idx: np.ndarray
    val_idx: np.ndarray
    test_idx: np.ndarray

    @property
    def num_rows(self) -> int:
        return self.num_nodes

    @property
    def host_bytes(self) -> int:
        """``x``, which a job's precompute uploads."""
        return self.x.nbytes


def _generator(rng, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(int(rng.integers(2**62)))


def undirected_pairs(num_nodes: int, num_pairs: int, rng, labels=None, homophily: float = 0.8,
                     skew: float = 0.35, device="cpu") -> np.ndarray:
    """``num_pairs`` distinct pairs ``(u, v)``, ``u < v``, as ``(P, 2)``
    int64: each end drawn with a power-law preference (rank ``k``'s degree
    falls as ``k^-skew``, over a random rank order); with ``labels`` the
    second end is drawn in the first end's class with probability
    ``homophily``."""
    gen = _generator(rng, device)
    dev = gen.device
    n = num_nodes
    alpha = 1.0 / (1.0 - skew)

    def ranks(size, count):  # f32 may round count·r^alpha up to count
        r = torch.rand(size, generator=gen, device=dev) ** alpha
        return torch.minimum((count * r).long(), torch.as_tensor(count, device=dev) - 1)

    hub = torch.randperm(n, generator=gen, device=dev)  # rank -> node
    if labels is not None:
        labels = torch.as_tensor(np.asarray(labels), dtype=torch.long, device=dev)
        rank = torch.empty(n, dtype=torch.long, device=dev)
        rank[hub] = torch.arange(n, device=dev)
        by_class = torch.argsort(labels * n + rank)  # class by class, in rank order
        counts = torch.bincount(labels)
        start = counts.cumsum(0) - counts
    keys = torch.empty(0, dtype=torch.long, device=dev)
    new_share = 0.9  # of the pairs drawn, the share not drawn before
    while keys.numel() < num_pairs:
        m = int((num_pairs - keys.numel()) / new_share * 1.1) + 16
        u, v = hub[ranks(m, n)], hub[ranks(m, n)]
        if labels is not None:
            same = torch.nonzero(torch.rand(m, generator=gen, device=dev) < homophily).flatten()
            cu = labels[u[same]]
            v[same] = by_class[start[cu] + ranks(same.numel(), counts[cu])]
        keep = u != v
        fresh = torch.unique(torch.minimum(u, v)[keep] * n + torch.maximum(u, v)[keep])
        if keys.numel():  # the pairs not drawn before, merged in
            fresh = fresh[keys[torch.searchsorted(keys, fresh).clamp_max(keys.numel() - 1)] != fresh]
            keys = torch.sort(torch.cat([keys, fresh])).values
        else:
            keys = fresh
        new_share = max(fresh.numel() / m, 1e-3)
    if keys.numel() > num_pairs:
        drop = torch.randperm(keys.numel(), generator=gen, device=dev)[: keys.numel() - num_pairs]
        kept = torch.ones(keys.numel(), dtype=torch.bool, device=dev)
        kept[drop] = False
        keys = keys[kept]
    return torch.stack([keys // n, keys % n], dim=1).cpu().numpy()


def class_features(labels, num_features: int, rng, noise: float = 1.0, device="cpu") -> np.ndarray:
    """f32 features: the node's class centre plus Gaussian noise."""
    gen = _generator(rng, device)
    labels = torch.as_tensor(np.asarray(labels), dtype=torch.long, device=gen.device)
    centers = torch.randn(int(labels.max()) + 1, num_features, generator=gen, device=gen.device)
    x = torch.randn(labels.numel(), num_features, generator=gen, device=gen.device)
    return (x * noise + centers[labels]).cpu().numpy()


def split_by_counts(num_nodes: int, split, rng):
    perm = rng.permutation(num_nodes)
    a, b = split[0], split[0] + split[1]
    return perm[:a], perm[a:b], perm[b:]


def make_inputs(graph_cfg: dict, seed: int, device) -> Inputs:
    """The inputs of one run: ``graph_cfg`` is a configuration's ``graph``
    group (``num_nodes``, ``stored_nonzeros`` (both directions),
    ``num_features``, ``num_classes``, ``split``, and the generator's
    ``homophily``, ``skew``, ``feature_noise``)."""
    rng = np.random.default_rng(seed)
    n = int(graph_cfg["num_nodes"])
    y = rng.integers(0, int(graph_cfg["num_classes"]), n)
    pairs = undirected_pairs(n, int(graph_cfg["stored_nonzeros"]) // 2, rng, labels=y,
                             homophily=float(graph_cfg["homophily"]), skew=float(graph_cfg["skew"]),
                             device=device)
    u, v = pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)
    del pairs
    src, dst = np.concatenate([u, v]), np.concatenate([v, u])
    tr, va, te = split_by_counts(n, graph_cfg["split"], rng)
    x = class_features(y, int(graph_cfg["num_features"]), rng, noise=float(graph_cfg["feature_noise"]),
                       device=device)
    return Inputs(n, src, dst, x, y.astype(np.int64), tr, va, te)


def bench_dataset(inputs: Inputs):
    """A ``sgl_tpu_torch`` ``NodeDataset`` over ``inputs``, built through
    ``Graph.from_coo`` with no file read or written."""
    from sgl_tpu_torch.datasets.base import NodeDataset
    from sgl_tpu_torch.graph.graph import Graph

    class BenchDataset(NodeDataset):
        def _raw_exists(self) -> bool:
            return True

        def _process(self):
            return Graph.from_coo(inputs.src, inputs.dst, num_nodes=inputs.num_nodes, x=inputs.x, y=inputs.y)

        def _split(self) -> None:
            self.train_idx, self.val_idx, self.test_idx = inputs.train_idx, inputs.val_idx, inputs.test_idx

    return BenchDataset("bench", root="unused", use_cache=False)
