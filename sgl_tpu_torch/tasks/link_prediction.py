"""Link prediction tasks — counterpart of ``sgl_tpu/tasks/link_prediction.py``.

``LinkPredictionGAE``: embed the nodes with an SGAP model, score an edge
``(u, v)`` as ``σ(<z_u, z_v>)`` and train with binary cross-entropy over the
positive and sampled negative training edges.  ``LinkPredictionNAFS``:
training-free NAFS smoothing, then the same scores.

``mask_test_edges`` is ``sgl_tpu``'s host algorithm, line for line: the
same numpy generator draws the same split and the same negatives.  ROC-AUC
(ties share their average rank) and average precision (scikit-learn's
step definition) are computed in numpy from the probabilities.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from scipy.stats import rankdata

from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.graph.graph import Graph
from sgl_tpu_torch.tasks.base_task import BaseTask
from sgl_tpu_torch.tasks.node_classification import _sync
from sgl_tpu_torch.tasks.node_clustering import NAFS_R_LIST, _check_method, nafs_smooth_sweep
from sgl_tpu_torch.tasks.utils import adam_l2, set_seed


def _sample_negative_edges(num_nodes: int, count: int, forbidden: set, rng) -> np.ndarray:
    """``count`` distinct non-edges ``(a, b)``, ``a != b``, neither
    direction in ``forbidden`` nor drawn before, by rejection sampling."""
    out = []
    have = set()
    while len(out) < count:
        m = max(2 * (count - len(out)), 1024)
        s = rng.integers(0, num_nodes, m)
        t = rng.integers(0, num_nodes, m)
        for a, b in zip(s, t):
            if a == b:
                continue
            key = (int(a), int(b))
            rkey = (int(b), int(a))
            if key in forbidden or key in have or rkey in have:
                continue
            have.add(key)
            out.append(key)
            if len(out) == count:
                break
    return np.asarray(out, dtype=np.int64)


def mask_test_edges(graph: Graph, seed: int = 0):
    """Split the undirected edges: 10% test and 5% validation positives,
    each set with as many negatives.  Returns ``(train_graph, train_edges,
    train_neg, val_edges, val_neg, test_edges, test_neg)``; the edge lists
    hold one direction, the training graph both."""
    rng = np.random.default_rng(seed)
    src, dst, _ = graph.edges()
    keep = src < dst  # the upper triangle, without self-loops
    es, ed = src[keep], dst[keep]
    n_e = es.shape[0]
    n_test = n_e // 10
    n_val = n_e // 20
    perm = rng.permutation(n_e)
    val_i = perm[:n_val]
    test_i = perm[n_val : n_val + n_test]
    train_i = perm[n_val + n_test :]
    all_set = set(zip(src.tolist(), dst.tolist()))
    train_edges = np.stack([es[train_i], ed[train_i]], axis=1)
    val_edges = np.stack([es[val_i], ed[val_i]], axis=1)
    test_edges = np.stack([es[test_i], ed[test_i]], axis=1)
    train_neg = _sample_negative_edges(graph.num_nodes, len(train_edges), all_set, rng)
    val_neg = _sample_negative_edges(graph.num_nodes, len(val_edges), all_set, rng)
    test_neg = _sample_negative_edges(graph.num_nodes, len(test_edges), all_set, rng)
    ts, td = train_edges[:, 0], train_edges[:, 1]
    train_graph = Graph.from_coo(
        np.concatenate([ts, td]), np.concatenate([td, ts]),
        num_nodes=graph.num_nodes, x=graph.x, y=graph.y,
    )
    return train_graph, train_edges, train_neg, val_edges, val_neg, test_edges, test_neg


def edge_scores(z: torch.Tensor, edges) -> torch.Tensor:
    """``<z_u, z_v>`` for each row ``(u, v)`` of ``edges`` (an array or a
    tensor)."""
    e = torch.as_tensor(edges, device=z.device).long()
    return (z[e[:, 0]] * z[e[:, 1]]).sum(dim=1)


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Area under the ROC curve: the Mann-Whitney statistic, tied scores
    taking their average rank."""
    labels = np.asarray(labels).astype(bool)
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    ranks = rankdata(scores)
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def average_precision(labels: np.ndarray, scores: np.ndarray) -> float:
    """``Σ (R_k - R_{k-1}) P_k`` over the distinct scores, highest first:
    scikit-learn's ``average_precision_score``."""
    labels = np.asarray(labels, np.float64)
    order = np.argsort(scores, kind="mergesort")[::-1]
    s, y = np.asarray(scores)[order], labels[order]
    last = np.r_[np.nonzero(np.diff(s))[0], y.size - 1]  # the last index of each score
    tps = np.cumsum(y)[last]
    precision = tps / (last + 1)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def _auc_ap(z: torch.Tensor, pos, neg):
    scores = torch.sigmoid(torch.cat([edge_scores(z, pos), edge_scores(z, neg)])).cpu().numpy()
    labels = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
    return roc_auc(labels, scores), average_precision(labels, scores)


class LinkPredictionGAE(BaseTask):
    def __init__(
        self,
        dataset,
        model,
        lr: float,
        weight_decay: float,
        epochs: int,
        device=None,
        seed: int = 42,
        train_batch_size=None,
        eval_batch_size=None,
        threshold: float = 0.5,
        verbose: bool = True,
    ):
        super().__init__()
        self._dataset = dataset
        self._model = model
        self._device = resolve_device(device)
        self._lr = lr
        self._weight_decay = weight_decay
        self._epochs = epochs
        self._seed = seed
        self._threshold = threshold
        self._verbose = verbose
        #: host seconds of :func:`mask_test_edges`
        self.split_seconds = 0.0
        #: wall seconds of ``model.preprocess`` on the training graph
        self.preprocess_seconds = 0.0
        self._test_roc_auc, self._test_avg_prec = self._execute()

    test_roc_auc = property(lambda self: self._test_roc_auc)
    test_avg_prec = property(lambda self: self._test_avg_prec)

    def _execute(self):
        ds, model, device = self._dataset, self._model, self._device
        init_gen = set_seed(self._seed)
        dropout_gen = torch.Generator(device=device).manual_seed(self._seed)
        t0 = time.perf_counter()
        train_graph, tr_pos, tr_neg, va_pos, va_neg, te_pos, te_neg = mask_test_edges(
            ds.graph, seed=self._seed
        )
        self.split_seconds = time.perf_counter() - t0
        if self._verbose:
            print("Edge split finished!")

        t0 = time.perf_counter()
        model.preprocess(train_graph, ds.x, device=device)
        _sync(device)
        self.preprocess_seconds = time.perf_counter() - t0
        if self._verbose:
            print(f"Preprocessing done in {self.preprocess_seconds:.4f}s")

        feats = model.batch_input(torch.arange(ds.num_node, device=device))
        net = model.net.cpu()
        model.init(init_gen)
        net.to(device)
        params = list(net.parameters())
        optimizer = adam_l2(params, self._lr, self._weight_decay) if params else None
        tr_edges = torch.as_tensor(np.concatenate([tr_pos, tr_neg]), device=device)
        tr_labels = torch.cat([torch.ones(len(tr_pos)), torch.zeros(len(tr_neg))]).to(device)

        def embed():
            with torch.no_grad():
                return net(feats, train=False)

        best = {"auc": (0.0, 0.0), "ap": (0.0, 0.0)}  # (val, test)

        def record(z):
            auc_val, ap_val = _auc_ap(z, va_pos, va_neg)
            auc_test, ap_test = _auc_ap(z, te_pos, te_neg)
            if auc_val > best["auc"][0]:
                best["auc"] = (auc_val, auc_test)
            if ap_val > best["ap"][0]:
                best["ap"] = (ap_val, ap_test)
            return auc_val, ap_val, auc_test, ap_test

        for epoch in range(self._epochs):
            t = time.perf_counter()
            loss = float("nan")
            if optimizer is not None:
                optimizer.zero_grad(set_to_none=True)
                z = net(feats, train=True, generator=dropout_gen)
                logits = edge_scores(z, tr_edges)
                loss = F.binary_cross_entropy_with_logits(logits, tr_labels)
                loss.backward()
                optimizer.step()
                loss = float(loss.detach())
            auc_val, ap_val, auc_test, ap_test = record(embed())
            if self._verbose:
                print(
                    f"Epoch: {epoch + 1:03d} loss_train: {loss:.4f} "
                    f"roc_auc_val: {auc_val:.4f} avg_prec_val: {ap_val:.4f} "
                    f"roc_auc_test: {auc_test:.4f} avg_prec_test: {ap_test:.4f} "
                    f"time: {time.perf_counter() - t:.4f}s"
                )
            if optimizer is None:
                break  # a training-free model: the metrics cannot change

        # the model's optional post-propagation on the embeddings
        record(model.postprocess(train_graph, embed()))
        if self._verbose:
            print(
                f"Best roc_auc_test: {best['auc'][1]:.4f}, "
                f"best avg_prec_test: {best['ap'][1]:.4f}"
            )
        self.net = net
        return best["auc"][1], best["ap"][1]


class LinkPredictionNAFS(BaseTask):
    """Training-free NAFS link prediction: the test edges scored on every
    hop of the sweep over the training graph."""

    def __init__(
        self,
        dataset,
        hops=20,
        method: str = "mean",
        seed: int = 42,
        r_list: Sequence[float] = NAFS_R_LIST,
        threshold: float = 0.5,
        verbose: bool = True,
        device=None,
    ):
        super().__init__()
        if not isinstance(hops, (list, int, range)):
            raise ValueError("hops type not supported!")
        self._dataset = dataset
        self._method = _check_method(method)
        self._r_list = list(r_list)
        self._hops = range(hops) if isinstance(hops, int) else hops
        self._seed = seed
        self._verbose = verbose
        self._device = resolve_device(device)
        #: host seconds of :func:`mask_test_edges`
        self.split_seconds = 0.0
        (
            self._best_hop_roc_auc,
            self._best_hop_avg_prec,
            self._test_roc_auc,
            self._test_avg_prec,
        ) = self._execute()

    test_roc_auc = property(lambda self: self._test_roc_auc)
    test_avg_prec = property(lambda self: self._test_avg_prec)
    best_hop_roc_auc = property(lambda self: self._best_hop_roc_auc)
    best_hop_avg_prec = property(lambda self: self._best_hop_avg_prec)

    def _execute(self):
        set_seed(self._seed)
        ds = self._dataset
        t0 = time.perf_counter()
        train_graph, _, _, _, _, te_pos, te_neg = mask_test_edges(ds.graph, seed=self._seed)
        self.split_seconds = time.perf_counter() - t0
        if self._verbose:
            print("Edge split finished!")
        best_auc, best_ap = 0.0, 0.0
        best_hop_auc, best_hop_ap = 0, 0
        t = time.perf_counter()
        for hop, z in nafs_smooth_sweep(train_graph, ds.x, self._hops, self._r_list, self._method,
                                        device=self._device):
            auc, ap = _auc_ap(z, te_pos, te_neg)
            if self._verbose:
                print(
                    f"hops:{hop:2d} roc_auc_score: {auc:.4f} "
                    f"avg_precision: {ap:.4f} time: {time.perf_counter() - t:.4f} seconds"
                )
            if auc > best_auc:
                best_auc, best_hop_auc = auc, hop
            if ap > best_ap:
                best_ap, best_hop_ap = ap, hop
            t = time.perf_counter()
        if self._verbose:
            print(f"best_roc_auc_score: {best_auc:.4f}, best_avg_precision: {best_ap:.4f}")
        return best_hop_auc, best_hop_ap, best_auc, best_ap
