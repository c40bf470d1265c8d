"""Clustering metrics — counterpart of ``sgl_tpu/tasks/clustering_metrics.py``.

Accuracy matches clusters to labels by the Hungarian method
(``scipy.optimize.linear_sum_assignment``); the F1 / precision / recall
scores, NMI (arithmetic mean of the entropies, scikit-learn's default) and
ARI are computed here in numpy from the contingency table, with
scikit-learn's definitions and special cases.

``plotClusters`` runs the port's own t-SNE (:class:`~sgl_tpu_torch.tasks.
tsne.TSNE`, in torch on the device) where ``sgl_tpu`` runs scikit-learn's,
and draws on the port's own raster figure
(:class:`~sgl_tpu_torch.utils.figure.Figure`, a PNG written with ``zlib``)
where ``sgl_tpu`` draws with matplotlib; ``plot`` draws on either.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from sgl_tpu_torch.tasks.tsne import TSNE
from sgl_tpu_torch.utils.figure import Figure

# the colours of sgl_tpu's plotClusters, label i drawn in colour i
PLOT_COLORS = ("red", "green", "blue", "brown", "purple", "yellow", "pink", "orange")


def _contingency(a: np.ndarray, b: np.ndarray):
    """Row labels, column labels and the int64 table of co-occurrences."""
    la, ia = np.unique(a, return_inverse=True)
    lb, ib = np.unique(b, return_inverse=True)
    table = np.zeros((la.size, lb.size), np.int64)
    np.add.at(table, (ia.reshape(-1), ib.reshape(-1)), 1)
    return la, lb, table


def _entropy(counts: np.ndarray) -> float:
    if counts.size <= 1:
        return 0.0
    p = counts.astype(np.float64)
    total = p.sum()
    return float(-np.sum((p / total) * (np.log(p) - math.log(total))))


def normalized_mutual_info(labels_true, labels_pred) -> float:
    """NMI with the arithmetic mean of the two entropies (scikit-learn's
    ``normalized_mutual_info_score`` default)."""
    _, _, table = _contingency(np.asarray(labels_true), np.asarray(labels_pred))
    if table.shape[0] == table.shape[1] == 1 or table.size == 0:
        return 1.0
    pi, pj = table.sum(axis=1), table.sum(axis=0)
    if pi.size == 1 or pj.size == 1:
        return 0.0
    nzx, nzy = np.nonzero(table)
    nz = table[nzx, nzy].astype(np.float64)
    total = nz.sum()
    outer = pi[nzx].astype(np.int64) * pj[nzy].astype(np.int64)
    log_outer = -np.log(outer) + math.log(pi.sum()) + math.log(pj.sum())
    p = nz / total
    mi = p * (np.log(nz) - math.log(total)) + p * log_outer
    mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
    mi = float(np.clip(mi.sum(), 0.0, None))
    if mi == 0:
        return 0.0
    normalizer = (_entropy(pi) + _entropy(pj)) / 2
    return float(mi / normalizer)


def adjusted_rand(labels_true, labels_pred) -> float:
    """The adjusted Rand index from the pair confusion matrix, as
    scikit-learn's ``adjusted_rand_score``."""
    _, _, table = _contingency(np.asarray(labels_true), np.asarray(labels_pred))
    n = int(table.sum())
    n_c, n_k = table.sum(axis=1), table.sum(axis=0)
    sum_squares = int((table.astype(np.int64) ** 2).sum())
    tp = sum_squares - n
    fp = int((table @ n_k).sum()) - sum_squares
    fn = int((table.T @ n_c).sum()) - sum_squares
    tn = n * n - fp - fn - sum_squares
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))


def _prf(labels_true: np.ndarray, labels_pred: np.ndarray):
    """Macro and micro precision, recall and F1 over the labels of both
    vectors; a ratio with a zero denominator counts as 0."""
    labels = np.unique(np.concatenate([labels_true, labels_pred]))
    t = np.searchsorted(labels, labels_true)
    p = np.searchsorted(labels, labels_pred)
    k = labels.size
    tp = np.bincount(t[t == p], minlength=k).astype(np.float64)
    pred_n = np.bincount(p, minlength=k).astype(np.float64)
    true_n = np.bincount(t, minlength=k).astype(np.float64)

    def ratio(a, b):
        return np.divide(a, b, out=np.zeros_like(a), where=b > 0)

    precision, recall = ratio(tp, pred_n), ratio(tp, true_n)
    f1 = ratio(2 * tp, pred_n + true_n)
    micro_p = tp.sum() / pred_n.sum() if pred_n.sum() else 0.0
    micro_r = tp.sum() / true_n.sum() if true_n.sum() else 0.0
    micro_f1 = 2 * tp.sum() / (pred_n.sum() + true_n.sum()) if (pred_n.sum() + true_n.sum()) else 0.0
    return (float(f1.mean()), float(precision.mean()), float(recall.mean()),
            float(micro_f1), float(micro_p), float(micro_r))


class clustering_metrics:  # noqa: N801 — the reference's name
    def __init__(self, true_label, predict_label):
        self.true_label = np.asarray(true_label)
        self.pred_label = np.asarray(predict_label)

    def clusteringAcc(self):  # noqa: N802
        """Accuracy, macro F1 / precision / recall and micro F1 / precision
        / recall after the best one-to-one matching of clusters to labels;
        all zeros when the two have different numbers of distinct values."""
        l1, l2, cost = _contingency(self.true_label, self.pred_label)
        if len(l1) != len(l2):
            return 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0
        row, col = linear_sum_assignment(-cost)
        new_predict = np.zeros_like(self.pred_label)
        for i, j in zip(row, col):
            new_predict[self.pred_label == l2[j]] = l1[i]
        acc = float(np.mean(self.true_label == new_predict))
        f1_macro, p_macro, r_macro, f1_micro, p_micro, r_micro = _prf(self.true_label, new_predict)
        return acc, f1_macro, p_macro, r_macro, f1_micro, p_micro, r_micro

    def evaluationClusterModelFromLabel(self):  # noqa: N802
        """(accuracy, NMI, ARI)."""
        nmi = normalized_mutual_info(self.true_label, self.pred_label)
        ari = adjusted_rand(self.true_label, self.pred_label)
        return self.clusteringAcc()[0], nmi, ari

    @staticmethod
    def plot(X, fig, col, size, true_labels):
        """Scatter the 2-D points ``X`` on a new subplot of ``fig``, the
        points of label i in colour ``col[i]`` at size ``size``; labels past
        ``len(col) - 1`` are not drawn.  ``fig`` is the port's
        :class:`~sgl_tpu_torch.utils.figure.Figure` or a matplotlib figure;
        ``X`` and ``true_labels`` may be tensors on the card."""
        ax = fig.add_subplot(1, 1, 1)
        X = X.detach().cpu().numpy() if torch.is_tensor(X) else np.asarray(X)
        true_labels = true_labels.cpu().numpy() if torch.is_tensor(true_labels) else np.asarray(true_labels)
        for i, c in enumerate(col[: int(true_labels.max()) + 1]):
            pts = X[true_labels == i]
            ax.scatter(pts[:, 0], pts[:, 1], lw=0, s=size, c=c)

    def plotClusters(self, hidden_emb, true_labels, path="plot.png", device=None):  # noqa: N802
        """The t-SNE of ``hidden_emb`` on ``device`` (default: the GPU),
        scattered by true label in eight colours at size 40, the axis off,
        saved to ``path`` as a PNG at 120 dpi; returns ``path``.  The t-SNE
        run is kept as ``tsne_``."""
        n = len(hidden_emb)
        self.tsne_ = TSNE(n_components=2, perplexity=min(30.0, max(2.0, n / 4)), device=device)
        x_tsne = self.tsne_.fit_transform(hidden_emb)
        fig = Figure()
        self.plot(x_tsne, fig, PLOT_COLORS, 40, true_labels)
        fig.gca().axis("off")
        fig.savefig(path, dpi=120)
        return path
