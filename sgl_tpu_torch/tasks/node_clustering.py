"""Node clustering tasks — counterpart of ``sgl_tpu/tasks/node_clustering.py``.

``NodeClustering``: KMeans on the model's embeddings every epoch, and the
cluster loss driving a gradient step of the net.  ``NodeClusteringNAFS``:
training-free NAFS smoothing (hop weights by cosine similarity to the
features, softmaxed over hops, for each normalization exponent r of an
ensemble) and KMeans on each hop's features.

:class:`KMeans` is the port's own, in torch on the features' device
(``sgl_tpu`` hands its features to scikit-learn): k-means++ seeding from an
explicit ``torch.Generator``, Lloyd iterations, ``n_init`` restarts with the
lowest inertia kept.  Given the same initial centers it gives
scikit-learn's labels; its random seeding differs from scikit-learn's by
design.

The NAFS propagation runs the CSR kernel once per r on the card
(:func:`~sgl_tpu_torch.kernels.sparse.spmm_multi`), as ``sgl_tpu`` runs its
Pallas kernel once per r on the TPU, and the one-gather multi-weight form
on the CPU.  The hop softmax is taken online: ``exp(cos)`` is bounded
(``cos`` in [-1, 1]), so a running numerator and denominator give the exact
softmax without keeping every hop.
"""

from __future__ import annotations

import math
import time
import weakref
from typing import Optional, Sequence

import numpy as np
import torch

from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.graph.normalize import symmetric_normalized_weights
from sgl_tpu_torch.kernels.sparse import add_rows_, spmm, spmm_multi
from sgl_tpu_torch.kernels.spmm_csr import prepare_csr
from sgl_tpu_torch.tasks.base_task import BaseTask
from sgl_tpu_torch.tasks.clustering_metrics import clustering_metrics
from sgl_tpu_torch.tasks.node_classification import _sync
from sgl_tpu_torch.tasks.utils import adam_l2, set_seed

NAFS_R_LIST = (0.5, 0.4, 0.3, 0.2, 0.1, 0.0)
NAFS_METHODS = ("mean", "max", "concat", "simple")


# -- KMeans -------------------------------------------------------------------


def _sq_dist(x: torch.Tensor, x_sq: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances ``[len(x), len(c)]`` by ``|x|² - 2 x·c + |c|²``,
    clipped at 0."""
    return (x_sq[:, None] - 2.0 * (x @ c.T) + (c * c).sum(1)[None, :]).clamp_(min=0.0)


class KMeans:
    """Lloyd's k-means with k-means++ seeding, in torch on the device of
    the data it is fitted to.

    Follows scikit-learn's ``KMeans(algorithm="lloyd")``: the data are
    centered first; the seeding is greedy k-means++ with
    ``2 + ln(n_clusters)`` candidates a center; each iteration labels every
    point by the nearest center (``|c|² - 2 x·c``) and moves each center to
    its points' mean (an empty cluster takes the point farthest from its
    center); it stops when no label changes or when the centers' total
    squared shift is at most ``tol`` times the mean feature variance, or
    after ``max_iter`` iterations, then labels once more by the final
    centers unless no label changed.  ``n_init`` seedings, the lowest
    inertia kept.  The seeding draws from ``generator``, or from a
    generator on the data's device seeded with ``random_state``.
    """

    def __init__(
        self,
        n_clusters: int,
        n_init: int = 10,
        max_iter: int = 300,
        tol: float = 1e-4,
        random_state: int = 0,
        generator: Optional[torch.Generator] = None,
    ):
        self.n_clusters = n_clusters
        self.n_init = n_init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self.generator = generator
        self.labels_: Optional[torch.Tensor] = None
        self.cluster_centers_: Optional[torch.Tensor] = None
        self.inertia_: Optional[float] = None
        self.n_iter_: int = 0

    def fit(self, x, init: Optional[torch.Tensor] = None) -> "KMeans":
        """Cluster the rows of ``x``; ``init`` (``[n_clusters, D]``) gives
        the initial centers and then makes one run, without seeding."""
        x = torch.as_tensor(x)
        if not torch.is_floating_point(x):
            x = x.float()
        mean = x.mean(0)
        x = x - mean
        x_sq = (x * x).sum(1)
        tol = float(x.var(0, correction=0).mean()) * self.tol
        if init is not None:
            runs = [torch.as_tensor(init, dtype=x.dtype, device=x.device) - mean]
        else:
            gen = self.generator or torch.Generator(device=x.device).manual_seed(self.random_state)
            runs = (self._seed(x, x_sq, gen) for _ in range(self.n_init))
        best = None
        for centers in runs:
            labels, centers, inertia, n_iter = self._lloyd(x, x_sq, centers, tol)
            if best is None or inertia < best[2]:
                best = (labels, centers, inertia, n_iter)
        self.labels_, centers, self.inertia_, self.n_iter_ = best
        self.cluster_centers_ = centers + mean
        return self

    def fit_predict(self, x) -> torch.Tensor:
        return self.fit(x).labels_

    def _seed(self, x, x_sq, gen) -> torch.Tensor:
        """Greedy k-means++: each new center the best of a few candidates
        drawn with probability proportional to the squared distance to the
        centers so far."""
        n, k = x.shape[0], self.n_clusters
        trials = 2 + int(math.log(k))
        centers = torch.empty((k, x.shape[1]), dtype=x.dtype, device=x.device)
        first = torch.randint(n, (1,), generator=gen, device=x.device)
        centers[0] = x[first[0]]
        closest = _sq_dist(x, x_sq, centers[:1])[:, 0]
        pot = closest.sum()
        for c in range(1, k):
            r = torch.rand(trials, generator=gen, device=x.device, dtype=torch.float64) * pot
            ids = torch.searchsorted(closest.double().cumsum(0), r).clamp_(max=n - 1)
            dist = torch.minimum(closest[None, :], _sq_dist(x, x_sq, x[ids]).T)
            pots = dist.sum(1)
            best = pots.argmin()
            pot, closest = pots[best], dist[best]
            centers[c] = x[ids[best]]
        return centers

    def _update(self, x, labels, centers):
        """The points' means per cluster; an empty cluster takes the point
        farthest from its center, which leaves its old cluster."""
        k = self.n_clusters
        sums = add_rows_(torch.zeros_like(centers), labels, x)
        counts = torch.bincount(labels, minlength=k).to(x.dtype)
        empty = torch.nonzero(counts == 0).flatten().tolist()
        if empty:
            far = ((x - centers[labels]) ** 2).sum(1).topk(len(empty)).indices.tolist()
            for cluster, point in zip(empty, far):
                old = int(labels[point])
                sums[old] -= x[point]
                counts[old] -= 1
                sums[cluster] = x[point]
                counts[cluster] = 1
        return sums / counts.clamp(min=1)[:, None]

    def _lloyd(self, x, x_sq, centers, tol):
        c_sq = (centers * centers).sum(1)
        labels_old = None
        strict = False
        n_iter = 0
        for n_iter in range(1, self.max_iter + 1):
            labels = (c_sq[None, :] - 2.0 * (x @ centers.T)).argmin(1)
            new = self._update(x, labels, centers)
            shift = float(((new - centers) ** 2).sum())
            centers, c_sq = new, (new * new).sum(1)
            if labels_old is not None and torch.equal(labels, labels_old):
                strict = True
                break
            if shift <= tol:
                break
            labels_old = labels
        if not strict:
            labels = (c_sq[None, :] - 2.0 * (x @ centers.T)).argmin(1)
        inertia = float(((x - centers[labels]) ** 2).sum())
        return labels, centers, inertia, n_iter


# -- the cluster loss and the trained task ----------------------------------


def cluster_loss(train_output, y_pred, cluster_centers) -> torch.Tensor:
    """Pull each embedding toward its assigned center and push it from the
    mean distance to all centers (the reference's ``tasks/utils.py``)."""
    dist = torch.cdist(train_output, cluster_centers, compute_mode="donot_use_mm_for_euclid_dist")
    picked = dist.gather(1, y_pred.long()[:, None]).squeeze(1)
    loss = -dist.mean(dim=1).sum() + 2.0 * picked.sum()
    return loss / dist.shape[0]


class NodeClustering(BaseTask):
    def __init__(
        self,
        dataset,
        model,
        lr: float,
        weight_decay: float,
        epochs: int,
        device=None,
        loss_fn=cluster_loss,
        seed: int = 42,
        train_batch_size=None,
        eval_batch_size=None,
        n_init: int = 20,
        verbose: bool = True,
    ):
        super().__init__()
        if train_batch_size is not None or eval_batch_size is not None:
            raise ValueError("clustering task does not support batch training")
        self._dataset = dataset
        self._model = model
        self._device = resolve_device(device)
        self._lr = lr
        self._weight_decay = weight_decay
        self._epochs = epochs
        self._loss_fn = loss_fn
        self._seed = seed
        self._n_clusters = dataset.num_classes
        self._n_init = n_init
        self._verbose = verbose
        self._acc, self._nmi, self._adjscore = self._execute()

    acc = property(lambda self: self._acc)
    nmi = property(lambda self: self._nmi)
    adjscore = property(lambda self: self._adjscore)

    def _execute(self):
        ds, model, device = self._dataset, self._model, self._device
        init_gen = set_seed(self._seed)
        dropout_gen = torch.Generator(device=device).manual_seed(self._seed)
        kmeans_gen = torch.Generator(device=device).manual_seed(self._seed)
        t0 = time.perf_counter()
        model.preprocess(ds.graph, ds.x, device=device)
        if self._verbose:
            print(f"Preprocessing done in {time.perf_counter() - t0:.4f}s")

        labels = np.asarray(ds.y).reshape(-1)
        feats = model.batch_input(torch.arange(ds.num_node, device=device))
        net = model.net.cpu()
        model.init(init_gen)
        net.to(device)
        params = list(net.parameters())
        optimizer = adam_l2(params, self._lr, self._weight_decay) if params else None

        def embed():
            with torch.no_grad():
                return net(feats, train=False)

        def kmeans(x):
            km = KMeans(self._n_clusters, n_init=self._n_init, generator=kmeans_gen).fit(x)
            return km.labels_, km.cluster_centers_

        best = [0.0, 0.0, 0.0]
        for epoch in range(self._epochs):
            t = time.perf_counter()
            y_pred, centers = kmeans(embed())
            if optimizer is not None:
                optimizer.zero_grad(set_to_none=True)
                loss = self._loss_fn(net(feats, train=True, generator=dropout_gen), y_pred, centers)
                loss.backward()
                optimizer.step()
            else:
                loss = self._loss_fn(embed(), y_pred, centers)
            acc, nmi, ari = clustering_metrics(labels, y_pred.cpu().numpy()).evaluationClusterModelFromLabel()
            if self._verbose:
                print(
                    f"Epoch: {epoch + 1:03d} loss_train: {float(loss.detach()):.4f} acc: {acc:.4f} "
                    f"nmi: {nmi:.4f} adjscore: {ari:.4f} time: {time.perf_counter() - t:.4f}s"
                )
            best = [max(b, v) for b, v in zip(best, (acc, nmi, ari))]

        # cluster the final (optionally post-propagated) embeddings
        final = model.postprocess(ds.graph, embed())
        y_pred, _ = kmeans(final)
        scores = clustering_metrics(labels, y_pred.cpu().numpy()).evaluationClusterModelFromLabel()
        best = [max(b, v) for b, v in zip(best, scores)]
        if self._verbose:
            print(f"Best acc: {best[0]:.4f}, best_nmi: {best[1]:.4f}, best_adjscore: {best[2]:.4f}")
        self.net = net
        return tuple(best)


# -- NAFS ---------------------------------------------------------------------


def _nafs_weight_of(xref, h: torch.Tensor) -> torch.Tensor:
    """``exp(cos(x, h))`` per r and node: the unnormalized hop weight."""
    x0, ref_norm = xref
    norms = torch.linalg.vector_norm(h, dim=-1) + 1e-10  # (R, N)
    cos = torch.einsum("nd,rnd->rn", x0, h) / (norms * ref_norm[None])
    return torch.exp(cos)


# the last few (weakref(graph), r values, device, adjacencies): a sweep and
# repeated calls on one graph normalize and lay it out once
_MACHINE_CACHE: list = []
_MACHINE_CACHE_SIZE = 4


def _nafs_adjs(graph, r_list: Sequence[float], device: torch.device) -> list:
    """One adjacency per r: a CSR with its plan on the card, the
    :class:`~sgl_tpu_torch.kernels.sparse.SparseAdj` (one edge order for
    every r) on the CPU."""
    key = tuple(float(r) for r in r_list)
    for ref, cached_key, cached_device, adjs in _MACHINE_CACHE:
        if ref() is graph and cached_key == key and cached_device == device:
            return adjs
    adjs = [_layout(graph, r, device) for r in key]
    _MACHINE_CACHE.append((weakref.ref(graph), key, device, adjs))
    del _MACHINE_CACHE[:-_MACHINE_CACHE_SIZE]
    return adjs


def _layout(graph, r: float, device: torch.device):
    """The graph normalized with exponent ``r``: on the card as a CSR with
    its plan, which the caller keeps; on the CPU as the edge list."""
    adj = symmetric_normalized_weights(graph, r=r, device=device)
    return adj if device.type == "cpu" else prepare_csr(adj)


def _nafs_machine(graph, x, r_list: Sequence[float], device):
    """The adjacencies, the reference ``(x, |x|)`` and the carry
    ``(h, num, den)`` at hop 0: every r starts from ``x``, with weight
    ``exp(1)``."""
    device = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()
    adjs = _nafs_adjs(graph, r_list, device)
    xref = (x, torch.linalg.vector_norm(x, dim=1) + 1e-10)
    h0 = x.expand(len(adjs), *x.shape)
    e0 = _nafs_weight_of(xref, h0)
    return adjs, xref, (h0, e0[..., None] * h0, e0)


def _nafs_step(adjs, xref, carry):
    """One hop for every r: ``h ← A_r h``, then the online softmax's sums."""
    h, num, den = carry
    h = spmm_multi(adjs, h)
    e = _nafs_weight_of(xref, h)
    return h, num + e[..., None] * h, den + e


def _nafs_ensemble(stack: torch.Tensor, method: str) -> torch.Tensor:
    """Combine the per-r features ``(R, N, D)``."""
    if method == "mean":
        return stack.mean(dim=0)
    if method == "max":
        return stack.max(dim=0).values
    if method == "concat":
        return stack.movedim(0, 1).reshape(stack.shape[1], -1)
    raise ValueError("Method not Suppoted! Choose 'mean', 'max' or 'concat' !")


def _nafs_out(carry, method: str) -> torch.Tensor:
    _, num, den = carry
    return _nafs_ensemble(num / den[..., None], method)


@torch.no_grad()
def nafs_smooth_features(graph, x, hops: int, r_list: Sequence[float], method: str,
                         device=None) -> torch.Tensor:
    """NAFS smoothing with an r-ensemble, on ``device`` (default: the GPU).

    For each r: propagate ``hops`` steps and weight the hops of each node
    by the softmax of their cosine similarity to ``x``; then combine the r
    by mean, max or concat.  ``"simple"`` is the last hop of the first r,
    unweighted.
    """
    device = resolve_device(device)
    if method == "simple":
        adj = _layout(graph, r_list[0], device)
        h = torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()
        for _ in range(hops):
            h = spmm(adj, h)
        return h
    adjs, xref, carry = _nafs_machine(graph, x, r_list, device)
    for _ in range(hops):
        carry = _nafs_step(adjs, xref, carry)
    return _nafs_out(carry, method)


def nafs_smooth_sweep(graph, x, hops, r_list: Sequence[float], method: str, device=None):
    """Yield ``(hop, features)`` for every hop count in ``hops``, in
    increasing order, sharing the propagation: hop ``h + 1``'s sums extend
    hop ``h``'s, so the sweep costs ``max(hops)`` products per r, not
    ``sum(hops)``."""
    device = resolve_device(device)
    hops = sorted({int(h) for h in hops})
    cur = 0
    with torch.no_grad():
        if method == "simple":
            adj = _layout(graph, r_list[0], device)
            h = torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()
            for target in hops:
                while cur < target:
                    h = spmm(adj, h)
                    cur += 1
                yield target, h
            return
        adjs, xref, carry = _nafs_machine(graph, x, r_list, device)
        for target in hops:
            while cur < target:
                carry = _nafs_step(adjs, xref, carry)
                cur += 1
            yield target, _nafs_out(carry, method)


def _check_method(method: str) -> str:
    method = method.lower()
    if method not in NAFS_METHODS:
        raise ValueError("Method not Suppoted! Choose 'mean', 'max' or 'concat' !")
    return method


class NodeClusteringNAFS(BaseTask):
    """Training-free NAFS clustering: KMeans on every hop of the sweep."""

    def __init__(
        self,
        dataset,
        hops=20,
        method: str = "mean",
        seed: int = 42,
        n_init: int = 20,
        r_list: Sequence[float] = NAFS_R_LIST,
        verbose: bool = True,
        device=None,
    ):
        super().__init__()
        self._dataset = dataset
        self._method = _check_method(method)
        self._r_list = list(r_list)
        self._hops = range(hops) if isinstance(hops, int) else hops
        self._seed = seed
        self._n_clusters = dataset.num_classes
        self._n_init = n_init
        self._verbose = verbose
        self._device = resolve_device(device)
        #: wall seconds of each hop's KMeans (device work included)
        self.kmeans_seconds = []
        (
            self._best_hop_acc,
            self._best_hop_nmi,
            self._best_hop_adjscore,
            self._acc,
            self._nmi,
            self._adjscore,
        ) = self._execute()

    acc = property(lambda self: self._acc)
    nmi = property(lambda self: self._nmi)
    adjscore = property(lambda self: self._adjscore)
    best_hop_acc = property(lambda self: self._best_hop_acc)
    best_hop_nmi = property(lambda self: self._best_hop_nmi)
    best_hop_adjscore = property(lambda self: self._best_hop_adjscore)

    def _execute(self):
        set_seed(self._seed)
        ds, device = self._dataset, self._device
        labels = np.asarray(ds.y).reshape(-1)
        best = {"acc": (0, 0.0), "nmi": (0, 0.0), "ari": (0, 0.0)}
        t = time.perf_counter()
        for hop, feats in nafs_smooth_sweep(ds.graph, ds.x, self._hops, self._r_list, self._method,
                                            device=device):
            _sync(device)
            t_km = time.perf_counter()
            km = KMeans(self._n_clusters, n_init=self._n_init, random_state=self._seed)
            y_pred = km.fit_predict(feats).cpu().numpy()
            self.kmeans_seconds.append(time.perf_counter() - t_km)
            acc, nmi, ari = clustering_metrics(labels, y_pred).evaluationClusterModelFromLabel()
            if self._verbose:
                print(
                    f"hops:{hop:2d} acc: {acc:.4f} nmi: {nmi:.4f} "
                    f"adjscore: {ari:.4f} time: {time.perf_counter() - t:.4f} seconds"
                )
            for key, v in zip(("acc", "nmi", "ari"), (acc, nmi, ari)):
                if v > best[key][1]:
                    best[key] = (hop, v)
            t = time.perf_counter()
        return (
            best["acc"][0], best["nmi"][0], best["ari"][0],
            best["acc"][1], best["nmi"][1], best["ari"][1],
        )
