"""t-SNE in torch on an explicit device: the port's own counterpart of
``sklearn.manifold.TSNE`` as ``sgl_tpu``'s ``clustering_metrics.plotClusters``
calls it (``TSNE(n_components=2, perplexity=min(30, max(2, N/4)))`` at
scikit-learn's defaults: early exaggeration 12 for 250 iterations,
learning rate ``max(N/12/4, 50)``, 1,000 iterations, PCA initialization).

The parts are plain functions on tensors, each the counterpart of a step of
scikit-learn's Barnes-Hut path (``sklearn/manifold/_t_sne.py``):

* :func:`knn_sq_distances`: the squared euclidean distances to the k
  nearest other points, ``k = min(N-1, int(3·perplexity + 1))``, in float64
  by blocks of rows (no N×N matrix is held);
* :func:`conditional_p`: the binary search for each row's precision of
  ``_utils.pyx::_binary_search_perplexity`` (float64, 100 steps, tolerance
  1e-5 on the entropy), vectorized over rows, each row frozen where it
  converges;
* :func:`joint_p`: ``P = (P + Pᵀ) / sum`` as a CSR (:class:`JointP`), never
  dense;
* :func:`pca_init`: the two leading principal components with
  scikit-learn's sign rule, scaled to a first-column std of 1e-4;
* :func:`kl_grad`: the KL divergence and its gradient.  The attractive term
  runs over P's nonzeros; the repulsive term and its normalizer Z are
  summed exactly over all pairs, by blocks of rows: Barnes-Hut at
  ``angle=0``, where scikit-learn approximates at ``angle=0.5`` with its CPU
  quadtree.  The exact sum costs O(N²) an iteration;
* :func:`gradient_descent`: ``_gradient_descent`` step for step (gains,
  momentum, the progress check every 50 iterations).

:func:`trustworthiness` is scikit-learn's ``manifold.trustworthiness``,
optionally over a sample of rows.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from sgl_tpu_torch.device import resolve_device

MACHINE_EPSILON = float(np.finfo(np.float64).eps)
FLOAT32_TINY = float(np.finfo(np.float32).tiny)
# _utils.pyx declares both as C floats
EPSILON_DBL = float(np.float32(1e-8))
PERPLEXITY_TOLERANCE = float(np.float32(1e-5))
N_STEPS = 100
# scikit-learn's TSNE defaults and schedule
EARLY_EXAGGERATION = 12.0
EXPLORATION_MAX_ITER = 250
MAX_ITER = 1000
N_ITER_WITHOUT_PROGRESS = 300
MIN_GRAD_NORM = 1e-7
N_ITER_CHECK = 50
# elements of one block of rows × all points in the pairwise passes
BLOCK_ELEMENTS = 1 << 25


def _block_rows(n: int, block: Optional[int]) -> int:
    return block or max(1, BLOCK_ELEMENTS // max(n, 1))


def _sq_dist64(xb: torch.Tensor, x: torch.Tensor, sq_b: torch.Tensor, sq: torch.Tensor) -> torch.Tensor:
    """``|xb_i - x_j|²`` in float64 by ``|xb|² + |x|² - 2 xb·x``, clipped at 0."""
    return torch.addmm(sq[None, :], xb, x.T, alpha=-2.0).add_(sq_b[:, None]).clamp_(min=0.0)


def knn_sq_distances(x: torch.Tensor, k: int):
    """The squared euclidean distances (float32) and indices (int64) of the
    ``k`` nearest other points of each row of ``x``, nearest first; a point
    is never its own neighbour.  As scikit-learn's
    ``kneighbors_graph(mode="distance")`` squared, summed in float64 by
    blocks of rows."""
    x64 = x.to(torch.float64)
    n = x64.shape[0]
    sq = (x64 * x64).sum(1)
    dist = torch.empty((n, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((n, k), dtype=torch.int64, device=x.device)
    step = _block_rows(n, None)
    for a in range(0, n, step):
        b = min(n, a + step)
        d = _sq_dist64(x64[a:b], x64, sq[a:b], sq)
        d[torch.arange(b - a, device=x.device), torch.arange(a, b, device=x.device)] = math.inf
        vals, ids = torch.topk(d, k, dim=1, largest=False, sorted=True)
        dist[a:b], idx[a:b] = vals.to(torch.float32), ids
    return dist, idx


def conditional_p(dist: torch.Tensor, perplexity: float) -> torch.Tensor:
    """``p_{j|i}`` over each row's neighbours (float64), the precision of
    each row found by binary search to the entropy ``log(perplexity)``.

    Scikit-learn's loop over rows, run on all rows at once: each row keeps
    its own bounds and stops at its own step (a converged row is masked
    out), so every row ends at the precision scikit-learn's ends at."""
    d = dist.to(torch.float64)
    n = d.shape[0]
    desired = math.log(float(np.float32(perplexity)))
    beta = torch.ones(n, dtype=torch.float64, device=d.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    active = torch.ones(n, dtype=torch.bool, device=d.device)
    out = torch.zeros_like(d)
    for _ in range(N_STEPS):
        p = torch.exp(-d * beta[:, None])
        s = p.sum(1)
        s = torch.where(s == 0.0, torch.full_like(s, EPSILON_DBL), s)
        p /= s[:, None]
        entropy_diff = torch.log(s) + beta * (d * p).sum(1) - desired
        out = torch.where(active[:, None], p, out)
        active = active & (entropy_diff.abs() > PERPLEXITY_TOLERANCE)
        up = active & (entropy_diff > 0.0)
        down = active & (entropy_diff <= 0.0)
        beta_up = torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0)
        beta_down = torch.where(torch.isinf(lo), beta / 2.0, (beta + lo) / 2.0)
        lo = torch.where(up, beta, lo)
        hi = torch.where(down, beta, hi)
        beta = torch.where(up, beta_up, torch.where(down, beta_down, beta))
        if not bool(active.any()):
            break
    return out


@dataclasses.dataclass(frozen=True)
class JointP:
    """The joint probabilities as a CSR on the device: ``rowptr`` [N+1],
    ``col`` and ``val`` (float64) [nnz], with ``row`` (each entry's row)."""

    rowptr: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    row: torch.Tensor
    num_nodes: int

    def scaled(self, factor: float) -> "JointP":
        """``factor · P`` (the early exaggeration)."""
        return dataclasses.replace(self, val=self.val * factor)


def joint_p(cond: torch.Tensor, idx: torch.Tensor) -> JointP:
    """``P = (C + Cᵀ) / max(sum, eps)`` from the conditional probabilities
    ``cond`` [N, k] of the neighbours ``idx`` [N, k], as
    ``_joint_probabilities_nn``: entries that sum to 0 are not stored."""
    n, k = cond.shape
    rows = torch.arange(n, device=cond.device).repeat_interleave(k)
    cols = idx.reshape(-1)
    vals = cond.reshape(-1)
    keys = torch.cat([rows * n + cols, cols * n + rows])
    keys, inverse = torch.unique(keys, return_inverse=True)
    # at most two values meet in one entry, and a + b == b + a: the sums
    # are the same in any order
    summed = torch.zeros(keys.shape[0], dtype=torch.float64, device=cond.device).index_add_(
        0, inverse, torch.cat([vals, vals]))
    keep = summed != 0.0
    keys, summed = keys[keep], summed[keep]
    summed /= torch.clamp(summed.sum(), min=MACHINE_EPSILON)
    row, col = keys // n, keys % n
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device=cond.device)
    rowptr[1:] = torch.cumsum(torch.bincount(row, minlength=n), 0)
    return JointP(rowptr, col, summed, row, n)


def pca_init(x: torch.Tensor, n_components: int = 2) -> torch.Tensor:
    """The leading principal components of ``x`` (float32), each
    component's largest loading made positive (scikit-learn's ``svd_flip``
    on the rows of ``Vt``), divided by the population std of the first
    column and multiplied by 1e-4.  Computed in float64: from the
    covariance's eigenvectors when there are at least as many rows as
    features, else from the SVD."""
    x64 = x.to(torch.float64)
    n, d = x64.shape
    xc = x64 - x64.mean(0)
    if d <= n:
        _, vecs = torch.linalg.eigh(xc.T @ xc / max(n - 1, 1))
        vt = vecs[:, -n_components:].flip(1).T
    else:
        vt = torch.linalg.svd(xc, full_matrices=False).Vh[:n_components]
    lead = vt.abs().argmax(1)
    vt = vt * torch.sign(vt[torch.arange(vt.shape[0], device=x.device), lead])[:, None]
    y = (xc @ vt.T).to(torch.float32)
    return y / y[:, 0].to(torch.float64).std(correction=0).to(torch.float32) * 1e-4


def kl_grad(y: torch.Tensor, P: JointP, dof: int = 1, compute_error: bool = True, block: Optional[int] = None):
    """``(KL(P || Q), dKL/dy)`` of the embedding ``y`` [N, c] under the
    Student-t kernel with ``dof`` degrees of freedom.

    The gradient is ``c · (Σ_j p_ij w_ij (y_i - y_j) - Σ_j w_ij² (y_i - y_j) / Z)``
    with ``w = (dof / (dof + d²))^((dof+1)/2)``, ``Z = Σ_{i≠j} w_ij`` and
    ``c = 2(dof+1)/dof``.  The first sum runs over P's nonzeros, the second
    and Z over all pairs, by blocks of ``block`` rows (Z in float64).  The
    KL is ``Σ p log(max(p, tiny) / max(w/Z, tiny))`` over P's nonzeros, a
    0-d float64 tensor, or None without ``compute_error``."""
    n, c = y.shape
    exponent = (dof + 1.0) / 2.0

    def kernel(sq: torch.Tensor) -> torch.Tensor:
        """``w`` from the squared distances, in place."""
        if dof == 1:
            return sq.add_(1.0).reciprocal_()
        return sq.div_(dof).add_(1.0).reciprocal_().pow_(exponent)

    p = P.val.to(y.dtype)
    diff = y[P.row] - y[P.col]
    w_nz = kernel((diff * diff).sum(1))
    # P's entries lie in row order: a segment sum (deterministic, no atomics)
    attract = torch.segment_reduce((p * w_nz)[:, None] * diff, "sum", offsets=P.rowptr, axis=0)

    repel = torch.empty_like(y)
    z = torch.zeros((), dtype=torch.float64, device=y.device)
    step = _block_rows(n, block)
    for a in range(0, n, step):
        yb = y[a:a + step]
        b = yb.shape[0]
        diffs = [yb[:, k:k + 1] - y[None, :, k] for k in range(c)]
        sq = diffs[0] * diffs[0]
        for dk in diffs[1:]:
            sq.addcmul_(dk, dk)
        w = kernel(sq)
        w[torch.arange(b, device=y.device), torch.arange(a, a + b, device=y.device)] = 0.0
        z += w.sum(dtype=torch.float64)
        w.mul_(w)
        # row-wise dot products (a batched matmul): no [b, N] product is kept
        repel[a:a + b] = torch.stack([torch.einsum("ij,ij->i", w, dk) for dk in diffs], 1)
    grad = (attract - repel / z.to(y.dtype)) * (2.0 * (dof + 1.0) / dof)
    if not compute_error:
        return None, grad
    q = (w_nz.to(torch.float64) / z).clamp(min=FLOAT32_TINY)
    kl = (P.val * torch.log(P.val.clamp(min=FLOAT32_TINY) / q)).sum()
    return kl, grad


def gradient_descent(
    objective: Callable,
    p0: torch.Tensor,
    it: int,
    max_iter: int,
    n_iter_check: int = 1,
    n_iter_without_progress: int = 300,
    momentum: float = 0.8,
    learning_rate: float = 200.0,
    min_gain: float = 0.01,
    min_grad_norm: float = 1e-7,
):
    """Gradient descent with momentum and per-parameter gains, as
    scikit-learn's ``_gradient_descent``: ``objective(p, compute_error)``
    gives ``(error or None, grad)``; a gain grows by 0.2 where the step
    turns and shrinks ×0.8 where it does not (at least ``min_gain``); every
    ``n_iter_check`` iterations the error and the gradient's norm are read,
    and the descent stops after ``n_iter_without_progress`` iterations
    without a lower error, or at a norm of at most ``min_grad_norm``.
    Returns ``(p, error, last iteration)``.  The parameters stay in their
    dtype, the update is float64, as scikit-learn's."""
    p = p0.clone()
    update = torch.zeros_like(p, dtype=torch.float64)
    gains = torch.ones_like(p)
    error = best_error = float(np.finfo(float).max)
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % n_iter_check == 0
        err, grad = objective(p, check or i == max_iter - 1)
        turned = update * grad < 0.0
        gains = torch.where(turned, gains + 0.2, gains * 0.8).clamp_(min=min_gain)
        grad = grad * gains
        update = momentum * update - learning_rate * grad.to(torch.float64)
        p.add_(update)
        if err is not None:
            error = float(err)
        if check:
            grad_norm = float(torch.linalg.vector_norm(grad))
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if grad_norm <= min_grad_norm:
                break
    return p, error, i


def trustworthiness(x: torch.Tensor, y: torch.Tensor, n_neighbors: int = 5, rows: Optional[torch.Tensor] = None,
                    block: Optional[int] = None) -> float:
    """Scikit-learn's ``manifold.trustworthiness`` of the embedding ``y`` of
    ``x``: ``1 - 2/(m·k·(2N - 3k - 1)) · Σ_i Σ_j max(0, r(i, j) - k)`` over
    each row i's k nearest neighbours j in ``y``, ``r(i, j)`` the rank of j
    among i's neighbours in ``x`` (euclidean, float64).  Over the rows
    ``rows`` (``m`` of them; default all, ``m = N``), by blocks of rows on
    the tensors' device."""
    n = x.shape[0]
    k = n_neighbors
    if k >= n / 2:
        raise ValueError(f"n_neighbors ({k}) should be less than n_samples / 2 ({n / 2})")
    x64, y64 = x.to(torch.float64), y.to(device=x.device, dtype=torch.float64)
    sq_x = (x64 * x64).sum(1)
    rows = torch.arange(n, device=x.device) if rows is None else rows.to(x.device)
    m = rows.shape[0]
    total = 0
    step = _block_rows(n, block)
    for a in range(0, m, step):
        r = rows[a:a + step]
        ar = torch.arange(r.shape[0], device=x.device)
        dx = _sq_dist64(x64[r], x64, sq_x[r], sq_x)
        dx[ar, r] = math.inf
        dy = torch.cdist(y64[r], y64, compute_mode="donot_use_mm_for_euclid_dist")
        dy[ar, r] = math.inf
        near = torch.topk(dy, k, dim=1, largest=False).indices
        for j in range(k):
            rank = (dx < dx[ar, near[:, j]][:, None]).sum(1) + 1
            total += int((rank - k).clamp(min=0).sum())
    return 1.0 - total * (2.0 / (m * k * (2.0 * n - 3.0 * k - 1.0)))


class TSNE:
    """t-SNE as ``sklearn.manifold.TSNE(n_components, perplexity=...)`` at
    scikit-learn's other defaults (module docstring), in torch on
    ``device`` (default: the GPU, through
    :func:`~sgl_tpu_torch.device.resolve_device`).

    ``fit_transform(X)`` returns the embedding as a float32 tensor on the
    device and sets ``embedding_``, ``kl_divergence_`` and ``n_iter_`` as
    scikit-learn does, ``learning_rate_``, ``kl_after_exploration_`` (the KL
    of the un-exaggerated P at the end of the exploration) and
    ``timings_`` (seconds of the kNN, P, the PCA and the descent, device
    work included)."""

    def __init__(self, n_components: int = 2, *, perplexity: float = 30.0, device=None):
        self.n_components = n_components
        self.perplexity = perplexity
        self.device = resolve_device(device)

    def _timed(self, name: str, fn):
        t = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings_[name] = time.perf_counter() - t
        return out

    def fit_transform(self, X) -> torch.Tensor:
        x = torch.as_tensor(X.detach() if torch.is_tensor(X) else np.asarray(X))
        x = x.to(self.device, x.dtype if x.dtype == torch.float64 else torch.float32)
        n = x.shape[0]
        if self.perplexity >= n:
            raise ValueError(f"perplexity ({self.perplexity}) must be less than n_samples ({n})")
        self.timings_ = {}
        self.learning_rate_ = max(n / EARLY_EXAGGERATION / 4, 50.0)
        k = min(n - 1, int(3.0 * self.perplexity + 1))
        dist, idx = self._timed("knn", lambda: knn_sq_distances(x, k))
        P = self._timed("p", lambda: joint_p(conditional_p(dist, self.perplexity), idx))
        y0 = self._timed("pca", lambda: pca_init(x, self.n_components))
        dof = max(self.n_components - 1, 1)

        def objective(P):
            return lambda p, compute_error: kl_grad(p, P, dof, compute_error)

        def descend():
            opt = dict(n_iter_check=N_ITER_CHECK, min_grad_norm=MIN_GRAD_NORM, learning_rate=self.learning_rate_)
            params, _, it = gradient_descent(objective(P.scaled(EARLY_EXAGGERATION)), y0, 0, EXPLORATION_MAX_ITER,
                                             n_iter_without_progress=EXPLORATION_MAX_ITER, momentum=0.5, **opt)
            self.kl_after_exploration_ = float(kl_grad(params, P, dof)[0])
            return gradient_descent(objective(P), params, it + 1, MAX_ITER,
                                    n_iter_without_progress=N_ITER_WITHOUT_PROGRESS, momentum=0.8, **opt)

        self.embedding_, self.kl_divergence_, self.n_iter_ = self._timed("descent", descend)
        return self.embedding_
