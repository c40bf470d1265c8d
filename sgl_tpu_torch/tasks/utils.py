"""Task-layer utilities — counterpart of ``sgl_tpu/tasks/utils.py``: seeds,
metrics, the optimizer, and plain train / eval / logits step functions."""

from __future__ import annotations

import random
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def set_seed(seed: int) -> torch.Generator:
    """Seed python and numpy and return a CPU ``torch.Generator`` seeded
    with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of argmax predictions equal to labels."""
    return (logits.argmax(dim=1) == labels).float().mean()


def weighted_cross_entropy(logits, labels, w):
    ce = F.cross_entropy(logits, labels, reduction="none")
    return (ce * w).sum() / w.sum().clamp(min=1.0)


def weighted_accuracy(logits, labels, w):
    hit = (logits.argmax(dim=1) == labels).float()
    return (hit * w).sum() / w.sum().clamp(min=1.0)


def adam_l2(params, lr: float, weight_decay: float) -> torch.optim.Optimizer:
    """Adam with an L2 penalty added to the gradient before the moments
    (not decoupled AdamW) — the reference's ``optax.chain(
    add_decayed_weights(wd), adam(lr))``, same eps (1e-8) and betas."""
    return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)


def make_train_step(
    net: nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable = weighted_cross_entropy,
):
    """Build a train step ``step(feats, labels, w, generator) -> (loss,
    acc)`` that updates ``net``'s parameters in place.  ``w`` carries
    per-example weights (all ones for full batch; zeros mask wrap-padded
    tail examples in mini-batch mode); ``generator`` drives dropout."""

    def step(feats, labels, w, generator: Optional[torch.Generator] = None):
        optimizer.zero_grad(set_to_none=True)
        logits = net(feats, train=True, generator=generator)
        loss = loss_fn(logits, labels, w)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            return loss.detach(), weighted_accuracy(logits, labels, w)

    return step


def make_eval_step(net: nn.Module):
    """``step(feats, labels, w) -> (correct_count, weight_sum)`` so
    mini-batch results aggregate exactly."""

    @torch.no_grad()
    def step(feats, labels, w):
        logits = net(feats, train=False)
        hit = (logits.argmax(dim=1) == labels).float()
        return (hit * w).sum(), w.sum()

    return step


def make_logits_fn(net: nn.Module):
    @torch.no_grad()
    def logits(feats):
        return net(feats, train=False)

    return logits


def batch_iterator(idx: np.ndarray, batch_size: Optional[int], shuffle: bool, rng):
    """Fixed-size mini-batch iterator: drops nothing, pads the tail by
    wrapping, yields ``(batch_idx, weight)`` pairs where weight masks the
    wrapped duplicates out of metrics and loss."""
    idx = np.asarray(idx)
    n = idx.shape[0]
    if batch_size is None or batch_size >= n:
        yield idx, np.ones(n, np.float32)
        return
    order = rng.permutation(n) if shuffle else np.arange(n)
    for s in range(0, n, batch_size):
        chunk = order[s : s + batch_size]
        pad = batch_size - chunk.shape[0]
        w = np.ones(batch_size, np.float32)
        if pad:
            chunk = np.concatenate([chunk, order[:pad]])
            w[batch_size - pad :] = 0.0
        yield idx[chunk], w
