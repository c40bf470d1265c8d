"""Task-layer utilities — counterpart of ``sgl_tpu/tasks/utils.py``: seeds,
metrics and losses, the optimizer and its warmup, the label-use features,
and plain train / eval / logits step functions."""

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


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels."""
    return F.cross_entropy(logits, labels)


def bce_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of probabilities, clipped to [1e-7, 1 - 1e-7]."""
    pred = pred.clamp(1e-7, 1 - 1e-7)
    return -(target * torch.log(pred) + (1 - target) * torch.log1p(-pred)).mean()


def weighted_cross_entropy(logits, labels, w):
    # a negative label counts from the last class, as optax's integer-label
    # loss reads it (LINKX and papers100M mark unlabeled nodes -1)
    labels = torch.where(labels < 0, labels + logits.shape[1], labels)
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


def warmup_factor(step: int, warmup_epochs: int = 50) -> float:
    """The linear warmup's share of the learning rate at optimizer step
    ``step`` (from 0): ``min((step + 1) / warmup_epochs, 1)``."""
    return min((step + 1) / warmup_epochs, 1.0)


def warmup_lr_schedule(
    optimizer: torch.optim.Optimizer, warmup_epochs: int = 50
) -> torch.optim.lr_scheduler.LambdaLR:
    """Linear learning-rate warmup over the first ``warmup_epochs`` steps:
    a ``LambdaLR`` whose factor at step ``s`` is :func:`warmup_factor`, the
    factor of ``sgl_tpu``'s optax schedule at the same step.  Call its
    ``step()`` after each ``optimizer.step()``."""
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: warmup_factor(step, warmup_epochs)
    )


def adam_l2_warmup(params, lr: float, weight_decay: float, warmup_epochs: int = 50):
    """:func:`adam_l2` with the linear warmup: ``(optimizer, scheduler)``."""
    optimizer = adam_l2(params, lr, weight_decay)
    return optimizer, warmup_lr_schedule(optimizer, warmup_epochs)


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


def make_logits_fn(net: nn.Module, batch_size: Optional[int] = None, row_dim: int = 0):
    """``logits(feats)``: the eval forward of every row of ``feats``; with
    ``batch_size`` it runs in pieces of that many rows along ``row_dim``
    (the rows of a hop-major stack are its axis 1), one call still giving
    every row's logits, so that no activation is held for all rows."""

    @torch.no_grad()
    def logits(feats):
        n = feats.shape[row_dim]
        if batch_size is None or batch_size >= n:
            return net(feats, train=False)
        return torch.cat([net(feats.narrow(row_dim, i, min(batch_size, n - i)), train=False)
                          for i in range(0, n, batch_size)])

    return logits


def add_labels(features, labels, idx, num_classes: int) -> np.ndarray:
    """``features`` with the one-hot labels of the ``idx`` rows appended as
    ``num_classes`` more columns (zeros elsewhere): the label-use trick, on
    the host, as ``sgl_tpu`` builds it."""
    features = np.asarray(features)
    onehot = np.zeros((features.shape[0], num_classes), features.dtype)
    labels = np.asarray(labels)
    idx = np.asarray(idx)
    onehot[idx, labels[idx]] = 1
    return np.concatenate([features, onehot], axis=-1)


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


# the Loge losses live in sgl_tpu_torch.tricks.utils; exported here too, as
# sgl_tpu's task utilities export them
from sgl_tpu_torch.tricks.utils import loge_bce_loss, loge_cross_entropy_loss  # noqa: F401,E402
