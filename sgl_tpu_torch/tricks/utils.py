"""Trick utilities: label propagation and the Loge losses.

Counterpart of ``sgl_tpu/tricks/utils.py``; the losses are also exported by
``sgl_tpu_torch.tasks.utils``, as in ``sgl_tpu``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from sgl_tpu_torch.kernels.sparse import SparseAdj, ensure_device_layout, spmm

LOGE_EPSILON = 1.0 - math.log(2)


def loge_cross_entropy_loss(logits, labels, epsilon: float = LOGE_EPSILON) -> torch.Tensor:
    """Loge cross-entropy: ``log(ε + ce) - log(ε)`` of the MEAN
    cross-entropy (the reference reduces first, then transforms)."""
    ce = F.cross_entropy(logits, labels)
    return torch.log(epsilon + ce) - math.log(epsilon)


def loge_bce_loss(logits, target, epsilon: float = LOGE_EPSILON) -> torch.Tensor:
    """Loge binary cross-entropy on LOGITS, the transform applied to the
    mean."""
    bce = F.binary_cross_entropy_with_logits(logits, target)
    return torch.log(epsilon + bce) - math.log(epsilon)


def _clip01(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0.0, 1.0)


def label_propagation(
    labels: torch.Tensor,
    adj: SparseAdj,
    num_layers: int,
    alpha: float,
    post_process: Callable = _clip01,
    mask=None,
) -> torch.Tensor:
    """``out = post(α·Â·out + (1-α)·out₀)`` iterated ``num_layers`` times,
    on ``labels``' device.

    ``labels`` are integer class ids (one-hot encoded on entry, over
    ``labels.max() + 1`` classes) or soft labels; ``mask`` (indices or a
    boolean vector) keeps only its rows of ``out₀`` and zeroes the rest.
    The adjacency goes through :func:`ensure_device_layout`, so on the card
    every layer is one launch of the CSR kernel at width C, the class
    count, on a CSR built once.
    """
    if not torch.is_floating_point(labels):
        labels = F.one_hot(labels.reshape(-1).long(), int(labels.max()) + 1)
    labels = labels.to(torch.float32)
    adj = ensure_device_layout(adj)
    out = labels.contiguous()
    if mask is not None:
        mask = torch.as_tensor(mask, device=labels.device)
        out = torch.zeros_like(labels)
        out[mask] = labels[mask]
    res = (1.0 - alpha) * out
    for _ in range(num_layers):
        out = post_process(alpha * spmm(adj, out) + res)
    return out
