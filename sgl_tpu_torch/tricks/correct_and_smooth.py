"""Correct & Smooth post-processing — counterpart of
``sgl_tpu/tricks/correct_and_smooth.py``.

Training-free label propagation after training: ``correct`` propagates the
train-set residual error (clamped to [-1, 1] and autoscaled, or with the
train rows held fixed and a fixed scale), ``smooth`` propagates the
corrected soft labels with the true train labels put in.  Runs on the
device of ``y_soft``; on the card each layer is one launch of the CSR
kernel at the class count's width.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sgl_tpu_torch.kernels.sparse import SparseAdj
from sgl_tpu_torch.tricks.utils import label_propagation


def _one_hot_like(y_true: torch.Tensor, y_soft: torch.Tensor) -> torch.Tensor:
    if not torch.is_floating_point(y_true):
        return F.one_hot(y_true.reshape(-1).long(), y_soft.shape[-1]).to(y_soft.dtype)
    return y_true.to(y_soft.dtype)


def _as_index(mask, device: torch.device):
    """``mask`` (indices or booleans, host or device) as a device index and
    the number of rows it selects."""
    mask = torch.as_tensor(mask, device=device)
    count = int(mask.sum()) if mask.dtype == torch.bool else int(mask.shape[0])
    return mask, count


class CorrectAndSmooth:
    def __init__(
        self,
        num_correct_layers: int,
        correct_alpha: float,
        num_smooth_layers: int,
        smooth_alpha: float,
        autoscale: bool = True,
        scale: float = 1.0,
    ):
        self._num_correct_layers = num_correct_layers
        self._correct_alpha = correct_alpha
        self._num_smooth_layers = num_smooth_layers
        self._smooth_alpha = smooth_alpha
        self._autoscale = autoscale
        self._scale = scale

    def correct(self, y_soft, y_true, mask, adj: SparseAdj) -> torch.Tensor:
        """Propagate the residual error of the ``mask`` rows (the training
        nodes) and add it back to ``y_soft``."""
        y_soft = torch.as_tensor(y_soft)
        y_true = _one_hot_like(torch.as_tensor(y_true, device=y_soft.device), y_soft)
        mask, num_true = _as_index(mask, y_soft.device)
        error = torch.zeros_like(y_soft)
        error[mask] = y_true[mask] - y_soft[mask]

        if self._autoscale:
            smoothed = label_propagation(
                error, adj, self._num_correct_layers, self._correct_alpha,
                post_process=lambda x: x.clamp(-1.0, 1.0),
            )
            sigma = error[mask].abs().sum() / num_true
            scale = sigma / smoothed.abs().sum(dim=1, keepdim=True)
            scale = torch.where(torch.isinf(scale) | (scale > 1000), 1.0, scale)
            return y_soft + smoothed * scale

        def fix_input(x):
            x[mask] = error[mask]
            return x

        smoothed = label_propagation(
            error, adj, self._num_correct_layers, self._correct_alpha, post_process=fix_input
        )
        return y_soft + smoothed * self._scale

    def smooth(self, y_soft, y_true, mask, adj: SparseAdj) -> torch.Tensor:
        """Propagate the corrected soft labels with the true labels of the
        ``mask`` rows put in."""
        y_soft = torch.as_tensor(y_soft).clone()
        y_true = _one_hot_like(torch.as_tensor(y_true, device=y_soft.device), y_soft)
        mask, _ = _as_index(mask, y_soft.device)
        y_soft[mask] = y_true[mask]
        return label_propagation(y_soft, adj, self._num_smooth_layers, self._smooth_alpha)
