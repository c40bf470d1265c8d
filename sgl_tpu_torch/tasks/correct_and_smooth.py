"""Node classification + Correct & Smooth post-processing — counterpart of
``sgl_tpu/tasks/correct_and_smooth.py``.

Standard SGAP training; whenever the validation accuracy improves, the
full-graph softmax is kept; after training that best snapshot is corrected
(residual propagation) and smoothed (label propagation) over adjacencies
normalized with their own ``r``.  On the card each of the
``num_correct_layers + num_smooth_layers`` layers is one launch of the CSR
kernel at the class count's width.
"""

from __future__ import annotations

import numpy as np
import torch

from sgl_tpu_torch.graph.normalize import symmetric_normalized_weights
from sgl_tpu_torch.tasks.node_classification import NodeClassification
from sgl_tpu_torch.tricks.correct_and_smooth import CorrectAndSmooth


class NodeClassificationWithCorrectAndSmooth(NodeClassification):
    def __init__(
        self,
        dataset,
        model,
        lr: float,
        weight_decay: float,
        epochs: int,
        num_correct_layers: int,
        correct_alpha: float,
        num_smooth_layers: int,
        smooth_alpha: float,
        autoscale: bool = True,
        scale: float = 1.0,
        correct_r: float = 0.5,
        smooth_r: float = 0.5,
        device=None,
        **kw,
    ):
        self._cs = CorrectAndSmooth(
            num_correct_layers, correct_alpha, num_smooth_layers, smooth_alpha, autoscale, scale
        )
        self._correct_r = correct_r
        self._smooth_r = smooth_r
        self._best_y_soft = None
        super().__init__(dataset, model, lr, weight_decay, epochs, device=device, **kw)

    def _on_best(self, net) -> None:
        self._best_y_soft = torch.softmax(self._all_logits(net), dim=1)

    def _postprocess(self, net, labels, val_idx, test_idx):
        if self._best_y_soft is None:
            self._on_best(net)
        ds, device = self._dataset, self._device
        correct_adj = symmetric_normalized_weights(ds.graph, r=self._correct_r, device=device)
        smooth_adj = symmetric_normalized_weights(ds.graph, r=self._smooth_r, device=device)
        train_idx = np.asarray(ds.train_idx)
        with torch.no_grad():
            out = self._cs.correct(self._best_y_soft, labels, train_idx, correct_adj)
            out = self._cs.smooth(out, labels, train_idx, smooth_adj)
        pred = out.argmax(dim=1)

        def acc(idx):
            idx = torch.as_tensor(np.asarray(idx), device=device)
            return float((pred[idx] == labels[idx]).float().mean())

        acc_val, acc_test = acc(val_idx), acc(test_idx)
        if self._verbose:
            print(f"After C&S, acc_val: {acc_val:.4f} acc_test: {acc_test:.4f}")
        return acc_val, acc_test


# reference-style alias
NodeClassification_With_CorrectAndSmooth = NodeClassificationWithCorrectAndSmooth
