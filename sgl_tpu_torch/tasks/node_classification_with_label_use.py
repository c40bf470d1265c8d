"""Node classification with label use and label reuse — counterpart of
``sgl_tpu/tasks/node_classification_with_label_use.py``.

Label use: each epoch a random half of the training labels is appended as
one-hot columns to the features (the model learns to predict the other
half).  Label reuse: after ``reuse_start_epoch``, the predicted soft labels
of the nodes without a label fill their label columns and the features are
propagated again, ``label_iters`` times an epoch.  The model's ``feat_dim``
must be ``num_features + num_classes``.  The label masks and the shuffles
draw from ``np.random.default_rng(seed)``, so one seed gives ``sgl_tpu``'s
masks.  On the card every propagation runs the CSR kernel at width
``num_features + num_classes``.
"""

from __future__ import annotations

import time
from functools import partial

import numpy as np
import torch

from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.tasks.node_classification import NodeTaskLoop, _order, _sync, all_logits, eval_sums, train_epoch
from sgl_tpu_torch.tasks.utils import add_labels, set_seed, weighted_cross_entropy
from sgl_tpu_torch.utils.profiling import span
from sgl_tpu_torch.utils.transfer import to_device


def reuse_labels(model, net, graph, features: np.ndarray, unlabeled, num_classes: int, device,
                 batch_size=None) -> None:
    """One label-reuse iteration: the soft predictions of ``net`` on every
    node (in pieces of ``batch_size`` rows) replace the label columns of the
    ``unlabeled`` rows of ``features`` (in place, on the host), then
    ``model`` propagates the result again."""
    soft = torch.softmax(all_logits(net, model, batch_size), dim=-1).cpu().numpy()
    features[unlabeled, -num_classes:] = soft[unlabeled]
    model.preprocess(graph, features, device=device)


class NodeClassificationWithLabelUse(NodeTaskLoop):
    def __init__(
        self,
        dataset,
        model,
        lr: float,
        weight_decay: float,
        epochs: int,
        device=None,
        loss_fn=weighted_cross_entropy,
        seed: int = 42,
        train_batch_size=None,
        eval_batch_size=None,
        label_reuse_batch_size=None,
        mask_rate: float = 0.5,
        use_labels: bool = True,
        reuse_start_epoch: int = 0,
        label_iters: int = 0,
        verbose: bool = True,
    ):
        super().__init__()
        if label_iters > 0 and not use_labels:
            raise ValueError("When using label reuse, it's essential to enable label use!")
        self._dataset = dataset
        self._model = model
        self._device = resolve_device(device)
        self._lr = lr
        self._weight_decay = weight_decay
        self._epochs = epochs
        self._loss_fn = loss_fn
        self._seed = seed
        self._train_batch_size = train_batch_size
        self._eval_batch_size = eval_batch_size
        self._mask_rate = mask_rate
        self._use_labels = use_labels
        self._reuse_start_epoch = reuse_start_epoch
        self._label_iters = label_iters
        self._verbose = verbose
        #: wall seconds of each epoch's propagations (reuse included)
        self.propagate_seconds = []
        self._test_acc = self._execute()

    def _execute(self) -> float:
        ds, model, device = self._dataset, self._model, self._device
        init_gen = set_seed(self._seed)
        dropout_gen = torch.Generator(device=device).manual_seed(self._seed)
        np_rng = np.random.default_rng(self._seed)
        labels_np = np.asarray(ds.y).reshape(-1)
        train_idx = np.asarray(ds.train_idx)
        val_idx = np.asarray(ds.val_idx)
        test_idx = np.asarray(ds.test_idx)
        # the labels and the split's indices go to the device once a job
        labels, train, val, test = (to_device(a, device, torch.int64)
                                    for a in (labels_np, train_idx, val_idx, test_idx))
        num_classes = ds.num_classes

        # parameters for the label-augmented feature width
        features0 = (
            add_labels(ds.x, labels_np, train_idx[:0], num_classes)
            if self._use_labels
            else np.asarray(ds.x)
        )
        model.preprocess(ds.graph, features0, device=device)
        net, train_step, eval_step = self._net_and_steps(model, init_gen)

        def evaluate():
            return [*eval_sums(eval_step, model, labels, val, self._eval_batch_size),
                    *eval_sums(eval_step, model, labels, test, self._eval_batch_size)]

        best_val, best_test = 0.0, 0.0
        train_pred_idx = train_idx
        for epoch in range(self._epochs):
            if self._use_labels:
                mask = np_rng.random(train_idx.shape[0]) < self._mask_rate
                train_labels_idx = train_idx[mask]
                train_pred_idx = train_idx[~mask]
                # the subset to predict goes to the device in one copy
                train = to_device(train_pred_idx, device, torch.int64)
                features = add_labels(ds.x, labels_np, train_labels_idx, num_classes)
            else:
                features = np.asarray(ds.x)

            t0 = time.perf_counter()
            model.preprocess(ds.graph, features, device=device)
            if self._label_iters > 0 and epoch > self._reuse_start_epoch:
                unlabeled = np.concatenate([train_pred_idx, val_idx, test_idx])
                for _ in range(self._label_iters):
                    reuse_labels(model, net, ds.graph, features, unlabeled, num_classes, device,
                                 self._eval_batch_size)
            _sync(device)
            self.propagate_seconds.append(time.perf_counter() - t0)
            if self._verbose:
                print(f"Feature Propagate done in {self.propagate_seconds[-1]:.4f}s")

            # drawn after the mask, as the masks and shuffles have always
            # drawn from the one generator
            order = _order(len(train_pred_idx), self._train_batch_size, np_rng, device)
            with span("sgl.task.epoch"):
                acc_val, acc_test, _ = self._epoch(
                    epoch, partial(train_epoch, train_step, model, labels, train, self._train_batch_size, order,
                                   dropout_gen),
                    evaluate)
                if acc_val > best_val:
                    best_val, best_test = acc_val, acc_test

        # post-process, with the model's optional post-propagation
        pred = model.postprocess(ds.graph, all_logits(net, model, self._eval_batch_size)).argmax(dim=1)
        acc_val, acc_test = ((pred[i] == labels[i]).float().mean().item() for i in (val, test))
        if acc_val > best_val:
            best_val, best_test = acc_val, acc_test
        if self._verbose:
            print(f"Best val: {best_val:.4f}, best test: {best_test:.4f}")
        self.net = net
        return best_test
