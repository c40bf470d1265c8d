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

import numpy as np
import torch

from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.tasks.base_task import BaseTask
from sgl_tpu_torch.tasks.node_classification import _sync
from sgl_tpu_torch.tasks.utils import (
    adam_l2,
    add_labels,
    batch_iterator,
    make_eval_step,
    make_logits_fn,
    make_train_step,
    set_seed,
    weighted_cross_entropy,
)


def reuse_labels(model, net, graph, features: np.ndarray, unlabeled, num_classes: int, device,
                 batch_size=None) -> None:
    """One label-reuse iteration: the soft predictions of ``net`` on every
    node (in pieces of ``batch_size`` rows) replace the label columns of the
    ``unlabeled`` rows of ``features`` (in place, on the host), then
    ``model`` propagates the result again."""
    pred = make_logits_fn(net, batch_size, model.row_dim)(model.processed_feature)
    soft = torch.softmax(pred, dim=-1).cpu().numpy()
    features[unlabeled, -num_classes:] = soft[unlabeled]
    model.preprocess(graph, features, device=device)


class NodeClassificationWithLabelUse(BaseTask):
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

    test_acc = property(lambda self: self._test_acc)

    def _execute(self) -> float:
        ds, model, device = self._dataset, self._model, self._device
        init_gen = set_seed(self._seed)
        dropout_gen = torch.Generator(device=device).manual_seed(self._seed)
        np_rng = np.random.default_rng(self._seed)
        labels_np = np.asarray(ds.y).reshape(-1)
        labels = torch.as_tensor(labels_np, dtype=torch.int64, device=device)
        train_idx = np.asarray(ds.train_idx)
        val_idx = np.asarray(ds.val_idx)
        test_idx = np.asarray(ds.test_idx)
        num_classes = ds.num_classes

        # parameters for the label-augmented feature width
        features0 = (
            add_labels(ds.x, labels_np, train_idx[:0], num_classes)
            if self._use_labels
            else np.asarray(ds.x)
        )
        model.preprocess(ds.graph, features0, device=device)
        net = model.net.cpu()
        model.init(init_gen)
        net.to(device)
        optimizer = adam_l2(net.parameters(), self._lr, self._weight_decay)
        train_step = make_train_step(net, optimizer, self._loss_fn)
        eval_step = make_eval_step(net)

        def on_device(a):
            return torch.as_tensor(a, device=device)

        def eval_on(idx):
            correct, total = 0.0, 0.0
            for b_idx, w in batch_iterator(idx, self._eval_batch_size, shuffle=False, rng=np_rng):
                b = on_device(b_idx)
                c, t = eval_step(model.batch_input(b), labels[b], on_device(w))
                correct += float(c)
                total += float(t)
            return correct / max(total, 1.0)

        best_val, best_test = 0.0, 0.0
        train_pred_idx = train_idx
        for epoch in range(self._epochs):
            if self._use_labels:
                mask = np_rng.random(train_idx.shape[0]) < self._mask_rate
                train_labels_idx = train_idx[mask]
                train_pred_idx = train_idx[~mask]
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

            t = time.perf_counter()
            losses, accs, weights = [], [], []
            for b_idx, w in batch_iterator(
                train_pred_idx, self._train_batch_size, shuffle=True, rng=np_rng
            ):
                b = on_device(b_idx)
                loss, acc = train_step(model.batch_input(b), labels[b], on_device(w), dropout_gen)
                losses.append(float(loss))
                accs.append(float(acc))
                weights.append(float(w.sum()))
            acc_val = eval_on(val_idx)
            acc_test = eval_on(test_idx)
            if self._verbose:
                print(
                    f"Epoch: {epoch + 1:03d} "
                    f"loss_train: {np.average(losses, weights=weights):.4f} "
                    f"acc_train: {np.average(accs, weights=weights):.4f} "
                    f"acc_val: {acc_val:.4f} acc_test: {acc_test:.4f} "
                    f"time: {time.perf_counter() - t:.4f}s"
                )
            if acc_val > best_val:
                best_val, best_test = acc_val, acc_test

        # post-process, with the model's optional post-propagation
        outputs = make_logits_fn(net, self._eval_batch_size, model.row_dim)(model.processed_feature)
        pred = model.postprocess(ds.graph, outputs).argmax(dim=1)

        def acc(idx):
            idx = on_device(idx)
            return float((pred[idx] == labels[idx]).float().mean())

        acc_val, acc_test = acc(val_idx), acc(test_idx)
        if acc_val > best_val:
            best_val, best_test = acc_val, acc_test
        if self._verbose:
            print(f"Best val: {best_val:.4f}, best test: {best_test:.4f}")
        self.net = net
        return best_test
