"""Heterogeneous (NARS) node classification — counterpart of
``sgl_tpu/tasks/hetero_node_classification.py``.

The loop of :class:`~sgl_tpu_torch.tasks.NodeClassification` in
mini-batches, with the NARS subgraph plumbing and, for the relation
importance studies (``sgl_tpu_torch.etc``), the learned subgraph weights
recorded at the best validation epoch.  It runs on the GPU unless
``device="cpu"`` is passed, and raises when no GPU is present.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.tasks.base_task import BaseTask
from sgl_tpu_torch.tasks.node_classification import _sync
from sgl_tpu_torch.tasks.utils import (
    adam_l2,
    batch_iterator,
    make_eval_step,
    make_train_step,
    set_seed,
    weighted_cross_entropy,
)


class HeteroNodeClassification(BaseTask):
    def __init__(
        self,
        dataset,
        predict_class: str,
        model,
        lr: float,
        weight_decay: float,
        epochs: int,
        device=None,
        loss_fn=weighted_cross_entropy,
        seed: int = 42,
        train_batch_size=None,
        eval_batch_size=None,
        random_subgraph_num: int = -1,
        subgraph_edge_type_num: int = -1,
        subgraph_list=None,
        record_subgraph_weight: bool = False,
        verbose: bool = True,
    ):
        super().__init__()
        self._dataset = dataset
        self._predict_class = predict_class
        self._model = model
        self._device = resolve_device(device)
        self._lr = lr
        self._weight_decay = weight_decay
        self._epochs = epochs
        self._loss_fn = loss_fn
        self._seed = seed
        self._train_batch_size = train_batch_size
        self._eval_batch_size = eval_batch_size
        self._verbose = verbose
        #: wall seconds of ``model.preprocess`` (host sampling and device work)
        self.preprocess_seconds: float = 0.0
        #: wall seconds of each epoch's training steps (device work included)
        self.epoch_seconds: List[float] = []
        self._test_acc, self._subgraph_weight = self._execute(
            random_subgraph_num, subgraph_edge_type_num, subgraph_list, record_subgraph_weight
        )

    test_acc = property(lambda self: self._test_acc)
    subgraph_weight = property(lambda self: self._subgraph_weight)

    def _execute(self, random_subgraph_num, subgraph_edge_type_num, subgraph_list, record_subgraph_weight):
        ds, model, device = self._dataset, self._model, self._device
        init_gen = set_seed(self._seed)
        dropout_gen = torch.Generator(device=device).manual_seed(self._seed)
        np_rng = np.random.default_rng(self._seed)

        t0 = time.perf_counter()
        model.preprocess(
            ds,
            self._predict_class,
            random_subgraph_num=random_subgraph_num,
            subgraph_edge_type_num=subgraph_edge_type_num,
            subgraph_list=subgraph_list,
            seed=self._seed,
            device=device,
        )
        _sync(device)
        self.preprocess_seconds = time.perf_counter() - t0
        if self._verbose:
            print(f"Preprocessing done in {self.preprocess_seconds:.4f}s")

        labels_np = np.asarray(ds.data[self._predict_class].y).reshape(-1)
        labels = torch.as_tensor(labels_np, dtype=torch.int64, device=device)
        train_idx = np.asarray(ds.train_idx)
        val_idx = np.asarray(ds.val_idx)
        test_idx = np.asarray(ds.test_idx)

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
        best_weight = None
        for epoch in range(self._epochs):
            t = time.perf_counter()
            losses, accs, weights = [], [], []
            for b_idx, w in batch_iterator(train_idx, self._train_batch_size, shuffle=True, rng=np_rng):
                b = on_device(b_idx)
                loss, acc = train_step(model.batch_input(b), labels[b], on_device(w), dropout_gen)
                losses.append(float(loss))  # waits for the step to finish
                accs.append(float(acc))
                weights.append(float(w.sum()))
            self.epoch_seconds.append(time.perf_counter() - t)
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
                if record_subgraph_weight:
                    best_weight = model.subgraph_weight()
        if self._verbose:
            print(f"Best val: {best_val:.4f}, best test: {best_test:.4f}")
        self.net = net
        return best_test, best_weight
