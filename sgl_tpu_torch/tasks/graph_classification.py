"""Graph classification task — counterpart of
``sgl_tpu/tasks/graph_classification.py``.

Same constructor-runs UX as the node tasks.  The loop is full-batch over
graphs with split masks: the precompute already reduced every graph to one
pooled row (non-learnable message op) or one hop stack (learnable), so an
epoch is one step whose loss and accuracy are weighted by the train mask.
It runs on the GPU unless ``device="cpu"`` is passed, and raises when no
GPU is present.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.models.graph_level import GraphLevelSGAPModel
from sgl_tpu_torch.tasks.base_task import BaseTask
from sgl_tpu_torch.tasks.node_classification import _sync
from sgl_tpu_torch.tasks.utils import (
    adam_l2,
    make_eval_step,
    make_train_step,
    set_seed,
    weighted_cross_entropy,
)


class GraphClassification(BaseTask):
    def __init__(
        self,
        dataset,
        model: GraphLevelSGAPModel,
        lr: float,
        weight_decay: float,
        epochs: int,
        device=None,
        loss_fn: Callable = weighted_cross_entropy,
        seed: int = 42,
        verbose: bool = True,
        precompute_dtype: Optional[torch.dtype] = None,  # torch.bfloat16: the bf16 CSR kernel
    ):
        super().__init__()
        self._dataset = dataset
        self._model = model
        self._device = resolve_device(device)
        self._lr = lr
        self._weight_decay = weight_decay
        self._epochs = epochs
        self._loss_fn = loss_fn
        self._seed = seed
        self._verbose = verbose
        self._precompute_dtype = precompute_dtype
        #: host seconds of ``dataset.batch()`` (zero once the batch is built)
        self.batch_seconds: float = 0.0
        #: wall seconds of ``model.preprocess`` (device work included)
        self.preprocess_seconds: float = 0.0
        #: wall seconds of each epoch's train step (device work included)
        self.epoch_seconds: List[float] = []
        self._test_acc = self._execute()

    @property
    def test_acc(self) -> float:
        return self._test_acc

    def _execute(self) -> float:
        ds, model, device = self._dataset, self._model, self._device
        init_gen = set_seed(self._seed)
        dropout_gen = torch.Generator(device=device).manual_seed(self._seed)

        t0 = time.perf_counter()
        batch = ds.batch()
        self.batch_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        model.preprocess(batch, dtype=self._precompute_dtype, device=device)
        _sync(device)
        self.preprocess_seconds = time.perf_counter() - t0
        if self._verbose:
            print(f"Preprocessing done in {self.batch_seconds + self.preprocess_seconds:.4f}s")

        g = batch.num_graphs
        labels = torch.as_tensor(np.asarray(ds.y).reshape(-1), dtype=torch.int64, device=device)

        def mask(idx):
            m = torch.zeros(g, dtype=torch.float32)
            m[torch.as_tensor(np.asarray(idx), dtype=torch.int64)] = 1.0
            return m.to(device)

        w_train, w_val, w_test = mask(ds.train_idx), mask(ds.val_idx), mask(ds.test_idx)

        net = model.net.cpu()
        model.init(init_gen)
        net.to(device)
        optimizer = adam_l2(net.parameters(), self._lr, self._weight_decay)
        feats, gids, counts = model.net_inputs()
        bound = functools.partial(net, graph_ids=gids, node_counts=counts)
        train_step = make_train_step(bound, optimizer, self._loss_fn)
        eval_step = make_eval_step(bound)

        best_val, best_test = 0.0, 0.0
        t_total = time.perf_counter()
        for epoch in range(self._epochs):
            t = time.perf_counter()
            loss_train, acc_train = train_step(feats, labels, w_train, dropout_gen)
            loss_train = float(loss_train)  # waits for the step to finish
            self.epoch_seconds.append(time.perf_counter() - t)
            cv, tv = eval_step(feats, labels, w_val)
            ct, tt = eval_step(feats, labels, w_test)
            acc_val = float(cv) / max(float(tv), 1.0)
            acc_test = float(ct) / max(float(tt), 1.0)
            if self._verbose:
                print(
                    f"Epoch: {epoch + 1:03d} loss_train: {loss_train:.4f} "
                    f"acc_train: {float(acc_train):.4f} acc_val: {acc_val:.4f} "
                    f"acc_test: {acc_test:.4f} time: {time.perf_counter() - t:.4f}s"
                )
            if acc_val > best_val:
                best_val, best_test = acc_val, acc_test

        if self._verbose:
            print("Optimization Finished!")
            print(f"Total time elapsed: {time.perf_counter() - t_total:.4f}s")
            print(f"Best val: {best_val:.4f}, best test: {best_test:.4f}")
        self.net = net
        return best_test
