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
from functools import partial

import numpy as np
import torch

from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.tasks.node_classification import NodeTaskLoop, _order, _sync, eval_sums, train_epoch
from sgl_tpu_torch.tasks.utils import set_seed, weighted_cross_entropy
from sgl_tpu_torch.utils.profiling import span
from sgl_tpu_torch.utils.transfer import to_device


class HeteroNodeClassification(NodeTaskLoop):
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
        self._test_acc, self._subgraph_weight = self._execute(
            random_subgraph_num, subgraph_edge_type_num, subgraph_list, record_subgraph_weight
        )

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

        # the labels and the split's indices go to the device once a job
        labels, train, val, test = (
            to_device(np.asarray(a).reshape(-1), device, torch.int64)
            for a in (ds.data[self._predict_class].y, ds.train_idx, ds.val_idx, ds.test_idx)
        )

        net, train_step, eval_step = self._net_and_steps(model, init_gen)

        def train_order():
            return _order(len(train), self._train_batch_size, np_rng, device)

        def evaluate():
            return [*eval_sums(eval_step, model, labels, val, self._eval_batch_size),
                    *eval_sums(eval_step, model, labels, test, self._eval_batch_size)]

        best_val, best_test = 0.0, 0.0
        best_weight = None
        order = train_order()
        for epoch in range(self._epochs):
            with span("sgl.task.epoch"):
                # the next order is drawn while the card runs the eval,
                # which draws nothing: the draws keep their order
                acc_val, acc_test, order = self._epoch(
                    epoch, partial(train_epoch, train_step, model, labels, train, self._train_batch_size, order,
                                   dropout_gen),
                    evaluate, train_order)
                if acc_val > best_val:
                    best_val, best_test = acc_val, acc_test
                    if record_subgraph_weight:
                        best_weight = model.subgraph_weight()
        if self._verbose:
            print(f"Best val: {best_val:.4f}, best test: {best_test:.4f}")
        self.net = net
        return best_test, best_weight
