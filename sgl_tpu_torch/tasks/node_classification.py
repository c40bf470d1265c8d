"""Node classification task — counterpart of
``sgl_tpu/tasks/node_classification.py``.

Same UX: ``NodeClassification(dataset, model, lr, wd, epochs)`` runs the
whole task in its constructor — preprocessing, training with best-val
bookkeeping, post-processing — and exposes ``.test_acc``.  It runs on the
GPU unless ``device="cpu"`` is passed, and raises when no GPU is present.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch

from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.models.base import SGAPModel
from sgl_tpu_torch.tasks.base_task import BaseTask
from sgl_tpu_torch.tasks.utils import (
    adam_l2,
    batch_iterator,
    make_eval_step,
    make_logits_fn,
    make_train_step,
    set_seed,
    weighted_cross_entropy,
)
from sgl_tpu_torch.utils.config import TrainConfig
from sgl_tpu_torch.utils.profiling import count, span


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _batches(idx, batch_size: Optional[int], shuffle: bool, rng, device: torch.device):
    """The batches of ``batch_iterator`` with their indices and weights on
    ``device``: yields ``(indices, weights, host weights)``, each batch
    prepared inside a ``sgl.task.batch`` span.  Each upload copies from
    pageable host memory, which blocks the host until the card's stream
    has drained: a host sync."""
    n = len(idx)
    batches = batch_iterator(idx, batch_size, shuffle=shuffle, rng=rng)
    # one span a batch that batch_iterator yields: none around its exhaustion
    for _ in range(1 if batch_size is None or batch_size >= n else -(-n // batch_size)):
        with span("sgl.task.batch"):
            b_idx, w = next(batches)
            b, w_dev = torch.as_tensor(b_idx, device=device), torch.as_tensor(w, device=device)
            count("sgl.task.host_sync", 2, kind="upload")
        yield b, w_dev, w


class NodeClassification(BaseTask):
    def __init__(
        self,
        dataset,
        model: SGAPModel,
        lr: Optional[float] = None,
        weight_decay: Optional[float] = None,
        epochs: Optional[int] = None,
        device=None,
        loss_fn: Callable = weighted_cross_entropy,
        seed: Optional[int] = None,
        train_batch_size: Optional[int] = None,
        eval_batch_size: Optional[int] = None,
        verbose: bool = True,
        precompute_dtype: Optional[torch.dtype] = None,  # torch.bfloat16: bf16 SpMM, half hop memory
        config: Optional[TrainConfig] = None,  # defaults for the Nones above
    ):
        super().__init__()
        r = (config or TrainConfig()).resolve(
            lr=lr, weight_decay=weight_decay, epochs=epochs, seed=seed,
            train_batch_size=train_batch_size,
            eval_batch_size=eval_batch_size,
        )
        self._dataset = dataset
        self._model = model
        self._device = resolve_device(device)
        self._lr = r["lr"]
        self._weight_decay = r["weight_decay"]
        self._epochs = r["epochs"]
        self._loss_fn = loss_fn
        self._seed = r["seed"]
        self._train_batch_size = r["train_batch_size"]
        self._eval_batch_size = r["eval_batch_size"]
        self._verbose = verbose
        self._precompute_dtype = precompute_dtype
        #: wall seconds of ``model.preprocess`` (device work included)
        self.preprocess_seconds: float = 0.0
        #: wall seconds of each epoch's training steps (device work included)
        self.epoch_seconds: List[float] = []
        #: each epoch's mean training loss (weighted by the batches' rows)
        self.train_losses: List[float] = []
        with span("sgl.task.job"):
            self._test_acc = self._execute()

    @property
    def test_acc(self) -> float:
        return self._test_acc

    # ------------------------------------------------------------------
    def _execute(self) -> float:
        ds, model, device = self._dataset, self._model, self._device
        # parameters are drawn on the CPU, so every device starts from the
        # same weights; dropout draws from a generator on the device
        init_gen = set_seed(self._seed)
        dropout_gen = torch.Generator(device=device).manual_seed(self._seed)
        np_rng = np.random.default_rng(self._seed)

        t0 = time.perf_counter()
        model.preprocess(ds.graph, ds.x, dtype=self._precompute_dtype, device=device)
        _sync(device)
        self.preprocess_seconds = time.perf_counter() - t0
        if self._verbose:
            print(f"Preprocessing done in {self.preprocess_seconds:.4f}s")

        split = ds.to_device(device)
        labels = split.y
        train_idx = np.asarray(ds.train_idx)
        val_idx = np.asarray(ds.val_idx)
        test_idx = np.asarray(ds.test_idx)

        net = model.net.cpu()
        model.init(init_gen)
        net.to(device)
        optimizer = adam_l2(net.parameters(), self._lr, self._weight_decay)
        train_step = make_train_step(net, optimizer, self._loss_fn)
        eval_step = make_eval_step(net)

        def eval_on(idx):
            correct, total = 0.0, 0.0
            for b, w_dev, _ in _batches(idx, self._eval_batch_size, False, np_rng, device):
                c, t = eval_step(model.batch_input(b), labels[b], w_dev)
                correct += float(c)
                total += float(t)
                count("sgl.task.host_sync", 2, kind="read")
            return correct / max(total, 1.0)

        best_val, best_test = 0.0, 0.0
        t_total = time.perf_counter()
        for epoch in range(self._epochs):
            with span("sgl.task.epoch"):
                with span("sgl.task.train") as train_span:
                    t = time.perf_counter_ns()
                    losses, accs, weights = [], [], []
                    for b, w_dev, w in _batches(train_idx, self._train_batch_size, True, np_rng, device):
                        loss, acc = train_step(model.batch_input(b), labels[b], w_dev, dropout_gen)
                        losses.append(float(loss))  # waits for the step to finish
                        accs.append(float(acc))
                        count("sgl.task.host_sync", 2, kind="read")
                        weights.append(float(w.sum()))
                    t_end = time.perf_counter_ns()
                self.epoch_seconds.append((t_end - t) / 1e9)
                if train_span is not None:  # the span times what epoch_seconds does, on its clock reads
                    train_span["start_ns"], train_span["end_ns"] = t, t_end
                loss_train = float(np.average(losses, weights=weights))
                self.train_losses.append(loss_train)
                acc_train = float(np.average(accs, weights=weights))
                with span("sgl.task.eval"):
                    acc_val = eval_on(val_idx)
                    acc_test = eval_on(test_idx)
                if self._verbose:
                    print(
                        f"Epoch: {epoch + 1:03d} loss_train: {loss_train:.4f} "
                        f"acc_train: {acc_train:.4f} acc_val: {acc_val:.4f} "
                        f"acc_test: {acc_test:.4f} time: {(time.perf_counter_ns() - t) / 1e9:.4f}s"
                    )
                if acc_val > best_val:
                    best_val, best_test = acc_val, acc_test
                    self._on_best(net)

        with span("sgl.task.postprocess"):
            acc_val, acc_test = self._postprocess(net, labels, val_idx, test_idx)
        if acc_val > best_val:
            best_val, best_test = acc_val, acc_test

        if self._verbose:
            print("Optimization Finished!")
            print(f"Total time elapsed: {time.perf_counter() - t_total:.4f}s")
            print(f"Best val: {best_val:.4f}, best test: {best_test:.4f}")
        self.net = net
        return best_test

    def _on_best(self, net) -> None:
        """Called whenever the validation accuracy improves, with the net
        as it stands (subclasses keep best-epoch outputs)."""

    def _all_logits(self, net) -> torch.Tensor:
        """Every node's eval logits, in pieces of the eval batch."""
        ds, model = self._dataset, self._model
        if hasattr(model.processed_feature, "rows"):
            # a host hop store never enters the card whole: its rows go in
            # pieces of the eval batch (the logits are row-wise)
            all_idx = torch.arange(ds.num_node, device=self._device)
            logits = make_logits_fn(net)
            step = self._eval_batch_size or self._train_batch_size or ds.num_node
            return torch.cat([logits(model.batch_input(all_idx[i:i + step]))
                              for i in range(0, ds.num_node, step)])
        # every node's rows as cached, no gathered copy, inside the one call
        return make_logits_fn(net, self._eval_batch_size, model.row_dim)(model.processed_feature)

    def _postprocess(self, net, labels, val_idx, test_idx):
        ds, model, device = self._dataset, self._model, self._device
        final = model.postprocess(ds.graph, self._all_logits(net))
        pred = final.argmax(dim=1)

        def acc(idx):
            idx = torch.as_tensor(idx, device=device)
            return float((pred[idx] == labels[idx]).float().mean())

        return acc(val_idx), acc(test_idx)
