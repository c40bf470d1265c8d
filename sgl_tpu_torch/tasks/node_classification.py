"""Node classification task — counterpart of
``sgl_tpu/tasks/node_classification.py``.

Same UX: ``NodeClassification(dataset, model, lr, wd, epochs)`` runs the
whole task in its constructor — preprocessing, training with best-val
bookkeeping, post-processing — and exposes ``.test_acc``.  It runs on the
GPU unless ``device="cpu"`` is passed, and raises when no GPU is present.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

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
from sgl_tpu_torch.utils.transfer import to_device_nonblocking


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _take(x, pos, s: int, size: int):
    """Entries ``s`` to ``s + size`` of ``x`` in a batch order (a numpy
    array or a tensor): ``x[pos[s:s + size]]`` where ``pos`` holds the
    order's positions, else ``x[s:s + size]`` with a short tail wrapped to
    ``x``'s first entries, as ``batch_iterator`` wraps it."""
    if pos is not None:
        return x[pos[s:s + size]]
    pad = s + size - len(x)
    if pad <= 0:
        return x[s:s + size]
    return (torch.cat if isinstance(x, torch.Tensor) else np.concatenate)([x[s:], x[:pad]])


def _order(n: int, batch_size: Optional[int], rng, device: torch.device):
    """A shuffled epoch's order of ``n`` rows for :func:`_batches`:
    ``(positions on the device, positions on the host)``, every batch's
    positions end to end as ``batch_iterator`` over ``arange(n)`` gives
    them (its one draw from ``rng``), sent in one copy that does not wait
    (``to_device_nonblocking``).  None for one batch, which takes the rows
    in order and for which ``batch_iterator`` draws nothing."""
    if batch_size is None or batch_size >= n:
        return None
    host = np.concatenate([p for p, _ in batch_iterator(np.arange(n), batch_size, True, rng)])
    return to_device_nonblocking(host, device), host


def _batches(idx: torch.Tensor, batch_size: Optional[int], order=None, host_idx=None):
    """The batches of ``batch_iterator`` over a split's indices ``idx`` (a
    tensor) in ``order`` (:func:`_order`'s; None: in order), built where
    ``idx`` lives, each inside a ``sgl.task.batch`` span, with nothing read
    back: yields ``(indices, weights, kept, feature indices)``, ``kept``
    the rows that are no wrapped duplicates (the weights' sum).  The
    feature indices are ``indices``, or with ``host_idx`` (``idx`` on the
    host, for a host hop store, whose ``rows`` gathers on the host) that
    batch of ``host_idx``."""
    n = len(idx)
    size = n if batch_size is None or batch_size >= n else batch_size
    pos, host_pos = order or (None, None)
    # an empty split is one empty batch, as batch_iterator yields it
    for s in range(0, max(n, 1), max(size, 1)):
        with span("sgl.task.batch"):
            kept = min(size, n - s)
            b = _take(idx, pos, s, size)
            w = torch.ones(size, device=idx.device)
            if kept < size:
                w[kept:] = 0.0
            fb = b if host_idx is None else _take(host_idx, host_pos, s, size)
        yield b, w, kept, fb


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
        #: wall seconds of each epoch's training steps, ended by the read of
        #: their losses, which waits for the card's work
        self.epoch_seconds: List[float] = []
        #: each epoch's mean training loss (weighted by the batches' rows)
        self.train_losses: List[float] = []
        #: each epoch's (train, validation, test) accuracy
        self.epoch_accuracies: List[Tuple[float, float, float]] = []
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

        # the split's indices go to the device once a job; its batches are
        # built there and the steps' results read twice an epoch
        split = ds.to_device(device)
        labels = split.y
        train_idx = np.asarray(ds.train_idx)
        val_idx = np.asarray(ds.val_idx)
        test_idx = np.asarray(ds.test_idx)
        # a host hop store gathers its rows on the host, from host indices
        host_rows = hasattr(model.processed_feature, "rows")

        def train_order():
            return _order(len(train_idx), self._train_batch_size, np_rng, device)

        net = model.net.cpu()
        model.init(init_gen)
        net.to(device)
        optimizer = adam_l2(net.parameters(), self._lr, self._weight_decay)
        train_step = make_train_step(net, optimizer, self._loss_fn)
        eval_step = make_eval_step(net)

        def train_steps(order):
            """The epoch's steps in ``order``; returns their losses,
            accuracies and kept rows, the first two read in one copy after
            the last step."""
            steps, kept_rows = [], []
            for b, w, kept, fb in _batches(split.train_idx, self._train_batch_size, order,
                                           train_idx if host_rows else None):
                steps.append(train_step(model.batch_input(fb), labels[b], w, dropout_gen))
                kept_rows.append(float(kept))
            losses, accs = zip(*steps)
            losses, accs = torch.stack(losses + accs).view(2, -1).tolist()  # waits for the steps
            count("sgl.task.host_sync", kind="read")
            return losses, accs, kept_rows

        def eval_sums(idx, host_idx):
            """The split's hits and weights, summed on the device (whole
            numbers, exact in f64)."""
            hits, weights = [], []
            for b, w, _, fb in _batches(idx, self._eval_batch_size, None, host_idx if host_rows else None):
                c, t = eval_step(model.batch_input(fb), labels[b], w)
                hits.append(c)
                weights.append(t)
            return torch.stack(hits).double().sum(), torch.stack(weights).double().sum()

        best_val, best_test = 0.0, 0.0
        t_total = time.perf_counter()
        order = train_order()
        for epoch in range(self._epochs):
            with span("sgl.task.epoch"):
                with span("sgl.task.train") as train_span:
                    t = time.perf_counter_ns()
                    losses, accs, weights = train_steps(order)
                    t_end = time.perf_counter_ns()
                self.epoch_seconds.append((t_end - t) / 1e9)
                if train_span is not None:  # the span times what epoch_seconds does, on its clock reads
                    train_span["start_ns"], train_span["end_ns"] = t, t_end
                loss_train = float(np.average(losses, weights=weights))
                self.train_losses.append(loss_train)
                acc_train = float(np.average(accs, weights=weights))
                with span("sgl.task.eval"):
                    sums = torch.stack([*eval_sums(split.val_idx, val_idx), *eval_sums(split.test_idx, test_idx)])
                    if epoch + 1 < self._epochs:
                        # drawn while the card runs the eval, which draws
                        # nothing: the draws keep their order
                        order = train_order()
                    c_val, t_val, c_test, t_test = sums.tolist()
                    count("sgl.task.host_sync", kind="read")
                acc_val, acc_test = c_val / max(t_val, 1.0), c_test / max(t_test, 1.0)
                self.epoch_accuracies.append((acc_train, acc_val, acc_test))
                if self._verbose:
                    print(
                        f"Epoch: {epoch + 1:03d} loss_train: {loss_train:.4f} "
                        f"acc_train: {acc_train:.4f} acc_val: {acc_val:.4f} "
                        f"acc_test: {acc_test:.4f} time: {(time.perf_counter_ns() - t) / 1e9:.4f}s"
                    )
                if acc_val > best_val:
                    best_val, best_test = acc_val, acc_test
                    self._on_best(net)

        del split  # the indices leave the card before the postprocess
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
