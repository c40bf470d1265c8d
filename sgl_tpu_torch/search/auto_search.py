"""The NAS inner loop — counterpart of ``sgl_tpu/search/auto_search.py``.

:class:`SearchManager` trains one candidate architecture full-batch with
restarts, keeps the parameters of the best validation epoch (on disk too
with ``checkpoint_path``: ``torch.save`` of the net's ``state_dict``) and
returns the NAS objective pair ``(best_test_acc, preprocess seconds +
forward seconds)``.  The restarts continue the same parameters and
optimizer, as ``sgl_tpu``'s loop does.  Both clocks are read after a
synchronize of the device, so the card's asynchronous launches are counted.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.search.base_search import BaseSearch
from sgl_tpu_torch.tasks.utils import adam_l2, make_eval_step, make_logits_fn, make_train_step, set_seed


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SearchManager(BaseSearch):
    def __init__(
        self,
        dataset,
        model,
        lr: float,
        weight_decay: float,
        epochs: int,
        device=None,
        seed: int = 42,
        restarts: int = 10,
        checkpoint_path: Optional[str] = None,
        prop_cache=None,
        verbose: bool = False,
    ):
        super().__init__()
        self._dataset = dataset
        self._model = model
        self._lr = lr
        self._weight_decay = weight_decay
        self._epochs = epochs
        self._device = resolve_device(device)
        self._seed = seed
        self._restarts = restarts
        self._checkpoint_path = checkpoint_path
        self._prop_cache = prop_cache
        self._verbose = verbose
        #: each step's training loss
        self.train_losses: list = []

    def _execute(self):
        ds, model, device = self._dataset, self._model, self._device
        # parameters are drawn on the CPU, so every device starts from the
        # same weights; dropout draws from a generator on the device
        init_gen = set_seed(self._seed)
        dropout_gen = torch.Generator(device=device).manual_seed(self._seed)

        t0 = time.perf_counter()
        model.preprocess(ds.graph, ds.x, device=device, prop_cache=self._prop_cache)
        _sync(device)
        if self._prop_cache is not None and model.preprocess_time_estimate is not None:
            # a cache hit skips the products: the cache's amortized seconds
            # a hop keep the time objective honest
            time_preprocess = model.preprocess_time_estimate
        else:
            time_preprocess = time.perf_counter() - t0

        split = ds.to_device(device)
        labels = split.y
        net = model.net.cpu()
        model.init(init_gen)
        net.to(device)
        optimizer = adam_l2(net.parameters(), self._lr, self._weight_decay)
        train_step = make_train_step(net, optimizer)
        eval_step = make_eval_step(net)

        tr_feats = model.batch_input(split.train_idx)
        va_feats = model.batch_input(split.val_idx)
        te_feats = model.batch_input(split.test_idx)
        tr_y, va_y, te_y = labels[split.train_idx], labels[split.val_idx], labels[split.test_idx]
        tr_w, va_w, te_w = (torch.ones(i.shape[0], device=device)
                            for i in (split.train_idx, split.val_idx, split.test_idx))

        best_val, best_test = 0.0, 0.0
        best_state = self._snapshot(net)
        for _ in range(self._restarts):
            for _ in range(self._epochs):
                loss, _ = train_step(tr_feats, tr_y, tr_w, dropout_gen)
                cv, tv = eval_step(va_feats, va_y, va_w)
                ct, tt = eval_step(te_feats, te_y, te_w)
                acc_val = float(cv) / float(tv)
                acc_test = float(ct) / float(tt)
                self.train_losses.append(float(loss))
                if acc_val > best_val:
                    best_val, best_test = acc_val, acc_test
                    best_state = self._snapshot(net)
                    if self._checkpoint_path:
                        self._save(best_state)

        acc_val, acc_test, time_forward = self._postprocess(net, best_state, labels, split)
        if acc_val > best_val:
            best_val, best_test = acc_val, acc_test
        if self._verbose:
            print(f"Best val: {best_val:.4f}, best test: {best_test:.4f}")
        return best_test, time_preprocess + time_forward

    @staticmethod
    def _snapshot(net) -> dict:
        return {k: v.detach().clone() for k, v in net.state_dict().items()}

    def _postprocess(self, net, state, labels, split):
        """The full-graph forward with ``state``'s parameters, then the
        post-propagation; the forward seconds end with a synchronize."""
        ds, model, device = self._dataset, self._model, self._device
        net.load_state_dict(state)
        logits_fn = make_logits_fn(net)
        _sync(device)
        t0 = time.perf_counter()
        output = logits_fn(model.batch_input(torch.arange(ds.num_node, device=device)))
        final = model.postprocess(ds.graph, output)
        _sync(device)
        time_forward = time.perf_counter() - t0
        pred = final.argmax(dim=1)

        def acc(idx):
            return float((pred[idx] == labels[idx]).float().mean())

        return acc(split.val_idx), acc(split.test_idx), time_forward

    def _save(self, state) -> None:
        path = self._checkpoint_path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save(state, path)
