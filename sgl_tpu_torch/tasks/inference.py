"""Serving: a predictor over precomputed features — counterpart of
``sgl_tpu/tasks/inference.py``.

The SGAP structure makes online prediction a gather of the precomputed
stage-1 features and a forward of the small trained net.  Requests are
padded to a bucket (a power of two from 8 to 65536), so the device sees a
handful of batch shapes whatever the request sizes; a request larger than
the largest bucket is served in pieces of that size.  ``save`` writes the
whole serving artifact to one file; ``load`` serves from it without the
graph.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sgl_tpu_torch.device import resolve_device

MIN_BUCKET, MAX_BUCKET = 8, 65536


def _bucket(n: int, min_bucket: int = MIN_BUCKET, max_bucket: int = MAX_BUCKET) -> int:
    """The smallest power-of-two multiple of ``min_bucket`` that holds
    ``n``, at most ``max_bucket``."""
    b = min_bucket
    while b < n and b < max_bucket:
        b *= 2
    return b


class Predictor:
    """Batched, bucket-padded node predictor.

    ``Predictor(model, net)`` after training (``model.preprocess`` has run
    and ``net`` is the trained ``model.net``); ``predict(node_ids)`` returns
    logits for any array of node ids, as numpy.
    """

    def __init__(self, model, net, apply_fn=None):
        if model.processed_feature is None:
            raise ValueError("the model has no precomputed features; run preprocess first")
        self._model = model
        self._net = net
        self._apply = apply_fn or (lambda feats: net(feats, train=False))

    @torch.no_grad()
    def predict(self, node_ids) -> np.ndarray:
        idx = np.asarray(node_ids).reshape(-1)
        device = self._model.processed_feature.device
        out = []
        for s in range(0, max(idx.shape[0], 1), MAX_BUCKET):
            piece = idx[s : s + MAX_BUCKET]
            n = piece.shape[0]
            padded = np.zeros(_bucket(n), np.int64)
            padded[:n] = piece
            feats = self._model.batch_input(torch.as_tensor(padded, device=device))
            out.append(self._apply(feats)[:n].float().cpu().numpy())
        return np.concatenate(out)

    def predict_proba(self, node_ids) -> np.ndarray:
        logits = self.predict(node_ids)
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    def save(self, path: str) -> None:
        """Write the serving artifact (the model's structure, the net's
        ``state_dict`` and the precomputed stage-1 features) to one file,
        atomically (a temporary file, then a rename).  The features and
        weights are stored as CPU tensors."""
        m = self._model
        ops = [op for op in (m.pre_graph_op, m.post_graph_op) if op is not None]
        saved = (m.processed_feature, [op._adj_cache for op in ops])
        blob = {
            "state_dict": {k: v.detach().cpu() for k, v in self._net.state_dict().items()},
            "features": m.processed_feature.cpu(),
        }
        # the model travels without its features and without the graph ops'
        # adjacency caches (a weak reference to the graph and a device CSR)
        m.processed_feature = None
        for op in ops:
            op._adj_cache = (None, None, None)
        try:
            blob["model"] = m
            tmp = path + ".tmp"
            torch.save(blob, tmp)
            os.replace(tmp, path)
        finally:
            m.processed_feature = saved[0]
            for op, cache in zip(ops, saved[1]):
                op._adj_cache = cache

    @classmethod
    def load(cls, path: str, device=None) -> "Predictor":
        """A predictor on ``device`` (default: the GPU) from a file written
        by :meth:`save`.  The file is a pickle: load only artifacts this
        package wrote."""
        device = resolve_device(device)
        blob = torch.load(path, map_location="cpu", weights_only=False)
        model = blob["model"]
        net = model.net
        net.load_state_dict(blob["state_dict"])
        net.to(device)
        model.processed_feature = blob["features"].to(device)
        return cls(model, net)


def predictor_from_task(task) -> Predictor:
    """A :class:`Predictor` from a finished task's model and final net."""
    net = getattr(task, "net", None)
    if net is None:
        raise ValueError("task exposes no trained net")
    return Predictor(task._model, net)
