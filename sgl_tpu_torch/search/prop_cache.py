"""Cross-trial propagation cache for NAS — counterpart of
``sgl_tpu/search/prop_cache.py``.

Trials that share a graph, its features and a graph-op config (type, ``r``,
``alpha``) propagate the same linear operator and differ only in hop
count, so the cache makes propagation a search-wide resource:

* **hop-prefix reuse**: ``A^k x`` for ``k <= K_cached`` is a slice of the
  cached ``(K_cached+1, N, D)`` stack;
* **suffix extension**: a deeper request propagates from the cached last
  hop (``A^(c+j) x = A^j (A^c x)``), so the products of a whole search are
  those of one propagation to the deepest hop count asked for, per config.

On a hit the preprocess time handed to the NAS objective is the measured
seconds a hop times the hops, so deeper architectures still rank as
costlier.  Stacks stay on the device they were computed on; a stack's
time is read after a synchronize of that device (the counterpart of
``jax.block_until_ready``).  Memory: one ``(K_max+1, N, D)`` stack per
config; cap the entries with ``max_entries`` or turn the cache off with
``ConfigManager._setParameters(..., prop_cache=False)``.
"""

from __future__ import annotations

import copy
import hashlib
import time
import weakref
from typing import Any, Dict, Tuple

import numpy as np
import torch

from sgl_tpu_torch.device import resolve_device


def _op_config_key(op) -> Tuple:
    """The public scalar attributes of a graph op, hop count excluded
    (``prop_steps`` does not change the operator, only how often it runs).
    Arrays and tensors are keyed by content; any other value by its repr."""
    items = []
    for k, v in sorted(vars(op).items()):
        if k == "prop_steps" or k.startswith("_"):
            continue
        if isinstance(v, (int, float, str, bool, type(None))):
            items.append((k, v))
        elif isinstance(v, (np.ndarray, torch.Tensor)):
            # by content: a repr elides the middle of a large array
            if isinstance(v, torch.Tensor):
                t = v.detach().cpu()
                kind, shape, dtype = "tensor", tuple(t.shape), str(t.dtype)
                raw = t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
            else:
                kind, shape, dtype = "ndarray", v.shape, str(v.dtype)
                raw = np.ascontiguousarray(v).tobytes()
            items.append((k, kind, shape, dtype, hashlib.sha1(raw).hexdigest()))
        else:
            items.append((k, type(v).__name__, repr(v)))
    return (type(op).__name__, tuple(items))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PropagationCache:
    """Shares k-hop propagation stacks across NAS trials.

    ``hops_for(graph, x, op, dtype, device)`` returns ``(hops, est_seconds)``:
    ``hops`` the ``(op.prop_steps+1, N, D)`` stack equal to
    ``op.propagate(graph, x, device=device)`` (a prefix is a view of the
    cached stack; an extension runs the same products from the cached last
    hop), ``est_seconds`` the amortized preprocess time.
    """

    def __init__(self, max_entries: int = 8):
        self._entries: Dict[Tuple, Dict[str, Any]] = {}
        self._max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.hops_computed = 0

    def _key(self, graph, x, op, dtype, device) -> Tuple:
        # the identity of x is part of the key: preprocess takes any x, so
        # two calls on one graph may propagate different feature matrices
        return (id(graph), id(x), _op_config_key(op), str(dtype or torch.float32), str(device))

    def hops_for(self, graph, x, op, dtype=None, device=None) -> Tuple[torch.Tensor, float]:
        device = resolve_device(device)
        k = op.prop_steps
        key = self._key(graph, x, op, dtype, device)
        ent = self._entries.get(key)
        if ent is not None and (ent["graph_ref"]() is not graph or ent["x"] is not x):
            # the id was recycled after the old graph or x died: stale
            del self._entries[key]
            ent = None

        if ent is None:
            self.misses += 1
            xt = torch.as_tensor(x)
            if dtype is not None:
                xt = xt.to(dtype)
            t0 = time.perf_counter()
            hops = op.propagate(graph, xt, device=device)
            _sync(device)
            elapsed = time.perf_counter() - t0
            self.hops_computed += k
            if len(self._entries) >= self._max_entries:
                self._entries.pop(next(iter(self._entries)))
            self._entries[key] = {
                "graph_ref": weakref.ref(graph),
                # a strong reference: it guards against id recycling
                "x": x,
                # a copy of the op keeps its cached CSR for the extensions
                "op": copy.copy(op),
                "hops": hops,
                "per_hop_s": elapsed / max(k, 1),
            }
            return hops, elapsed

        self.hits += 1
        cached: torch.Tensor = ent["hops"]
        k_cached = int(cached.shape[0]) - 1
        if k <= k_cached:
            return cached[: k + 1], ent["per_hop_s"] * k

        # extend from the cached deepest hop; the extension's hop 0 is that hop
        ext = copy.copy(ent["op"])
        ext.prop_steps = k - k_cached
        t0 = time.perf_counter()
        more = ext.propagate(graph, cached[-1], device=device)
        hops = torch.cat([cached, more[1:]], dim=0)
        _sync(device)
        elapsed = time.perf_counter() - t0
        self.hops_computed += k - k_cached
        ent["op"] = ext
        ent["hops"] = hops
        ent["per_hop_s"] = (ent["per_hop_s"] * k_cached + elapsed) / k  # old and new, blended
        return hops, ent["per_hop_s"] * k
