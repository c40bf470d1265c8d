"""Host-resident hop stacks for training beyond the card's memory.

Counterpart of ``sgl_tpu/utils/hop_store.py``.  At papers100M scale the
``(K+1, N, D)`` hop stack (~228 GB at K = 3, D = 128 f32) fits neither the
card nor, on one host, RAM.  The out-of-core precompute hands each hop to a
``hop_sink`` (``kernels/spmm_ooc.k_hop_out_of_core``); this module lets
training run from that store:

* :class:`MemmapHopSink` writes each hop to ``hop_<k>.npy``, so the
  precompute holds two hop matrices in host memory and the OS page cache
  manages the rest;
* :class:`HostHops` is the training-time view: ``rows(idx)`` gathers a
  batch's rows of every hop on the host into pinned memory and copies them
  to the card, so a step touches O(batch) rows and the stack never moves
  whole.

``SGAPModel.batch_input`` recognizes any store with ``rows``, so the tasks
run unchanged:

    sink = MemmapHopSink(path, num_nodes=n, feat_dim=d, prop_steps=k)
    op.propagate_out_of_core(graph, x, hop_sink=sink, layout="2d")
    model.attach_host_hops(sink.hops())
    NodeClassification(ds, model, ...)   # preprocess() keeps the store
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.graph.native import gather_rows
from sgl_tpu_torch.kernels.spmm_ooc import PinnedRing, _bits_dtype, _torch_dtype, host_bits


class HostHops:
    """A host-resident ``(K+1, N, D)`` hop stack, one array a hop: numpy
    float32 arrays or memmaps, CPU tensors of float32 or bfloat16, or, with
    ``dtype=torch.bfloat16``, numpy arrays of bf16 bits.

    ``rows(idx)`` lands on ``device`` (default: the GPU).  ``agg``
    (optional) is applied there to the gathered ``(K+1, B, D)`` batch:
    non-learnable message ops aggregate a batch at a time instead of an
    aggregated ``(N, D')`` matrix on the host.
    """

    def __init__(self, hops: Sequence, agg: Optional[Callable] = None, device=None,
                 dtype: Optional[torch.dtype] = None):
        if not len(hops):
            raise ValueError("empty hop list")
        views = [host_bits(h, dtype) for h in hops]
        self._hops = [v[0] for v in views]
        self.dtype = views[0][1]
        n, d = self._hops[0].shape
        for bits, dt in views:
            if bits.shape != (n, d) or dt != self.dtype:
                raise ValueError("hop shapes or dtypes disagree")
        self.agg = agg
        self.device = resolve_device(device)
        self._ring = PinnedRing() if self.device.type == "cuda" else None

    @property
    def num_nodes(self) -> int:
        return int(self._hops[0].shape[0])

    @property
    def num_hops(self) -> int:
        return len(self._hops)

    def rows(self, idx) -> torch.Tensor:
        """The batch's rows of every hop: ``(K+1, B, D)`` on the device
        (``agg``'s output when set).  On the card they are gathered into a
        pinned slot (reused only after its last copy completed) and copied
        with ``non_blocking=True`` on the current stream."""
        if isinstance(idx, torch.Tensor):
            idx = idx.cpu().numpy()
        idx = np.ascontiguousarray(idx, np.int32)
        shape = (self.num_hops, idx.shape[0], self._hops[0].shape[1])
        bits = _bits_dtype(self.dtype)
        if self._ring is None:
            host = torch.empty(shape, dtype=bits)
            out = host
        else:
            host, slot = self._ring.take(shape, bits)
        buf = host.numpy()
        for k, h in enumerate(self._hops):
            gather_rows(h, idx, out=buf[k])
        if self._ring is not None:
            out = host.to(self.device, non_blocking=True)
            self._ring.release(slot, torch.cuda.current_stream(self.device))
        out = out.view(self.dtype)
        if self.agg is not None:
            out = self.agg(out)
        return out


class MemmapHopSink:
    """A ``hop_sink`` writing hop ``k`` to ``<root>/hop_<k>.npy``.

    bf16 hops are stored as their 16-bit bits (``uint16``), as ``sgl_tpu``
    stores them: the ``.npy`` format has no bf16.  A hop already on disk is
    overwritten in place.
    """

    def __init__(self, root, num_nodes: int, feat_dim: int, prop_steps: int, dtype=torch.float32):
        self.root = str(root)
        self.num_nodes = num_nodes
        self.feat_dim = feat_dim
        self.prop_steps = prop_steps
        self.dtype = _torch_dtype(dtype)
        os.makedirs(self.root, exist_ok=True)

    def path(self, k: int) -> str:
        return os.path.join(self.root, f"hop_{k}.npy")

    def _storage_dtype(self) -> np.dtype:
        return np.dtype(np.uint16 if self.dtype == torch.bfloat16 else np.float32)

    def __call__(self, k: int, arr) -> None:
        bits, dtype = host_bits(arr)
        if dtype != self.dtype:
            bits, _ = host_bits(torch.from_numpy(np.array(bits)).view(dtype).to(self.dtype))
        storage = self._storage_dtype()
        mm = np.lib.format.open_memmap(self.path(k), mode="w+", dtype=storage,
                                       shape=(self.num_nodes, self.feat_dim))
        mm[:] = bits.view(storage)
        mm.flush()
        del mm

    def hops(self, agg: Optional[Callable] = None, device=None) -> HostHops:
        """The written hops, opened read-only (memmapped), as a
        :class:`HostHops` whose rows land on ``device``."""
        raw = [np.load(self.path(k), mmap_mode="r") for k in range(self.prop_steps + 1)]
        return HostHops(raw, agg=agg, device=device, dtype=self.dtype)
