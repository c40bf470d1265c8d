"""Data-parallel training over the ``data`` axis of a mesh.

Counterpart of ``sgl_tpu/parallel/train_dist.py``.  There one jitted step
runs under GSPMD with the batch rows sharded over ``data`` and XLA emits
the gradient psum.  Here each rank runs the step on its rows and the
gradients are summed over the ``data`` group by an explicit all-reduce,
with the two things that make one step equal the single-device
``make_train_step`` (``tasks/utils.py``):

* the loss is a weighted mean over the *whole* batch: each rank scales its
  own weighted mean by ``max(Σw_rank, 1) / max(Σw_all, 1)`` (the all-reduced
  weight sum), so the summed gradients are the gradient of the global loss,
  not a mean over ranks;
* each rank draws the dropout bits of the whole batch from the same
  generator state and keeps its own rows (``FastDropout.batch_rows``), as
  ``sgl_tpu`` keeps threefry for a partition-independent mask.

Batch norm would need statistics over the whole batch; a net with one
raises on a data axis of more than one rank.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from sgl_tpu_torch.models.blocks import FastDropout
from sgl_tpu_torch.parallel.mesh import all_reduce_, axis_size, broadcast_
from sgl_tpu_torch.tasks.utils import weighted_cross_entropy


def make_parallel_train_step(
    net: nn.Module,
    optimizer: torch.optim.Optimizer,
    mesh,
    loss_fn: Callable = weighted_cross_entropy,
    node_major_feats: bool = False,
):
    """``(step, shard_batch)``.

    ``shard_batch(feats, labels, w)`` takes this rank's rows of a batch that
    every rank holds whole (its length a multiple of the data axis; hop
    stacks ``(K, B, D)`` are split on dim 1 unless ``node_major_feats``).
    ``step(feats, labels, w, generator)`` is ``make_train_step``'s step on
    those rows: it returns the whole batch's loss and weighted accuracy, the
    same on every rank, and updates ``net`` in place, the same on every rank.
    ``loss_fn`` must be a weighted mean ``Σ ℓ·w / max(Σw, 1)``, as
    :func:`weighted_cross_entropy` is.  Batches split over the ``data``
    axis (``sgl_tpu``'s ``batch_axes`` default, the only one its callers
    use).
    """
    n_data = axis_size(mesh, "data")
    group = mesh.get_group("data")
    rank = mesh.get_local_rank("data")
    dropouts = [m for m in net.modules() if isinstance(m, FastDropout)]
    if n_data > 1 and any(isinstance(m, nn.modules.batchnorm._BatchNorm) for m in net.modules()):
        raise NotImplementedError(
            "batch norm in a data-parallel step needs statistics over the whole batch"
        )

    def batch_dim(feats) -> int:
        return 1 if feats.dim() == 3 and not node_major_feats else 0

    def rows(t, dim):
        size = t.shape[dim]
        if size % n_data:
            raise ValueError(f"batch of {size} rows does not split over {n_data} data ranks")
        per = size // n_data
        return t.narrow(dim, rank * per, per)

    def shard_batch(feats, labels, w):
        return rows(feats, batch_dim(feats)), rows(labels, 0), rows(w, 0)

    def step(feats, labels, w, generator: Optional[torch.Generator] = None):
        local = labels.shape[0]
        for m in dropouts:
            m.batch_rows = (local * n_data, rank * local, (rank + 1) * local)
        try:
            optimizer.zero_grad(set_to_none=True)
            logits = net(feats, train=True, generator=generator)
        finally:
            for m in dropouts:
                m.batch_rows = None
        w_sum = w.sum()
        w_all = all_reduce_(w_sum.detach().clone(), group)
        scale = w_sum.detach().clamp(min=1.0) / w_all.clamp(min=1.0)
        loss = loss_fn(logits, labels, w) * scale
        loss.backward()
        grads = [param.grad for param in net.parameters() if param.grad is not None]
        if n_data > 1 and grads:
            # one all-reduce of every gradient, flattened
            flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), group)
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
        optimizer.step()
        with torch.no_grad():
            hit = ((logits.argmax(dim=1) == labels).float() * w).sum()
            totals = all_reduce_(torch.stack([loss.detach(), hit]), group)
            return totals[0], totals[1] / w_all.clamp(min=1.0)

    return step, shard_batch


def replicate_state(net: nn.Module, mesh=None) -> nn.Module:
    """Broadcast ``net``'s parameters and buffers from global rank 0 to
    every rank; returns ``net``."""
    with torch.no_grad():
        for t in list(net.parameters()) + list(net.buffers()):
            broadcast_(t.data, 0)
    return net
