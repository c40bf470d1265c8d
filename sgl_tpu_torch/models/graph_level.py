"""Graph-level SGAP models — counterpart of ``sgl_tpu/models/graph_level.py``:
propagate → aggregate hops → pool per graph → MLP.

The graph structure is touched only in the training-free precompute, which
runs once over the block-diagonal batch of all graphs (one CSR kernel
launch a hop for the whole dataset); training is a model over pooled
per-graph rows.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sgl_tpu_torch.graph.batch import GraphBatch
from sgl_tpu_torch.models.base import eager_aggregate
from sgl_tpu_torch.models.blocks import LogisticRegression, MultiLayerPerceptron, init_params
from sgl_tpu_torch.ops.graph_ops import GraphOp, LaplacianGraphOp
from sgl_tpu_torch.ops.message_ops import (
    LEARNABLE_AGGR_TYPES,
    ConcatMessageOp,
    LastMessageOp,
    MessageOp,
)

READOUTS = ("mean", "sum", "max")


def segment_readout(
    h: torch.Tensor,
    graph_ids: torch.Tensor,
    num_graphs: int,
    node_counts: torch.Tensor,
    kind: str = "mean",
) -> torch.Tensor:
    """Pool node rows ``(N, D)`` into per-graph rows ``(G, D)``, in
    ``h``'s dtype.  ``mean`` divides by the real node counts; ``max`` of a
    graph with no rows is ``-inf``, as ``jax.ops.segment_max`` gives."""
    if kind not in READOUTS:
        raise ValueError(f"unknown readout {kind!r}; choose from {READOUTS}")
    ids = graph_ids.long()
    if kind == "max":
        out = torch.full((num_graphs, h.shape[1]), float("-inf"), dtype=h.dtype, device=h.device)
        return out.scatter_reduce_(0, ids[:, None].expand_as(h), h, "amax", include_self=False)
    s = torch.zeros((num_graphs, h.shape[1]), dtype=h.dtype, device=h.device).index_add_(0, ids, h)
    if kind == "sum":
        return s
    return s / torch.clamp(node_counts[:, None], min=1).to(s.dtype)


class GraphReadoutNet(nn.Module):
    """Trainable stage: (learnable msg op ∘) per-graph readout ∘ base model.
    ``readout=None`` means the cached features are already pooled."""

    def __init__(self, msg_op: Optional[MessageOp], base_model: nn.Module, readout: Optional[str],
                 num_graphs: int = 0):
        super().__init__()
        self.msg_op = msg_op
        self.base_model = base_model
        self.readout = readout
        self.num_graphs = num_graphs

    def forward(self, feats, graph_ids=None, node_counts=None, train: bool = False, generator=None):
        h = feats
        if self.msg_op is not None:
            h = self.msg_op(h, train=train, generator=generator)
        if self.readout is not None:
            h = segment_readout(h, graph_ids, self.num_graphs, node_counts, self.readout)
        return self.base_model(h, train=train, generator=generator)


class GraphLevelSGAPModel:
    """SGAP composition for graph classification.

    ``preprocess(batch)`` propagates the block-diagonal batch once.  With a
    non-learnable message op the hop aggregation and the readout both fold
    into the precompute (the cached input is ``(G, D')``); a learnable op
    keeps the ``(K+1, N, D)`` hop stack and pools inside the train step.
    """

    def __init__(
        self,
        prop_steps: int,
        feat_dim: int,
        output_dim: int,
        *,
        readout: str = "mean",
        pre_graph_op: Optional[GraphOp] = None,
        pre_msg_op: Optional[MessageOp] = None,
        base_model: Optional[nn.Module] = None,
    ):
        if readout not in READOUTS:
            raise ValueError(f"unknown readout {readout!r}")
        self.prop_steps = prop_steps
        self.feat_dim = feat_dim
        self.output_dim = output_dim
        self.readout = readout
        self.pre_graph_op = pre_graph_op
        self.pre_msg_op = pre_msg_op
        self.base_model = base_model
        self.pre_msg_learnable: bool = bool(
            pre_msg_op is not None and pre_msg_op.aggr_type in LEARNABLE_AGGR_TYPES
        )
        self.processed_feature: Optional[torch.Tensor] = None
        self._batch: Optional[GraphBatch] = None
        self._ids: Optional[tuple] = None  # (graph_ids, node_counts) on the device

    def preprocess(self, batch: GraphBatch, dtype=None, device=None) -> None:
        """Propagate the batch on ``device`` (default: the GPU) and cache.
        ``dtype=torch.bfloat16`` runs the precompute in bf16 (the CSR
        kernel's bf16 variant)."""
        self._batch = batch
        x = torch.as_tensor(batch.graph.x)
        if dtype is not None:
            x = x.to(dtype)
        hops = self.pre_graph_op.propagate(batch.graph, x, device=device)
        dev = hops.device
        self._ids = (
            torch.as_tensor(batch.graph_ids, device=dev),
            torch.as_tensor(batch.node_counts, device=dev),
        )
        if self.pre_msg_learnable:
            self.processed_feature = hops  # (K+1, N, D)
            return
        h = eager_aggregate(self.pre_msg_op, hops)  # (N, D')
        del hops
        gids, counts = self._ids
        self.processed_feature = segment_readout(h, gids, batch.num_graphs, counts, self.readout)  # (G, D')

    @property
    def net(self) -> GraphReadoutNet:
        if self.pre_msg_learnable:
            return GraphReadoutNet(self.pre_msg_op, self.base_model, self.readout, self._batch.num_graphs)
        return GraphReadoutNet(None, self.base_model, None)

    def net_inputs(self):
        """``(feats, graph_ids, node_counts)`` for a full-batch step: the
        pooled ``(G, D')`` cache (ids None), or the hop stack and the
        segment ids."""
        if self.processed_feature is None:
            raise RuntimeError("call preprocess() before training")
        if self.pre_msg_learnable:
            return (self.processed_feature, *self._ids)
        return self.processed_feature, None, None

    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """(Re)initialize the trainable parameters from ``generator``."""
        init_params(self.net, generator)


class GraphSGC(GraphLevelSGAPModel):
    """SGC for graphs: Laplacian propagation, last hop, readout, LogReg."""

    def __init__(self, prop_steps, feat_dim, output_dim, readout="mean", r=0.5):
        super().__init__(
            prop_steps,
            feat_dim,
            output_dim,
            readout=readout,
            pre_graph_op=LaplacianGraphOp(prop_steps, r=r),
            pre_msg_op=LastMessageOp(),
            base_model=LogisticRegression(feat_dim, output_dim),
        )


class GraphSIGN(GraphLevelSGAPModel):
    """SIGN for graphs: concat all hops, readout, MLP((K+1)·D)."""

    def __init__(self, prop_steps, feat_dim, output_dim, hidden_dim=64, num_layers=2, readout="mean",
                 r=0.5):
        super().__init__(
            prop_steps,
            feat_dim,
            output_dim,
            readout=readout,
            pre_graph_op=LaplacianGraphOp(prop_steps, r=r),
            pre_msg_op=ConcatMessageOp(start=0, end=prop_steps + 1),
            base_model=MultiLayerPerceptron((prop_steps + 1) * feat_dim, hidden_dim, num_layers, output_dim),
        )
