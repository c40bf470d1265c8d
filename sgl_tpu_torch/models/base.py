"""SGAP model composition template — counterpart of ``sgl_tpu/models/base.py``.

* ``preprocess(graph)`` runs the training-free propagation once on the
  device and caches either the eagerly aggregated features (non-learnable
  message op; linear ones fuse into the propagation loop) or the stacked
  ``(K+1, N, D)`` hop tensor (learnable message op).  This is the
  reference's eager-vs-lazy split.
* ``net`` is the trainable stage: ``(learnable message op ∘) base model``,
  an ``nn.Module`` whose parameters the task's optimizer owns.
* ``batch_input(idx)`` slices the cached features for a node batch.
* ``postprocess(graph, logits)`` is softmax → propagate → aggregate.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.graph.graph import Graph
from sgl_tpu_torch.models.blocks import init_params
from sgl_tpu_torch.ops.graph_ops import GraphOp
from sgl_tpu_torch.ops.message_ops import LEARNABLE_AGGR_TYPES, MessageOp


class SGAPNet(nn.Module):
    """The trainable stage-2 network: (learnable msg op ∘) base model."""

    def __init__(self, msg_op: Optional[MessageOp], base_model: nn.Module):
        super().__init__()
        self.msg_op = msg_op  # None when aggregation was eager
        self.base_model = base_model

    def forward(self, feats, train: bool = False, generator=None):
        h = feats
        if self.msg_op is not None:
            h = self.msg_op(h, train=train, generator=generator)
        return self.base_model(h, train=train, generator=generator)


def eager_aggregate(op: MessageOp, hops: torch.Tensor) -> torch.Tensor:
    """Apply a parameter-free message op to a hop stack."""
    return op(hops)


class SGAPModel:
    """Composable SGAP model: pre graph-op, pre message-op, base net,
    optional post graph-op + message-op."""

    def __init__(
        self,
        prop_steps: int,
        feat_dim: int,
        output_dim: int,
        *,
        pre_graph_op: Optional[GraphOp] = None,
        pre_msg_op: Optional[MessageOp] = None,
        base_model: Optional[nn.Module] = None,
        post_graph_op: Optional[GraphOp] = None,
        post_msg_op: Optional[MessageOp] = None,
    ):
        self.prop_steps = prop_steps
        self.feat_dim = feat_dim
        self.output_dim = output_dim
        self.pre_graph_op = pre_graph_op
        self.pre_msg_op = pre_msg_op
        self.base_model = base_model
        self.post_graph_op = post_graph_op
        self.post_msg_op = post_msg_op
        self.pre_msg_learnable: bool = bool(
            pre_msg_op is not None and pre_msg_op.aggr_type in LEARNABLE_AGGR_TYPES
        )
        self.processed_feature: Optional[torch.Tensor] = None  # (N, D') or (K+1, N, D)

    # -- stage 1: pre-propagation (training-free) --------------------------
    def preprocess(self, graph: Graph, x=None, dtype=None, device=None) -> None:
        """Run the training-free propagation on ``device`` (default: the
        GPU) and cache the result.  ``dtype=torch.bfloat16`` runs the whole
        precompute in bf16 (the CSR kernel's bf16 variant; half the hop
        memory); the default keeps f32."""
        if x is None:
            x = graph.x
        x = torch.as_tensor(x)
        if dtype is not None:
            x = x.to(dtype)
        if self.pre_graph_op is None:
            self.pre_msg_learnable = False
            self.processed_feature = x.to(resolve_device(device), dtype or torch.float32)
            return
        if self.pre_msg_learnable:
            self.processed_feature = self.pre_graph_op.propagate(graph, x, device=device)
            return
        # linear aggregations fuse into the propagation loop: peak memory
        # O(N·D) instead of O((K+1)·N·D)
        w = self.pre_msg_op.linear_weights(self.pre_graph_op.prop_steps + 1)
        if w is not None:
            self.processed_feature = self.pre_graph_op.propagate_aggregate(
                graph, x, w, device=device
            )
        else:
            hops = self.pre_graph_op.propagate(graph, x, device=device)
            self.processed_feature = eager_aggregate(self.pre_msg_op, hops)

    # -- stage 2: training network -----------------------------------------
    @property
    def net(self) -> SGAPNet:
        return SGAPNet(
            msg_op=self.pre_msg_op if self.pre_msg_learnable else None,
            base_model=self.base_model,
        )

    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """(Re)initialize the trainable parameters from ``generator``."""
        init_params(self.net, generator)

    def batch_input(self, idx: torch.Tensor) -> torch.Tensor:
        """Slice cached features for a node-index batch (hop-major stacks
        along dim 1)."""
        if self.processed_feature is None:
            raise RuntimeError("call preprocess() before training")
        idx = torch.as_tensor(idx, device=self.processed_feature.device)
        dim = 1 if self.pre_msg_learnable else 0
        return self.processed_feature.index_select(dim, idx)

    def apply(self, idx, train: bool = False, generator=None) -> torch.Tensor:
        return self.net(self.batch_input(idx), train=train, generator=generator)

    # -- stage 3: post-propagation (training-free) --------------------------
    def postprocess(self, graph: Graph, logits: torch.Tensor) -> torch.Tensor:
        if self.post_graph_op is None:
            return logits
        if self.post_msg_op.aggr_type in LEARNABLE_AGGR_TYPES:
            raise ValueError(
                "Learnable weighted message operator is not supported in the "
                "post-processing phase!"
            )
        probs = torch.softmax(logits, dim=1)
        hops = self.post_graph_op.propagate(graph, probs, device=logits.device)
        return eager_aggregate(self.post_msg_op, hops)
