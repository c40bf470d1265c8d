"""SGAP model composition template — counterpart of ``sgl_tpu/models/base.py``.

* ``preprocess(graph)`` runs the training-free propagation once on the
  device and caches either the eagerly aggregated features (non-learnable
  message op; linear ones fuse into the propagation loop) or the stacked
  ``(K+1, N, D)`` hop tensor (learnable message op; ``(N, K+1, D)`` when
  ``node_major`` is set before it).  This is the reference's eager-vs-lazy
  split.
* ``net`` is the trainable stage: ``(learnable message op ∘) base model``,
  an ``nn.Module`` whose parameters the task's optimizer owns.
* ``batch_input(idx)`` slices the cached features for a node batch; a
  host hop store (``attach_host_hops``) serves its rows instead.
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
    """The trainable stage-2 network: (learnable msg op ∘) base model.

    ``node_major=True`` means batch features arrive as ``(B, K, D)`` and
    the message op reads them so (``supports_node_major``)."""

    def __init__(self, msg_op: Optional[MessageOp], base_model: nn.Module, node_major: bool = False):
        super().__init__()
        self.msg_op = msg_op  # None when aggregation was eager
        self.base_model = base_model
        self.node_major = node_major

    def forward(self, feats, train: bool = False, generator=None):
        h = feats
        if self.msg_op is not None:
            if self.node_major:
                h = self.msg_op(h, train=train, generator=generator, node_major=True)
            else:
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
        # node_major=True caches the hop stack as (N, K+1, D) and runs the
        # attention op in that layout; opt-in (set it before preprocess),
        # for a pre_msg_op with supports_node_major.  The default is
        # hop-major, as in sgl_tpu.
        self.node_major: bool = False
        self.processed_feature: Optional[torch.Tensor] = None  # (N, D') / (K+1, N, D) / (N, K+1, D)
        # set by preprocess(prop_cache=...): amortized preprocess seconds
        self.preprocess_time_estimate: Optional[float] = None

    # -- stage 1: pre-propagation (training-free) --------------------------
    def preprocess(self, graph: Graph, x=None, dtype=None, device=None, prop_cache=None) -> None:
        """Run the training-free propagation on ``device`` (default: the
        GPU) and cache the result.  ``dtype=torch.bfloat16`` runs the whole
        precompute in bf16 (the CSR kernel's bf16 variant; half the hop
        memory); the default keeps f32.  A host hop store attached by
        :meth:`attach_host_hops` is kept: it cannot be derived again here.

        ``prop_cache`` (a :class:`sgl_tpu_torch.search.prop_cache.
        PropagationCache`) shares the hop stack across models on the same
        graph, features and operator config, as NAS does; it sets
        :attr:`preprocess_time_estimate` (amortized seconds, for the NAS
        time objective).  The cache is keyed on the ``x`` object passed
        here, before any conversion."""
        if hasattr(self.processed_feature, "rows"):
            return
        if x is None:
            x = graph.x
        if prop_cache is not None and self.pre_graph_op is not None:
            hops, est = prop_cache.hops_for(graph, x, self.pre_graph_op, dtype=dtype, device=device)
            self.preprocess_time_estimate = est
            if self.pre_msg_learnable:
                self.processed_feature = hops.movedim(0, 1).contiguous() if self.node_major else hops
            else:
                # the stack is in the cache already, so the fused
                # propagate_aggregate saves nothing: aggregate it eagerly
                self.processed_feature = eager_aggregate(self.pre_msg_op, hops)
            return
        x = torch.as_tensor(x)
        if dtype is not None:
            x = x.to(dtype)
        if self.pre_graph_op is None:
            self.pre_msg_learnable = False
            self.processed_feature = x.to(resolve_device(device), dtype or torch.float32)
            return
        if self.pre_msg_learnable:
            hops = self.pre_graph_op.propagate(graph, x, device=device)
            if self.node_major:
                hops = hops.movedim(0, 1).contiguous()  # one-time (N, K+1, D)
            self.processed_feature = hops
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

    def attach_host_hops(self, host_hops) -> None:
        """Use a host-resident hop store (``utils.hop_store.HostHops``, e.g.
        the memmaps an out-of-core precompute wrote) as this model's feature
        cache: training then moves O(batch) rows a step and the stack never
        enters the card whole.  Non-learnable message ops aggregate each
        gathered batch on the card."""
        if host_hops.num_hops != self.prop_steps + 1:
            raise ValueError(
                f"store has {host_hops.num_hops} hops, model expects {self.prop_steps + 1}"
            )
        if not self.pre_msg_learnable and host_hops.agg is None:
            host_hops.agg = lambda stack: eager_aggregate(self.pre_msg_op, stack)
        self.processed_feature = host_hops

    # -- stage 2: training network -----------------------------------------
    @property
    def net(self) -> SGAPNet:
        return SGAPNet(
            msg_op=self.pre_msg_op if self.pre_msg_learnable else None,
            base_model=self.base_model,
            node_major=self.node_major,
        )

    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """(Re)initialize the trainable parameters from ``generator``."""
        init_params(self.net, generator)

    def batch_input(self, idx: torch.Tensor) -> torch.Tensor:
        """Slice cached features for a node-index batch (hop-major stacks
        along dim 1); a store with ``rows`` (a host hop store) gathers them."""
        if self.processed_feature is None:
            raise RuntimeError("call preprocess() before training")
        if hasattr(self.processed_feature, "rows"):
            feats = self.processed_feature.rows(idx)
            if self.pre_msg_learnable and self.node_major and feats.dim() == 3:
                feats = feats.movedim(0, 1)
            return feats
        idx = torch.as_tensor(idx, device=self.processed_feature.device)
        dim = 1 if self.pre_msg_learnable and not self.node_major else 0
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
