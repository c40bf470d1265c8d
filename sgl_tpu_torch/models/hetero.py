"""Heterogeneous (NARS) SGAP models — counterpart of ``sgl_tpu/models/hetero.py``.

NARS samples relation-subset subgraphs, propagates the features over each
and learns per-subgraph weights.  Every subgraph's prediction-class rows
have the same ``(K+1, N_pred, D)`` shape, so the precompute is one
``(K+1, S, N_pred, D)`` tensor on the device, and the aggregators are
broadcasts and a matmul.  The S subgraphs are propagated in ONE pass over
their block-diagonal batch (one CSR kernel launch a hop); block-diagonal
symmetric normalization equals per-block normalization.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from sgl_tpu_torch.graph.batch import batch_graphs
from sgl_tpu_torch.models.blocks import (
    FastOneDimConvolution,
    MultiLayerPerceptron,
    OneDimConvolution,
    init_params,
)
from sgl_tpu_torch.ops.graph_ops import GraphOp, LaplacianGraphOp
from sgl_tpu_torch.ops.message_ops import (
    LEARNABLE_AGGR_TYPES,
    MessageOp,
    ProjectedConcatMessageOp,
)


class HeteroSGAPNet(nn.Module):
    """Trainable stage: subgraph aggregator → message op → base model.
    Input ``(K+1, S, B, D)``."""

    def __init__(self, aggregator: nn.Module, msg_op: Optional[MessageOp], base_model: nn.Module):
        super().__init__()
        self.aggregator = aggregator
        self.msg_op = msg_op
        self.base_model = base_model

    def forward(self, feats, train: bool = False, generator=None):
        agg = self.aggregator(feats.permute(0, 2, 3, 1))  # (K+1, B, D, S) -> (K+1, B, D)
        if self.msg_op is not None:
            if self.msg_op.aggr_type in LEARNABLE_AGGR_TYPES:
                agg = self.msg_op(agg, train=train, generator=generator)
            else:
                agg = self.msg_op(agg)
        return self.base_model(agg, train=train, generator=generator)


class FastHeteroSGAPNet(nn.Module):
    """Fast stage: one matmul over packed ``(B, D, S·(K+1))`` features,
    then the base model."""

    def __init__(self, aggregator: nn.Module, base_model: nn.Module):
        super().__init__()
        self.aggregator = aggregator
        self.base_model = base_model

    def forward(self, feats, train: bool = False, generator=None):
        return self.base_model(self.aggregator(feats), train=train, generator=generator)


class _HeteroPreprocessMixin:
    """Shared NARS preprocessing (relation subsets, one propagation of their
    block-diagonal batch, the prediction-class rows of each subgraph) and
    the parts both templates share."""

    pre_graph_op: GraphOp

    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """(Re)initialize the trainable parameters from ``generator``."""
        init_params(self.net, generator)

    def apply(self, idx, train: bool = False, generator=None) -> torch.Tensor:
        return self.net(self.batch_input(idx), train=train, generator=generator)

    def postprocess(self, graph, logits):
        return logits

    def _propagate_subgraphs(
        self,
        dataset,
        predict_class: str,
        random_subgraph_num: int = -1,
        subgraph_edge_type_num: int = -1,
        subgraph_list=None,
        seed: int = 42,
        device=None,
    ) -> torch.Tensor:
        if subgraph_list is None and (random_subgraph_num == -1 or subgraph_edge_type_num == -1):
            raise ValueError(
                "Either subgraph_list or (random_subgraph_num, "
                "subgraph_edge_type_num) should be provided!"
            )
        if subgraph_list is not None and (random_subgraph_num != -1 or subgraph_edge_type_num != -1):
            raise ValueError(
                "subgraph_list is provided, random_subgraph_num and "
                "subgraph_edge_type_num will be ignored!"
            )
        if predict_class not in dataset.node_types:
            raise ValueError("Please input valid node class for prediction!")

        t0 = time.perf_counter()
        if subgraph_list is None:
            subgraph_dict = dataset.nars_preprocess(
                dataset.edge_types, predict_class, random_subgraph_num, subgraph_edge_type_num,
                seed=seed,
            )
            subgraph_list = list(subgraph_dict.items())

        hg = dataset.data
        predict_start = hg.offset[predict_class]
        n_pred = hg.num_node[predict_class]
        kept = []
        for key, value in subgraph_list:
            endpoints = set()
            for et in key:
                parts = et.split("__")
                endpoints.update((parts[0], parts[-1]))
            if predict_class in endpoints:
                kept.append(value)
        if not kept:
            raise ValueError("no sampled subgraph touches the predict class")
        self.subgraph_keys = [key for key, _ in subgraph_list]
        batch = batch_graphs([g.replace(x=np.asarray(f)) for g, f, _ in kept])
        #: host seconds of the relation subsets, their subgraphs and the batch
        self.sampling_seconds = time.perf_counter() - t0

        hops = self.pre_graph_op.propagate(batch.graph, batch.graph.x, device=device)
        # the batch graph is not reused: drop its cached CSR with the hops
        self.pre_graph_op.clear_cache()
        offsets = np.concatenate([[0], np.cumsum(batch.node_counts)])
        per_subgraph = []
        for (_, _, node_id), off in zip(kept, offsets[:-1]):
            # node ids are sorted by global id: each type is one block
            start = int(off) + int(np.searchsorted(np.asarray(node_id), predict_start))
            per_subgraph.append(hops[:, start : start + n_pred, :])
        return torch.stack(per_subgraph, dim=1)  # (K+1, S, N_pred, D)


class HeteroSGAPModel(_HeteroPreprocessMixin):
    """The NARS template: per-hop subgraph aggregator, message op, base
    model; ``processed_feature`` is ``(K+1, S, N_pred, D)``."""

    def __init__(
        self,
        prop_steps: int,
        feat_dim: int,
        output_dim: int,
        *,
        pre_graph_op: GraphOp,
        pre_msg_op: Optional[MessageOp],
        aggregator: nn.Module,
        base_model: nn.Module,
    ):
        self.prop_steps = prop_steps
        self.feat_dim = feat_dim
        self.output_dim = output_dim
        self.pre_graph_op = pre_graph_op
        self.pre_msg_op = pre_msg_op
        self.aggregator = aggregator
        self.base_model = base_model
        self.processed_feature: Optional[torch.Tensor] = None

    def preprocess(self, dataset, predict_class: str, device=None, **kw) -> None:
        """Sample, propagate on ``device`` (default: the GPU) and cache."""
        self.processed_feature = self._propagate_subgraphs(dataset, predict_class, device=device, **kw)

    @property
    def net(self) -> HeteroSGAPNet:
        return HeteroSGAPNet(self.aggregator, self.pre_msg_op, self.base_model)

    def batch_input(self, idx: torch.Tensor) -> torch.Tensor:
        idx = torch.as_tensor(idx, device=self.processed_feature.device)
        return self.processed_feature.index_select(2, idx)


class FastHeteroSGAPModel(_HeteroPreprocessMixin):
    """The packed NARS template: features flattened to ``(N, D, S·(K+1))``,
    subgraph-major, for a one-matmul aggregator."""

    def __init__(
        self,
        prop_steps: int,
        feat_dim: int,
        output_dim: int,
        *,
        pre_graph_op: GraphOp,
        aggregator: nn.Module,
        base_model: nn.Module,
    ):
        self.prop_steps = prop_steps
        self.feat_dim = feat_dim
        self.output_dim = output_dim
        self.pre_graph_op = pre_graph_op
        self.aggregator = aggregator
        self.base_model = base_model
        self.processed_feature: Optional[torch.Tensor] = None

    def preprocess(self, dataset, predict_class: str, device=None, **kw) -> None:
        """Sample, propagate on ``device`` (default: the GPU), pack and cache."""
        hops = self._propagate_subgraphs(dataset, predict_class, device=device, **kw)
        k1, s, n, d = hops.shape
        # (K+1, S, N, D) -> (N, D, S, K+1) -> (N, D, S*(K+1)), subgraph-major
        self.processed_feature = hops.permute(2, 3, 1, 0).reshape(n, d, s * k1)
        self.num_subgraphs = s

    @property
    def net(self) -> FastHeteroSGAPNet:
        return FastHeteroSGAPNet(self.aggregator, self.base_model)

    def batch_input(self, idx: torch.Tensor) -> torch.Tensor:
        idx = torch.as_tensor(idx, device=self.processed_feature.device)
        return self.processed_feature.index_select(0, idx)

    def subgraph_weight(self) -> np.ndarray:
        """Each subgraph's learned weight, summed over its hops: ``(S,)``."""
        return self.aggregator.subgraph_weight().cpu().numpy()


class NARS_SIGN(HeteroSGAPModel):  # noqa: N801
    """Laplacian / ProjectedConcat / OneDimConvolution + MLP."""

    def __init__(
        self,
        prop_steps: int,
        feat_dim: int,
        output_dim: int,
        hidden_dim: int,
        num_layers: int,
        random_subgraph_num: int,
    ):
        super().__init__(
            prop_steps,
            feat_dim,
            output_dim,
            pre_graph_op=LaplacianGraphOp(prop_steps, r=0.5),
            pre_msg_op=ProjectedConcatMessageOp(
                start=0, end=prop_steps + 1, hidden_dim=hidden_dim, num_layers=num_layers,
                feat_dim=feat_dim,
            ),
            aggregator=OneDimConvolution(random_subgraph_num, prop_steps + 1, feat_dim),
            base_model=MultiLayerPerceptron(
                (prop_steps + 1) * hidden_dim, hidden_dim, num_layers, output_dim
            ),
        )


class Fast_NARS_SGC_WithLearnableWeights(FastHeteroSGAPModel):  # noqa: N801
    """One learnable weight per (subgraph, hop) + MLP."""

    def __init__(
        self,
        prop_steps: int,
        feat_dim: int,
        output_dim: int,
        hidden_dim: int,
        num_layers: int,
        random_subgraph_num: int,
    ):
        super().__init__(
            prop_steps,
            feat_dim,
            output_dim,
            pre_graph_op=LaplacianGraphOp(prop_steps, r=0.5),
            aggregator=FastOneDimConvolution(random_subgraph_num, prop_steps + 1),
            base_model=MultiLayerPerceptron(feat_dim, hidden_dim, num_layers, output_dim),
        )
