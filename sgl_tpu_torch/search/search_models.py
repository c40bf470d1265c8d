"""Architecture vector → SGAP model — counterpart of
``sgl_tpu/search/search_models.py``.

The vector is ``[prop_steps, prop_type, msg_type, num_layers, post_steps,
post_type, post_msg_type]``, with ``sgl_tpu``'s dispatch tables: graph-op
types 1–4 (Laplacian, PPR with alpha 0.1, 0.2, 0.3), message types 0–8 and
post message types 0–5.  Type 8 (the learnable ``simple`` weights) gets
``prop_steps``, as in ``sgl_tpu`` (the reference passes ``feat_dim`` into
that slot).  The widths Flax infers come from ``feat_dim``: the gate of
type 7 reads ``feat_dim``, the concat of type 1 gives ``feat_dim·(K+1)``.
"""

from __future__ import annotations

from typing import Sequence

from sgl_tpu_torch.models.base import SGAPModel
from sgl_tpu_torch.models.blocks import LogisticRegression, ResMultiLayerPerceptron
from sgl_tpu_torch.ops.graph_ops import LaplacianGraphOp, PprGraphOp
from sgl_tpu_torch.ops.message_ops import (
    ConcatMessageOp,
    LastMessageOp,
    LearnableWeightedMessageOp,
    MaxMessageOp,
    MeanMessageOp,
    MinMessageOp,
    SimpleWeightedMessageOp,
    SumMessageOp,
)


def _graph_op(kind: int, steps: int):
    if kind == 1:
        return LaplacianGraphOp(steps, r=0.5)
    if kind == 2:
        return PprGraphOp(steps, r=0.5, alpha=0.1)
    if kind == 3:
        return PprGraphOp(steps, r=0.5, alpha=0.2)
    if kind == 4:
        return PprGraphOp(steps, r=0.5, alpha=0.3)
    raise ValueError(f"unknown graph op type {kind}")


def _pre_msg_op(kind: int, prop_steps: int, feat_dim: int):
    """``(message op, width it hands the base model)``."""
    k_all = prop_steps + 1
    if kind == 0:
        return LastMessageOp(), feat_dim
    if kind == 1:
        return ConcatMessageOp(start=0, end=k_all), feat_dim * k_all
    simple = {2: MeanMessageOp, 3: SumMessageOp, 4: MaxMessageOp, 5: MinMessageOp}
    if kind in simple:
        return simple[kind](start=0, end=k_all), feat_dim
    if kind == 6:
        return SimpleWeightedMessageOp(start=0, end=k_all, combination_type="alpha", alpha=0.85), feat_dim
    if kind == 7:
        return LearnableWeightedMessageOp(start=1, end=k_all, combination_type="gate", feat_dim=feat_dim), feat_dim
    if kind == 8:
        return LearnableWeightedMessageOp(start=1, end=k_all, combination_type="simple",
                                          prop_steps=prop_steps), feat_dim
    raise ValueError(f"unknown message op type {kind}")


def _post_msg_op(kind: int, post_steps: int):
    k_all = post_steps + 1
    if kind == 0:
        return LastMessageOp()
    simple = {1: MeanMessageOp, 2: SumMessageOp, 3: MaxMessageOp, 4: MinMessageOp}
    if kind in simple:
        return simple[kind](start=0, end=k_all)
    if kind == 5:
        return SimpleWeightedMessageOp(start=0, end=k_all, combination_type="alpha", alpha=0.85)
    raise ValueError(f"unknown post message op type {kind}")


class SearchModel(SGAPModel):
    def __init__(self, arch: Sequence[int], feat_dim: int, output_dim: int, hidden_dim: int):
        prop_steps, prop_types, mesg_types, num_layers, post_steps, post_types, pmsg_types = [
            int(a) for a in arch
        ]
        pre_graph_op = _graph_op(prop_types, prop_steps)
        pre_msg_op, in_dim = _pre_msg_op(mesg_types, prop_steps, feat_dim)
        if num_layers == 1:
            base_model = LogisticRegression(in_dim, output_dim)
        else:
            base_model = ResMultiLayerPerceptron(in_dim, hidden_dim, num_layers, output_dim)
        post_graph_op = post_msg_op = None
        if post_types != 0 and post_steps != 0:
            post_graph_op = _graph_op(post_types, post_steps)
            post_msg_op = _post_msg_op(pmsg_types, post_steps)
        super().__init__(
            prop_steps,
            in_dim,
            output_dim,
            pre_graph_op=pre_graph_op,
            pre_msg_op=pre_msg_op,
            base_model=base_model,
            post_graph_op=post_graph_op,
            post_msg_op=post_msg_op,
        )
        self.arch = tuple(int(a) for a in arch)
