"""Homogeneous SGAP models — counterpart of ``sgl_tpu/models/homo.py``
(this slice: SGC and GAMLP)."""

from __future__ import annotations

from sgl_tpu_torch.models.base import SGAPModel
from sgl_tpu_torch.models.blocks import LogisticRegression, MultiLayerPerceptron
from sgl_tpu_torch.ops.graph_ops import LaplacianGraphOp
from sgl_tpu_torch.ops.message_ops import LastMessageOp, LearnableWeightedMessageOp


class SGC(SGAPModel):
    """Laplacian(r=.5) / Last / LogReg."""

    def __init__(self, prop_steps: int, feat_dim: int, output_dim: int):
        super().__init__(
            prop_steps,
            feat_dim,
            output_dim,
            pre_graph_op=LaplacianGraphOp(prop_steps, r=0.5),
            pre_msg_op=LastMessageOp(),
            base_model=LogisticRegression(feat_dim, output_dim),
        )


class GAMLP(SGAPModel):
    """Laplacian / JK attention / MLP.

    ``compute_dtype=torch.bfloat16`` runs the MLP's matmuls in bf16."""

    def __init__(
        self,
        prop_steps: int,
        feat_dim: int,
        output_dim: int,
        hidden_dim: int,
        num_layers: int,
        compute_dtype=None,
        dropout: float = 0.5,
    ):
        super().__init__(
            prop_steps,
            feat_dim,
            output_dim,
            pre_graph_op=LaplacianGraphOp(prop_steps, r=0.5),
            pre_msg_op=LearnableWeightedMessageOp(
                start=0,
                end=prop_steps + 1,
                combination_type="jk",
                prop_steps=prop_steps,
                feat_dim=feat_dim,
            ),
            base_model=MultiLayerPerceptron(
                feat_dim,
                hidden_dim,
                num_layers,
                output_dim,
                dropout=dropout,
                compute_dtype=compute_dtype,
            ),
        )
