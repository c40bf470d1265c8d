"""Homogeneous SGAP models — counterpart of ``sgl_tpu/models/homo.py``.

Each model is the same composition of graph op, message op and base net as
its ``sgl_tpu`` twin, with the same argument order.  Where Flax infers a
layer's input width from the first batch, the port's layers take it from
``feat_dim`` (``(K+1)·feat_dim`` for SIGN's concat).  ``SGCDist`` and
``GAMLPDist`` are aliases, as in ``sgl_tpu``.
"""

from __future__ import annotations

from sgl_tpu_torch.models.base import SGAPModel
from sgl_tpu_torch.models.blocks import (
    IdenticalMapping,
    LogisticRegression,
    MultiLayerPerceptron,
    ResMultiLayerPerceptron,
)
from sgl_tpu_torch.ops.graph_ops import LaplacianGraphOp, PprGraphOp
from sgl_tpu_torch.ops.message_ops import (
    ConcatMessageOp,
    IterateLearnableWeightedMessageOp,
    LastMessageOp,
    LearnableWeightedMessageOp,
    MeanMessageOp,
    OverSmoothDistanceWeightedOp,
    SimpleWeightedMessageOp,
)


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


class SIGN(SGAPModel):
    """Laplacian / Concat / MLP((K+1)·D)."""

    def __init__(
        self, prop_steps: int, feat_dim: int, output_dim: int, hidden_dim: int, num_layers: int
    ):
        super().__init__(
            prop_steps,
            feat_dim,
            output_dim,
            pre_graph_op=LaplacianGraphOp(prop_steps, r=0.5),
            pre_msg_op=ConcatMessageOp(start=0, end=prop_steps + 1),
            base_model=MultiLayerPerceptron(
                (prop_steps + 1) * feat_dim, hidden_dim, num_layers, output_dim
            ),
        )


class SSGC(SGAPModel):
    """Laplacian / Mean / LogReg (S²GC)."""

    def __init__(self, prop_steps: int, feat_dim: int, output_dim: int):
        super().__init__(
            prop_steps,
            feat_dim,
            output_dim,
            pre_graph_op=LaplacianGraphOp(prop_steps, r=0.5),
            pre_msg_op=MeanMessageOp(start=0, end=prop_steps + 1),
            base_model=LogisticRegression(feat_dim, output_dim),
        )


class GBP(SGAPModel):
    """Laplacian / geometric α-weights / MLP.  ``r`` is accepted and not
    used (the graph op is ``r=0.5``), as in ``sgl_tpu``."""

    def __init__(
        self,
        prop_steps: int,
        feat_dim: int,
        output_dim: int,
        hidden_dim: int,
        num_layers: int,
        r: float = 0.5,
        alpha: float = 0.85,
    ):
        super().__init__(
            prop_steps,
            feat_dim,
            output_dim,
            pre_graph_op=LaplacianGraphOp(prop_steps, r=0.5),
            pre_msg_op=SimpleWeightedMessageOp(
                start=0, end=prop_steps + 1, combination_type="alpha", alpha=alpha
            ),
            base_model=MultiLayerPerceptron(feat_dim, hidden_dim, num_layers, output_dim),
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


class GAMLPRecursive(SGAPModel):
    """Laplacian / recursive gating / MLP."""

    def __init__(
        self, prop_steps: int, feat_dim: int, output_dim: int, hidden_dim: int, num_layers: int
    ):
        super().__init__(
            prop_steps,
            feat_dim,
            output_dim,
            pre_graph_op=LaplacianGraphOp(prop_steps, r=0.5),
            pre_msg_op=IterateLearnableWeightedMessageOp(
                start=0, end=prop_steps + 1, combination_type="recursive", feat_dim=feat_dim
            ),
            base_model=MultiLayerPerceptron(feat_dim, hidden_dim, num_layers, output_dim),
        )


class NAFS(SGAPModel):
    """Laplacian / over-smoothing-distance weights / identity: training-free
    node embeddings (no trainable parameters; driven by ``preprocess``)."""

    def __init__(self, prop_steps: int, feat_dim: int, output_dim: int):
        super().__init__(
            prop_steps,
            feat_dim,
            output_dim,
            pre_graph_op=LaplacianGraphOp(prop_steps, r=0.5),
            pre_msg_op=OverSmoothDistanceWeightedOp(),
            base_model=IdenticalMapping(),
        )


class PASCA_V1(SGAPModel):
    """PPR(α=0.1) / learnable 'simple' hop weights over hops 1..K / ResMLP.
    The 'simple' op gets ``prop_steps``, as in ``sgl_tpu``."""

    def __init__(
        self, prop_steps: int, feat_dim: int, output_dim: int, hidden_dim: int, num_layers: int
    ):
        super().__init__(
            prop_steps,
            feat_dim,
            output_dim,
            pre_graph_op=PprGraphOp(prop_steps, r=0.5, alpha=0.1),
            pre_msg_op=LearnableWeightedMessageOp(
                start=1,
                end=prop_steps + 1,
                combination_type="simple",
                prop_steps=prop_steps,
            ),
            base_model=ResMultiLayerPerceptron(
                feat_dim, hidden_dim, num_layers, output_dim, dropout=0.8
            ),
        )


class PASCA_V2(SGAPModel):
    """Laplacian / gated hop weights over hops 1..K / ResMLP."""

    def __init__(
        self, prop_steps: int, feat_dim: int, output_dim: int, hidden_dim: int, num_layers: int
    ):
        super().__init__(
            prop_steps,
            feat_dim,
            output_dim,
            pre_graph_op=LaplacianGraphOp(prop_steps, r=0.5),
            pre_msg_op=LearnableWeightedMessageOp(
                start=1, end=prop_steps + 1, combination_type="gate", feat_dim=feat_dim
            ),
            base_model=ResMultiLayerPerceptron(
                feat_dim, hidden_dim, num_layers, output_dim, dropout=0.8
            ),
        )


class PASCA_V3(SGAPModel):
    """PASCA_V2's pre-propagation and net, then post-propagation of the
    softmax over ``PprGraphOp(post_steps, alpha=0.3)`` with a
    ``LastMessageOp``."""

    def __init__(
        self,
        prop_steps: int,
        post_steps: int,
        feat_dim: int,
        output_dim: int,
        hidden_dim: int,
        num_layers: int,
    ):
        super().__init__(
            prop_steps,
            feat_dim,
            output_dim,
            pre_graph_op=LaplacianGraphOp(prop_steps, r=0.5),
            pre_msg_op=LearnableWeightedMessageOp(
                start=1, end=prop_steps + 1, combination_type="gate", feat_dim=feat_dim
            ),
            base_model=ResMultiLayerPerceptron(
                feat_dim, hidden_dim, num_layers, output_dim, dropout=0.8
            ),
            post_graph_op=PprGraphOp(post_steps, r=0.5, alpha=0.3),
            post_msg_op=LastMessageOp(),
        )


# aliases, as in sgl_tpu: data parallelism belongs to the task runtime, not
# to the model
SGCDist = SGC
GAMLPDist = GAMLP
