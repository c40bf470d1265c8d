from sgl_tpu_torch.ops.graph_ops import (  # noqa: F401
    GraphOp,
    LaplacianGraphOp,
    PprGraphOp,
    k_hop_aggregate,
    k_hop_propagate,
)
from sgl_tpu_torch.ops.message_ops import (  # noqa: F401
    LEARNABLE_AGGR_TYPES,
    LastMessageOp,
    LearnableWeightedMessageOp,
    MessageOp,
)
