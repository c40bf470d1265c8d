from sgl_tpu_torch.graph.graph import Graph, pad_amount  # noqa: F401
from sgl_tpu_torch.graph.normalize import (  # noqa: F401
    ppr_weights,
    row_normalized_weights,
    symmetric_normalized_weights,
)
