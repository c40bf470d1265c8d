from sgl_tpu_torch.models.base import SGAPModel, SGAPNet, eager_aggregate  # noqa: F401
from sgl_tpu_torch.models.blocks import (  # noqa: F401
    Dense,
    FastDropout,
    IdenticalMapping,
    LogisticRegression,
    MultiLayerPerceptron,
    PReLU,
    init_params,
)
from sgl_tpu_torch.models.homo import GAMLP, SGC  # noqa: F401
