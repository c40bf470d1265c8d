from sgl_tpu_torch.models.base import SGAPModel, SGAPNet, eager_aggregate  # noqa: F401
from sgl_tpu_torch.models.blocks import (  # noqa: F401
    BatchNorm,
    Dense,
    FastDropout,
    IdenticalMapping,
    LogisticRegression,
    MultiLayerPerceptron,
    PReLU,
    ResMultiLayerPerceptron,
    init_params,
)
from sgl_tpu_torch.models.homo import (  # noqa: F401
    GAMLP,
    GBP,
    NAFS,
    PASCA_V1,
    PASCA_V2,
    PASCA_V3,
    SGC,
    SIGN,
    SSGC,
    GAMLPDist,
    GAMLPRecursive,
    SGCDist,
)
