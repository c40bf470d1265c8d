from sgl_tpu_torch.models.base import SGAPModel, SGAPNet, eager_aggregate  # noqa: F401
from sgl_tpu_torch.models.blocks import (  # noqa: F401
    BatchNorm,
    Dense,
    FastDropout,
    FastOneDimConvolution,
    FeedForward,
    IdenticalMapping,
    LayerNorm,
    LogisticRegression,
    MultiHeadAttention,
    MultiLayerPerceptron,
    OneDimConvolution,
    OneDimConvolutionWeightSharedAcrossFeatures,
    PReLU,
    ResMultiLayerPerceptron,
    TransformerEncoderLayer,
    TwoLayerHead,
    init_params,
)
from sgl_tpu_torch.models.homo import (  # noqa: F401
    GAMLP,
    GBP,
    NAFS,
    NAGphormer,
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
from sgl_tpu_torch.models.hetero import (  # noqa: F401
    FastHeteroSGAPModel,
    Fast_NARS_SGC_WithLearnableWeights,
    HeteroSGAPModel,
    NARS_SIGN,
)
from sgl_tpu_torch.models.graph_level import (  # noqa: F401
    GraphLevelSGAPModel,
    GraphReadoutNet,
    GraphSGC,
    GraphSIGN,
    segment_readout,
)
