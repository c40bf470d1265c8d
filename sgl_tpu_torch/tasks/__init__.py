from sgl_tpu_torch.tasks.node_classification import NodeClassification  # noqa: F401
from sgl_tpu_torch.tasks.node_classification_dist import NodeClassificationDist  # noqa: F401
from sgl_tpu_torch.tasks.graph_classification import GraphClassification  # noqa: F401
from sgl_tpu_torch.tasks.correct_and_smooth import (  # noqa: F401
    NodeClassification_With_CorrectAndSmooth,
    NodeClassificationWithCorrectAndSmooth,
)
from sgl_tpu_torch.tasks.node_clustering import (  # noqa: F401
    KMeans,
    NodeClustering,
    NodeClusteringNAFS,
    nafs_smooth_features,
    nafs_smooth_sweep,
)
from sgl_tpu_torch.tasks.link_prediction import (  # noqa: F401
    LinkPredictionGAE,
    LinkPredictionNAFS,
    mask_test_edges,
)
from sgl_tpu_torch.tasks.node_classification_with_label_use import (  # noqa: F401
    NodeClassificationWithLabelUse,
)
from sgl_tpu_torch.tasks.hetero_node_classification import HeteroNodeClassification  # noqa: F401
from sgl_tpu_torch.tasks.inference import Predictor, predictor_from_task  # noqa: F401
from sgl_tpu_torch.tasks.tsne import TSNE, trustworthiness  # noqa: F401
