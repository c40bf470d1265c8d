from sgl_tpu_torch.datasets.base import (  # noqa: F401
    DeviceSplit,
    GraphDataset,
    HeteroNodeDataset,
    NodeDataset,
    random_split,
)
from sgl_tpu_torch.datasets.choose_edge_type import (  # noqa: F401
    choose_edge_type,
    choose_multi_subgraphs,
    remove_duplicate_edge_types,
)
from sgl_tpu_torch.datasets.custom import Custom_Hetero, Custom_Homo  # noqa: F401
from sgl_tpu_torch.datasets.hetero_datasets import Acm, Aminer, Dblp, DblpOriginal, Imdb  # noqa: F401
from sgl_tpu_torch.datasets.npz_datasets import Amazon, AmazonProduct, Coauthor, Flickr, Reddit  # noqa: F401
from sgl_tpu_torch.datasets.ogbn import Ogbn, OgbnMag  # noqa: F401
from sgl_tpu_torch.datasets.planetoid import Nell, Planetoid  # noqa: F401
from sgl_tpu_torch.datasets.synthetic import (  # noqa: F401
    PlantedPartition,
    SyntheticGraphClassification,
    SyntheticHeteroDataset,
    SyntheticPowerLaw,
    random_power_law_graph,
    synthetic_hetero,
)
from sgl_tpu_torch.datasets.tu_dataset import TUDataset  # noqa: F401
from sgl_tpu_torch.datasets.web_datasets import (  # noqa: F401
    Actor,
    Airports,
    Facebook,
    Github,
    KarateClub,
    LINKXDataset,
    Twitch,
    WebKB,
    Wikics,
)
