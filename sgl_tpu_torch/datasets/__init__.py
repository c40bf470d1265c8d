from sgl_tpu_torch.datasets.base import DeviceSplit, NodeDataset, random_split  # noqa: F401
from sgl_tpu_torch.datasets.synthetic import (  # noqa: F401
    PlantedPartition,
    SyntheticPowerLaw,
    random_power_law_graph,
)
