from sgl_tpu_torch.utils.config import TrainConfig  # noqa: F401
from sgl_tpu_torch.utils.hop_store import HostHops, MemmapHopSink  # noqa: F401
