"""Utilities of the port: the training config, the host hop store,
checkpoints, timing and tracing, the device chooser, and the raster figure
of the clustering plots.  ``sgl_tpu``'s
``utils/compile_cache.py`` is XLA's persistent compilation cache and has no
counterpart here: PyTorch compiles nothing of the port's path, and the
CUDA kernels' own build cache is ``sgl_tpu_torch/_build/``."""

from sgl_tpu_torch.utils.checkpoint import (  # noqa: F401
    HopCheckpointer,
    load_pytree,
    load_train_state,
    save_pytree,
    save_train_state,
)
from sgl_tpu_torch.utils.config import MeshConfig, TrainConfig  # noqa: F401
from sgl_tpu_torch.utils.device import (  # noqa: F401
    GpuWithMaxFreeMem,
    default_backend,
    device_with_max_free_mem,
    num_devices,
)
from sgl_tpu_torch.utils.figure import Figure, read_png, write_png  # noqa: F401
from sgl_tpu_torch.utils.hop_store import HostHops, MemmapHopSink  # noqa: F401
from sgl_tpu_torch.utils.profiling import StageTimer, slope_time, sync, torch_trace  # noqa: F401
