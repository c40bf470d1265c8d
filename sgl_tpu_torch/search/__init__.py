"""PaSca-style neural architecture search — counterpart of
``sgl_tpu/search``: the 7-integer architecture space, the model it
compiles to, the inner training loop, the cross-trial propagation cache
and the search drivers (built-in evolutionary, random and successive
halving; OpenBox's SMBO when installed), and the distributed twins.
Trials run on the GPU unless ``ConfigManager._setParameters(...,
device="cpu")``."""

from sgl_tpu_torch.search.auto_search import SearchManager  # noqa: F401
from sgl_tpu_torch.search.auto_search_dist import (  # noqa: F401
    ConfigManagerDist,
    SearchManagerDist,
    SearchModelDist,
)
from sgl_tpu_torch.search.base_search import BaseSearch  # noqa: F401
from sgl_tpu_torch.search.prop_cache import PropagationCache  # noqa: F401
from sgl_tpu_torch.search.search_config import ARCH_KEYS, ConfigManager  # noqa: F401
from sgl_tpu_torch.search.search_models import SearchModel  # noqa: F401
from sgl_tpu_torch.search.smbo import (  # noqa: F401
    EvolutionarySearch,
    History,
    RandomSearch,
    Trial,
    run_nas,
    run_sha,
)
