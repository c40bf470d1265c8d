"""NAS configuration space and objective — counterpart of
``sgl_tpu/search/search_config.py``.

The 7-integer space and the two-objective result ``[-acc, time]`` are the
reference's.  The optimizer sits behind an interface: OpenBox when it is
installed (:meth:`ConfigManager._configSpace`, imported only there), else
the built-in drivers of :mod:`sgl_tpu_torch.search.smbo`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from sgl_tpu_torch.search.auto_search import SearchManager
from sgl_tpu_torch.search.search_models import SearchModel

ARCH_KEYS = (
    "prop_steps",
    "prop_types",
    "mesg_types",
    "num_layers",
    "post_steps",
    "post_types",
    "pmsg_types",
)


@dataclasses.dataclass
class ConfigManager:
    """Holds the integer ranges, sets the arch vector per trial, and
    evaluates the objective through :class:`SearchManager`."""

    arch: List[int]
    prop_steps: Tuple[int, int] = (1, 10)
    prop_types: Tuple[int, int] = (1, 4)
    mesg_types: Tuple[int, int] = (0, 8)
    num_layers: Tuple[int, int] = (1, 10)
    post_steps: Tuple[int, int] = (1, 10)
    post_types: Tuple[int, int] = (1, 4)
    pmsg_types: Tuple[int, int] = (0, 5)

    def _setParameters(self, dataset, device=None, hiddim=None, epochs=None,  # noqa: N802
                       lr=None, wd=None, restarts=10, prop_cache=True, config=None):
        """The reference's setter.  ``config`` (a ``utils.config.TrainConfig``)
        supplies any of hiddim / epochs / lr / wd left as None (the keyword
        wins); ``device`` is where every trial runs (default: the GPU);
        ``prop_cache`` shares propagation across trials
        (:mod:`~sgl_tpu_torch.search.prop_cache`)."""
        from sgl_tpu_torch.device import resolve_device
        from sgl_tpu_torch.search.prop_cache import PropagationCache
        from sgl_tpu_torch.utils.config import TrainConfig

        r = (config or TrainConfig()).resolve(hidden_dim=hiddim, epochs=epochs, lr=lr, weight_decay=wd)
        self._dataset = dataset
        self._device = resolve_device(device)
        self._hiddim = r["hidden_dim"]
        self._epochs = r["epochs"]
        self._lr = r["lr"]
        self._wd = r["weight_decay"]
        self._restarts = restarts
        self._prop_cache = PropagationCache() if prop_cache else None

    @property
    def ranges(self) -> Dict[str, Tuple[int, int]]:
        return {k: getattr(self, k) for k in ARCH_KEYS}

    def sample(self, rng: np.random.Generator) -> Dict[str, int]:
        return {k: int(rng.integers(lo, hi + 1)) for k, (lo, hi) in self.ranges.items()}

    def _configSpace(self):  # noqa: N802
        """OpenBox's ConfigurationSpace (an optional dependency, imported
        here only): its space types come from ``openbox.space`` in newer
        releases and ``openbox.utils.config_space`` in older ones, and newer
        ConfigSpace renamed ``add_hyperparameters`` to ``add``."""
        try:
            from openbox.space import ConfigurationSpace, UniformIntegerHyperparameter  # type: ignore
        except ImportError:
            from openbox.utils.config_space import (  # type: ignore
                ConfigurationSpace,
                UniformIntegerHyperparameter,
            )

        space = ConfigurationSpace()
        hps = [UniformIntegerHyperparameter(k, lo, hi) for k, (lo, hi) in self.ranges.items()]
        if hasattr(space, "add_hyperparameters"):
            space.add_hyperparameters(hps)
        else:
            space.add(hps)
        return space

    def _configTarget(self, arch: Sequence[int]) -> Dict:  # noqa: N802
        model = SearchModel(arch, self._dataset.num_features, int(self._dataset.num_classes), self._hiddim)
        acc, elapsed = SearchManager(
            self._dataset,
            model,
            lr=self._lr,
            weight_decay=self._wd,
            epochs=self._epochs,
            device=getattr(self, "_device", None),
            restarts=self._restarts,
            prop_cache=getattr(self, "_prop_cache", None),
        )._execute()
        return {"objs": np.stack([-acc, elapsed], axis=-1)}

    def _configFunction(self, config) -> Dict:  # noqa: N802
        for i, k in enumerate(ARCH_KEYS):
            self.arch[i] = int(config[k])
        return self._configTarget(self.arch)
