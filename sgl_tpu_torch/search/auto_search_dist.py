"""The distributed NAS twins — counterpart of
``sgl_tpu/search/auto_search_dist.py``.

The same ``SearchModel`` trains through the distributed runtime, so the
twins are thin: :class:`SearchManagerDist` evaluates one architecture with
``NodeClassificationDist`` and :class:`ConfigManagerDist` is the NAS
objective over it.  Every rank of the mesh runs the same search and gets
the same objectives.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from sgl_tpu_torch.search.search_config import ConfigManager
from sgl_tpu_torch.search.search_models import SearchModel
from sgl_tpu_torch.tasks.node_classification_dist import NodeClassificationDist

# the arch -> model compilation is the single-process one
SearchModelDist = SearchModel


class SearchManagerDist:
    """The NAS inner loop over the distributed runtime: ``_execute()``
    returns ``(test_acc, seconds)``."""

    def __init__(
        self,
        dataset,
        model,
        lr: float,
        weight_decay: float,
        epochs: int,
        mesh_shape: Optional[Tuple[int, int]] = None,
        seed: int = 42,
        device=None,
    ):
        self._dataset = dataset
        self._model = model
        self._lr = lr
        self._weight_decay = weight_decay
        self._epochs = epochs
        self._mesh_shape = mesh_shape
        self._seed = seed
        self._device = device

    def _execute(self):
        t0 = time.perf_counter()
        task = NodeClassificationDist(
            self._dataset, self._model, lr=self._lr, weight_decay=self._weight_decay,
            epochs=self._epochs, mesh_shape=self._mesh_shape, seed=self._seed, verbose=False,
            device=self._device,
        )
        return task.test_acc, time.perf_counter() - t0


class ConfigManagerDist(ConfigManager):
    """The NAS objective evaluated through the distributed runtime; trials
    run on each rank's device (``device=None``) or on ``device``."""

    def _setParameters(self, dataset, device=None, hiddim=None, epochs=None, lr=None, wd=None,  # noqa: N802
                       restarts=10, mesh_shape=None, config=None):
        super()._setParameters(dataset, device, hiddim, epochs, lr, wd, restarts, prop_cache=False,
                               config=config)
        self._dist_device = device
        self._mesh_shape = mesh_shape

    def _configTarget(self, arch):  # noqa: N802
        model = SearchModel(arch, self._dataset.num_features, int(self._dataset.num_classes), self._hiddim)
        acc, elapsed = SearchManagerDist(
            self._dataset, model, lr=self._lr, weight_decay=self._wd, epochs=self._epochs,
            mesh_shape=self._mesh_shape, device=self._dist_device,
        )._execute()
        return {"objs": np.stack([-acc, elapsed], axis=-1)}
