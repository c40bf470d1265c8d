"""NAS with the distributed inner loop — counterpart of
``examples/test_nas_dist.py``.

Every trial trains through ``NodeClassificationDist`` on the mesh; every
rank runs the same search (the built-in evolutionary search where OpenBox
is absent) and gets the same history:

    torchrun --nproc_per_node=4 -m sgl_tpu_torch.examples.nas_dist
    python -m sgl_tpu_torch.examples.nas_dist --device cpu --max-runs 3

Cora from Planetoid raw files under ``--root``, else a planted-partition
graph of ``--nodes`` nodes; the mesh as in ``nodeclass_dist``.
"""

from __future__ import annotations

import argparse

from sgl_tpu_torch.examples.nodeclass_dist import dataset_for, mesh_shape, parse
from sgl_tpu_torch.search import ConfigManagerDist, run_nas
from sgl_tpu_torch.utils import TrainConfig

INITIAL_ARCH = [2, 1, 0, 1, 0, 0, 0]
DEFAULTS = TrainConfig(lr=1e-2, weight_decay=5e-4, epochs=30, hidden_dim=64)


def main(argv=None):
    args, rest = parse(argv, 800, __doc__.splitlines()[0])
    extra = argparse.ArgumentParser()
    extra.add_argument("--max-runs", type=int, default=10)
    runs, rest = extra.parse_known_args(rest)
    cfg = TrainConfig.from_args(rest, defaults=DEFAULTS)
    dataset = dataset_for(args, "cora", 4, 32)
    configer = ConfigManagerDist(arch=list(INITIAL_ARCH))
    configer._setParameters(dataset, args.device, config=cfg, mesh_shape=mesh_shape(args))
    history = run_nas(configer, max_runs=runs.max_runs, optimizer="evolution", seed=1)
    print(history.summary())
    return history


if __name__ == "__main__":
    main()
