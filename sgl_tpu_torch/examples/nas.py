"""PaSca-style NAS on one GPU — counterpart of ``examples/test_nas.py``.

OpenBox's SMBO when it is installed, else the built-in evolutionary Pareto
search, over the 7-integer architecture space; every trial's propagation
runs on the card through the cross-trial cache.  Cora from Planetoid raw
files under ``./data/`` (fetched when they are not there), else a
planted-partition graph.  ``TrainConfig`` flags (``--lr``, ``--epochs``,
...) override the defaults.

    python -m sgl_tpu_torch.examples.nas [--max-runs 30] [--device cpu]
"""

from __future__ import annotations

import argparse

from sgl_tpu_torch.search import ConfigManager, run_nas
from sgl_tpu_torch.utils import TrainConfig

INITIAL_ARCH = [2, 1, 1, 2, 3, 1, 0]
DEFAULTS = TrainConfig(lr=1e-2, weight_decay=5e-4, epochs=50, hidden_dim=128)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-runs", type=int, default=30)
    ap.add_argument("--device", default=None, help="default: the GPU")
    ap.add_argument("--root", default="./data/", help="where Planetoid's raw files would be")
    args, rest = ap.parse_known_args(argv)
    try:
        from sgl_tpu_torch.datasets import Planetoid

        dataset = Planetoid("cora", args.root, "official")
    except IOError:
        from sgl_tpu_torch.datasets import PlantedPartition

        dataset = PlantedPartition(num_nodes=800, feat_dim=32, num_classes=4)
    cfg = TrainConfig.from_args(rest, defaults=DEFAULTS)
    configer = ConfigManager(list(INITIAL_ARCH))
    configer._setParameters(dataset, args.device, restarts=2, config=cfg)
    history = run_nas(configer, max_runs=args.max_runs, optimizer="auto", seed=1)
    print(history.summary())
    return history


if __name__ == "__main__":
    main()
