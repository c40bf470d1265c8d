"""SGC on pubmed, the three-line flow — counterpart of
``examples/sgc_pubmed.py``.

Pubmed from Planetoid raw files under ``--root``; when they are absent, a
planted-partition graph.  ``TrainConfig`` flags (``--lr 0.2 --epochs 50``)
override the shipped configuration.

    python -m sgl_tpu_torch.examples.sgc_pubmed [--device cpu] [--root ./data/]
"""

from __future__ import annotations

import argparse

from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.models import SGC
from sgl_tpu_torch.tasks import NodeClassification
from sgl_tpu_torch.utils import TrainConfig

DEFAULTS = TrainConfig(lr=0.1, weight_decay=5e-5, epochs=200, prop_steps=3)


def main(argv=None) -> dict:
    """Returns the device, the test accuracy, the model and the task."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the GPU")
    ap.add_argument("--root", default="./data/", help="where Planetoid's raw files are")
    args, rest = ap.parse_known_args(argv)
    cfg = TrainConfig.from_args(rest, defaults=DEFAULTS)
    device = resolve_device(args.device)
    try:
        from sgl_tpu_torch.datasets import Planetoid

        dataset = Planetoid("pubmed", args.root, "official")
    except IOError:
        print("pubmed raw files missing; using a synthetic planted partition")
        from sgl_tpu_torch.datasets import PlantedPartition

        dataset = PlantedPartition(num_nodes=2000, feat_dim=64, num_classes=3)
    model = SGC(prop_steps=cfg.prop_steps, feat_dim=dataset.num_features, output_dim=dataset.num_classes)
    task = NodeClassification(dataset, model, config=cfg, device=device)
    print(f"final test acc: {task.test_acc} ({device})")
    return {"device": device, "test_acc": task.test_acc, "model": model, "task": task}


if __name__ == "__main__":
    main()
