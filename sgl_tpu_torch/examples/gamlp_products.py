"""GAMLP on ogbn-products — counterpart of ``examples/gamlp_products.py``.

ogbn-products from its OGB raw files under ``--root``; when they are
absent, a planted-partition graph.

    python -m sgl_tpu_torch.examples.gamlp_products [--device cpu] [--root ./data/] [--epochs 200]
"""

from __future__ import annotations

import argparse

from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.models import GAMLP
from sgl_tpu_torch.tasks import NodeClassification


def main(argv=None) -> dict:
    """Returns the device, the test accuracy, the model and the task."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the GPU")
    ap.add_argument("--root", default="./data/", help="where the OGB raw files are")
    ap.add_argument("--epochs", type=int, default=200)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    try:
        from sgl_tpu_torch.datasets import Ogbn

        dataset = Ogbn("products", args.root, "official")
    except IOError:
        print("ogbn-products raw files missing; using a synthetic graph")
        from sgl_tpu_torch.datasets import PlantedPartition

        dataset = PlantedPartition(num_nodes=5000, feat_dim=100, num_classes=16)
    model = GAMLP(prop_steps=3, feat_dim=dataset.num_features, output_dim=dataset.num_classes,
                  hidden_dim=512, num_layers=3)
    task = NodeClassification(dataset, model, lr=0.1, weight_decay=5e-5, epochs=args.epochs, device=device,
                              train_batch_size=50000, eval_batch_size=100000)
    print(f"final test acc: {task.test_acc} ({device})")
    return {"device": device, "test_acc": task.test_acc, "model": model, "task": task}


if __name__ == "__main__":
    main()
