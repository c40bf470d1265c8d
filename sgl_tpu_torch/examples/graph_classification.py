"""Graph classification with graph-level SGAP — counterpart of
``examples/graph_classification.py``.

The whole dataset propagates as one block-diagonal SpMM; training is a
model over each graph's pooled row.  The dataset is synthetic
(``SyntheticGraphClassification``).

    python -m sgl_tpu_torch.examples.graph_classification [--device cpu] [--epochs 60]
"""

from __future__ import annotations

import argparse

from sgl_tpu_torch.datasets import SyntheticGraphClassification
from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.models import GraphSGC
from sgl_tpu_torch.tasks import GraphClassification


def main(argv=None) -> dict:
    """Returns the device, the test accuracy and the task."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the GPU")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--num-graphs", type=int, default=200)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dataset = SyntheticGraphClassification(num_graphs=args.num_graphs)
    model = GraphSGC(prop_steps=2, feat_dim=dataset.num_features, output_dim=dataset.num_classes, readout="max")
    task = GraphClassification(dataset, model, lr=0.1, weight_decay=5e-5, epochs=args.epochs, device=device,
                               verbose=False)
    print(f"final test acc: {task.test_acc} ({device})")
    return {"device": device, "test_acc": task.test_acc, "task": task}


if __name__ == "__main__":
    main()
