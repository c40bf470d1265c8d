"""NARS heterogeneous node classification — counterpart of
``examples/hetero_nars.py``.

Fast NARS (learnable subgraph weights) over two random relation subsets of
two edge types, predicting papers: ogbn-mag from its OGB raw files under
``--root``; when they are absent, ``SyntheticHeteroDataset``.

    python -m sgl_tpu_torch.examples.hetero_nars [--device cpu] [--root ./data/] [--epochs 50]
"""

from __future__ import annotations

import argparse

import numpy as np

from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.models import Fast_NARS_SGC_WithLearnableWeights
from sgl_tpu_torch.tasks import HeteroNodeClassification

PREDICT_CLASS = "paper"


def main(argv=None) -> dict:
    """Returns the device, the test accuracy, the subgraph weights and the task."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the GPU")
    ap.add_argument("--root", default="./data/", help="where ogbn-mag's OGB raw files are")
    ap.add_argument("--epochs", type=int, default=50)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    try:
        from sgl_tpu_torch.datasets import OgbnMag

        dataset = OgbnMag(args.root)
    except IOError:
        from sgl_tpu_torch.datasets import SyntheticHeteroDataset

        dataset = SyntheticHeteroDataset(seed=0)
    feat_dim = np.shape(dataset.data[PREDICT_CLASS].x)[1]
    model = Fast_NARS_SGC_WithLearnableWeights(prop_steps=2, feat_dim=feat_dim, output_dim=dataset.num_classes,
                                               hidden_dim=64, num_layers=2, random_subgraph_num=2)
    task = HeteroNodeClassification(dataset, PREDICT_CLASS, model, lr=0.05, weight_decay=5e-5, epochs=args.epochs,
                                    device=device, random_subgraph_num=2, subgraph_edge_type_num=2,
                                    record_subgraph_weight=True)
    print(f"test acc: {task.test_acc}, subgraph weights: {task.subgraph_weight} ({device})")
    return {"device": device, "test_acc": task.test_acc, "subgraph_weight": task.subgraph_weight, "task": task}


if __name__ == "__main__":
    main()
