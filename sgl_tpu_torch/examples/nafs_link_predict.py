"""Training-free NAFS link prediction — counterpart of
``examples/nafs_link_predict.py``.

Pubmed from Planetoid raw files under ``--root``; when they are absent, a
planted-partition graph.

    python -m sgl_tpu_torch.examples.nafs_link_predict [--device cpu] [--root ./data/] [--hops 20]
"""

from __future__ import annotations

import argparse

from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.tasks import LinkPredictionNAFS


def main(argv=None) -> dict:
    """Returns the device, the test ROC-AUC and average precision, and the task."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the GPU")
    ap.add_argument("--root", default="./data/", help="where Planetoid's raw files are")
    ap.add_argument("--hops", type=int, default=20)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    try:
        from sgl_tpu_torch.datasets import Planetoid

        dataset = Planetoid("pubmed", args.root, "official")
    except IOError:
        from sgl_tpu_torch.datasets import PlantedPartition

        dataset = PlantedPartition(num_nodes=1000, feat_dim=64, num_classes=3)
    task = LinkPredictionNAFS(dataset, hops=args.hops, method="mean", device=device)
    print(f"test roc-auc: {task.test_roc_auc}, avg precision: {task.test_avg_prec} ({device})")
    return {"device": device, "test_roc_auc": task.test_roc_auc, "test_avg_prec": task.test_avg_prec, "task": task}


if __name__ == "__main__":
    main()
