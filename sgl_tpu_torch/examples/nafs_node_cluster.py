"""Training-free NAFS node clustering — counterpart of
``examples/nafs_node_cluster.py``.

Pubmed from Planetoid raw files under ``--root``; when they are absent, a
planted-partition graph.

    python -m sgl_tpu_torch.examples.nafs_node_cluster [--device cpu] [--root ./data/] [--hops 20]
"""

from __future__ import annotations

import argparse

from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.tasks import NodeClusteringNAFS


def main(argv=None) -> dict:
    """Returns the device, the clustering accuracy, NMI and ARI, and the task."""
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
    task = NodeClusteringNAFS(dataset, hops=args.hops, method="mean", device=device)
    print(f"acc: {task.acc}, nmi: {task.nmi}, ari: {task.adjscore} ({device})")
    return {"device": device, "acc": task.acc, "nmi": task.nmi, "adjscore": task.adjscore, "task": task}


if __name__ == "__main__":
    main()
