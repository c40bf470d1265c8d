"""Distributed node classification — counterpart of
``examples/test_nodeclass_dist.py``.

SGC through ``NodeClassificationDist``: the pre-propagation as a ring over
the mesh's ``graph`` axis, training data-parallel over ``data``.  One
process per rank under ``torchrun``, or alone as a one-rank mesh:

    torchrun --nproc_per_node=4 -m sgl_tpu_torch.examples.nodeclass_dist
    python -m sgl_tpu_torch.examples.nodeclass_dist --device cpu

The mesh is ``(world // 4, 4)`` from 4 ranks up, else ``(1, world)``
(``--mesh data,graph`` overrides).  Pubmed from Planetoid raw files under
``--root``, else a planted-partition graph of ``--nodes`` nodes.
``TrainConfig`` flags (``--lr``, ``--epochs``, ...) override the defaults.
"""

from __future__ import annotations

import argparse

from sgl_tpu_torch.utils import TrainConfig


def default_mesh(world: int):
    return (max(world // 4, 1), min(world, 4)) if world >= 4 else (1, world)


def dataset_for(args, planetoid: str, num_classes: int, feat_dim: int):
    if args.root is not None:
        from sgl_tpu_torch.datasets import Planetoid

        return Planetoid(planetoid, args.root, "official")
    from sgl_tpu_torch.datasets import PlantedPartition

    return PlantedPartition(num_nodes=args.nodes, feat_dim=feat_dim, num_classes=num_classes)


def parse(argv, nodes: int, description: str):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None, help="default: each rank's GPU")
    ap.add_argument("--mesh", default=None, help="data,graph (default: from the world size)")
    ap.add_argument("--root", default=None, help="Planetoid raw files (default: a synthetic graph)")
    ap.add_argument("--nodes", type=int, default=nodes, help="nodes of the synthetic graph")
    return ap.parse_known_args(argv)


def mesh_shape(args):
    """``--mesh``, or :func:`default_mesh` of the world ``torchrun`` set up
    (one rank alone)."""
    import torch.distributed as dist

    from sgl_tpu_torch.parallel import init_distributed

    if args.mesh is not None:
        return tuple(int(v) for v in args.mesh.split(","))
    init_distributed()
    return default_mesh(dist.get_world_size() if dist.is_initialized() else 1)


def main(argv=None) -> float:
    from sgl_tpu_torch.models import SGCDist
    from sgl_tpu_torch.tasks import NodeClassificationDist

    args, rest = parse(argv, 2000, __doc__.splitlines()[0])
    cfg = TrainConfig.from_args(rest)
    dataset = dataset_for(args, "pubmed", 3, 64)
    model = SGCDist(prop_steps=cfg.prop_steps, feat_dim=dataset.num_features, output_dim=dataset.num_classes)
    task = NodeClassificationDist(
        dataset, model, lr=cfg.lr, weight_decay=cfg.weight_decay, epochs=cfg.epochs,
        mesh_shape=mesh_shape(args), train_batch_size=cfg.train_batch_size, device=args.device,
    )
    print(f"final test acc: {task.test_acc}")
    return task.test_acc


if __name__ == "__main__":
    main()
