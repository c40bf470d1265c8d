"""The papers100M-regime pipeline on one GPU, everything host-resident.

Counterpart of ``examples/papers100m_pipeline.py``.  The reference reaches
"billions of nodes" by running its precompute as a CPU SpMM with the hops
in host RAM and slicing batches to the GPU a step at a time.  Here the card
does the SpMM work, end to end:

1. **Ingest**: a synthetic OGB-shaped homophilous power-law graph
   (``SyntheticPowerLaw``; papers100M's ~14 edges a node by default), or
   with ``--data ROOT`` the real ogbn-papers100M raw dump under ``ROOT``
   (``Ogbn("papers100M", root=ROOT)``, its standard OGB layout).
2. **Precompute out of core**: the 2-D src-block layout
   (``GraphOp.propagate_out_of_core(layout="2d")``): features, edges and
   every hop stay on the host; a hop copies one feature volume to the card
   per accumulator group, with no host gather.  ``--layout-cache`` keeps the
   layout build on disk (content-keyed).
3. **Store**: each finished hop goes to a memmap (``MemmapHopSink``), so the
   host holds two hop matrices.
4. **Train**: ``SGAPModel.attach_host_hops`` and the standard
   ``NodeClassification`` task (GAMLP: hidden 256, 3 layers): every step
   gathers only its batch's rows on the host, so the ``(K+1, N, D)`` stack
   never enters the card whole.

    python -m sgl_tpu_torch.examples.papers100m_pipeline [--bf16] [--store DIR]
    python -m sgl_tpu_torch.examples.papers100m_pipeline --data /path/to/data
    python -m sgl_tpu_torch.examples.papers100m_pipeline --toy   # 2,000 nodes, on the CPU
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from sgl_tpu_torch.datasets import Ogbn, SyntheticPowerLaw
from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.models import GAMLP
from sgl_tpu_torch.tasks import NodeClassification
from sgl_tpu_torch.utils import MemmapHopSink


def _src_blocks(s: str):
    return s if s == "auto" else int(s)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=200_000, help="synthetic graph size (ignored with --data)")
    ap.add_argument("--avg-deg", type=int, default=14, help="papers100M's ~14 edges a node")
    ap.add_argument("--d", type=int, default=128, help="feature width")
    ap.add_argument("--classes", type=int, default=32)
    ap.add_argument("--hops", type=int, default=3)
    ap.add_argument("--store", default="./papers100m_store", help="memmap hop store directory")
    ap.add_argument("--layout-cache", default=None, help="keep the 2-D layout build here")
    ap.add_argument("--src-blocks", default="auto", type=_src_blocks,
                    help="source-block count; 'auto' (default) sizes blocks by "
                         "spmm_ooc.SRC_BLOCK_BYTES at the feature width and dtype")
    ap.add_argument("--part-edges", type=int, default=6 << 20, help="edges per out-of-core part")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=50_000)
    ap.add_argument("--data", default=None, help="root holding a real ogbn-papers100M raw dump")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 features end to end: half the host-to-card volume and half the store")
    ap.add_argument("--toy", action="store_true", help="2,000 nodes, small parts, on the CPU")
    return ap.parse_args(argv)


def main(argv=None, device=None) -> dict:
    """Run the four stages; ``device=None`` is the GPU (the CPU with
    ``--toy``).  Returns the dataset, the model, the sink, the layout, the
    task, each stage's seconds and sizes, and on the card the peak device
    memory at the end of the precompute."""
    args = parse_args(argv)
    device = resolve_device("cpu" if device is None and args.toy else device)
    t0 = time.perf_counter()
    if args.data:
        ds = Ogbn("papers100M", root=args.data)
    else:
        ds = SyntheticPowerLaw(num_nodes=2_000 if args.toy else args.nodes, avg_degree=args.avg_deg,
                               feat_dim=args.d, num_classes=args.classes, seed=0)
    n, d = ds.num_node, ds.num_features
    ingest = time.perf_counter() - t0
    print(f"[ingest] {n} nodes, {ds.graph.num_edges} edges, d={d} ({ingest:.4f}s)")

    model = GAMLP(args.hops, d, ds.num_classes, hidden_dim=256, num_layers=3)
    x_host = torch.as_tensor(np.asarray(ds.x, np.float32))
    if args.bf16:
        x_host = x_host.to(torch.bfloat16)

    t1 = time.perf_counter()
    sink = MemmapHopSink(args.store, num_nodes=n, feat_dim=d, prop_steps=args.hops, dtype=x_host.dtype)
    model.pre_graph_op.propagate_out_of_core(
        ds.graph, x_host, hop_sink=sink, layout="2d",
        src_blocks=2 if args.toy else args.src_blocks,
        max_edges_per_part=8 * 128 if args.toy else args.part_edges,
        layout_cache_dir=args.layout_cache, device=device,
    )
    precompute_peak = None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        # since the caller's last reset_peak_memory_stats
        precompute_peak = torch.cuda.max_memory_allocated(device)
    precompute = time.perf_counter() - t1
    layout = model.pre_graph_op._adj_cache[2]
    stored = sum(os.path.getsize(sink.path(k)) for k in range(args.hops + 1))
    print(f"[precompute] {args.hops} hops out of core ({layout.num_parts} parts x "
          f"{layout.num_blocks} blocks, {layout.num_cells} non-empty cells) -> {args.store} "
          f"({stored / 1e9:.4f} GB on disk, {precompute:.4f}s, {precompute / args.hops:.4f}s/hop)")

    t2 = time.perf_counter()
    model.attach_host_hops(sink.hops(device=device))
    batch = min(args.batch, len(np.asarray(ds.train_idx)))
    task = NodeClassification(
        ds, model, lr=0.01, weight_decay=5e-5, epochs=args.epochs, device=device,
        train_batch_size=batch, eval_batch_size=batch, verbose=True,
    )
    train = time.perf_counter() - t2
    print(f"[train] {args.epochs} epochs from the host store in {train:.4f}s; "
          f"test acc {task.test_acc:.4f}")
    print(f"[total] {time.perf_counter() - t0:.4f}s")
    return {
        "dataset": ds, "model": model, "sink": sink, "layout": layout, "task": task,
        "test_acc": task.test_acc, "ingest_seconds": ingest, "precompute_seconds": precompute,
        "store_bytes": stored, "train_seconds": train, "precompute_peak_bytes": precompute_peak,
    }


if __name__ == "__main__":
    main()
