"""ogbn-products-scale precompute and GAMLP training on one GPU, through
the streaming SpMM.

Counterpart of ``examples/products_scale_demo.py`` (``main`` and
``_train_at_scale``).  It generates a synthetic power-law graph at products
scale (2.4M nodes, ~62.4M nonzeros with self-loops, d = 100), normalizes it
on the device, splits the CSR into parts of at most ``part_edges`` nonzeros
and runs ``hops`` propagation hops part by part through the accumulating
CSR kernel (``kernels/csrc/spmm_csr.cu``).  With ``--train`` it then trains
GAMLP on the hop stack with the reference's ogbn-products recipe (hidden
512, 3 layers, lr 0.1, wd 5e-5) on 196,615 rows with synthetic labels, and
runs one eval forward over every node.

    python -m sgl_tpu_torch.examples.products_scale_demo [--bf16] [--train]
    python -m sgl_tpu_torch.examples.products_scale_demo --ooc [--2d] [--bf16]

With ``--ooc`` the features, the hops and the edges stay in host memory
(``kernels/spmm_ooc.py``): the graph is normalized on the host
(``symmetric_normalized_weights_host``), laid out into out-of-core parts
(``--2d``: the src-block layout) and each hop streams through the card; it
prints the layout, each hop's seconds, the steady seconds a hop and the G
nonzeros/s.  This is the papers100M regime at products scale.

It runs on the GPU; :func:`main` takes ``device="cpu"`` for small runs on
the CPU.  In-memory hops and training steps are timed with CUDA events on
the card (the host clock on the CPU); an out-of-core hop, which includes
host work, by the host clock around a call that returns with its result
on the host.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from sgl_tpu_torch.datasets import random_power_law_graph
from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.graph import symmetric_normalized_weights, symmetric_normalized_weights_host
from sgl_tpu_torch.kernels import (
    prepare_csr,
    prepare_csr_parts,
    prepare_out_of_core,
    prepare_out_of_core_2d,
    spmm_csr_streaming,
    spmm_out_of_core,
    spmm_out_of_core_2d,
)
from sgl_tpu_torch.models import GAMLP
from sgl_tpu_torch.tasks.utils import adam_l2, make_eval_step, make_train_step

#: ogbn-products' official training split size
TRAIN_ROWS = 196_615


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(device: torch.device, fn):
    """``(fn(), seconds)``: CUDA events on the card, the host clock on the CPU."""
    if device.type != "cuda":
        t = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    out = fn()
    end.record(stream)
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def train_at_scale(
    model: GAMLP, hop_stack: torch.Tensor, warmup: int = 2, measured: int = 6, seed: int = 0
) -> dict:
    """Train ``model`` (a GAMLP over the stack's hops) full batch on the
    hop-major stack with the reference's ogbn-products optimizer (Adam, lr
    0.1, L2 5e-5), then run one eval forward over every node.  Labels are
    synthetic, so the measurement is step time, not accuracy.

    Returns the step time (ms, the mean of ``measured`` steps after
    ``warmup``), the eval time (ms), every step's loss and the eval's count
    of correct rows.
    """
    if measured < 1:
        raise ValueError(f"measured must be >= 1, got {measured}")
    device = hop_stack.device
    n_nodes = hop_stack.shape[1]
    num_classes = model.output_dim
    net = model.net.to(device)
    model.processed_feature = hop_stack  # hop-major, as preprocess caches it
    optimizer = adam_l2(net.parameters(), 0.1, 5e-5)
    train_step = make_train_step(net, optimizer)
    eval_step = make_eval_step(net)
    dropout_gen = torch.Generator(device=device).manual_seed(seed)

    # ogbn-products trains on ~196k of the 2.4M nodes (the official split);
    # the full graph is touched only by the eval forward
    np_rng = np.random.default_rng(seed)
    tr_idx = np_rng.choice(n_nodes, size=min(TRAIN_ROWS, n_nodes), replace=False)
    tr_labels = np_rng.integers(0, num_classes, tr_idx.shape[0])
    tr_feats = model.batch_input(torch.as_tensor(tr_idx, device=device))
    tr_labels = torch.as_tensor(tr_labels, device=device)
    tr_w = torch.ones(tr_idx.shape[0], device=device)

    losses = [train_step(tr_feats, tr_labels, tr_w, dropout_gen)[0] for _ in range(warmup)]
    _sync(device)

    def run_measured():
        return [train_step(tr_feats, tr_labels, tr_w, dropout_gen)[0] for _ in range(measured)]

    timed_losses, seconds = _timed(device, run_measured)
    losses += timed_losses
    step_ms = seconds * 1e3 / measured
    print(f"GAMLP train at scale: {tr_idx.shape[0]} train rows of {n_nodes} -> "
          f"{step_ms:.4f} ms/step ({1e3 / step_ms:.2f} steps/s)")

    all_labels = torch.zeros(n_nodes, dtype=torch.long, device=device)
    all_w = torch.ones(n_nodes, device=device)
    (correct, _), eval_s = _timed(device, lambda: eval_step(hop_stack, all_labels, all_w))
    print(f"full-graph eval forward ({n_nodes} rows): {eval_s * 1e3:.4f} ms")
    return {
        "train_ms_per_step": step_ms,
        "eval_ms": eval_s * 1e3,
        "losses": [float(v) for v in losses],
        "eval_correct": float(correct),
    }


def main_ooc(g, d: int, hops: int, part_edges: int, dtype, device, layout: str = "1d",
             src_blocks="auto") -> dict:
    """Out-of-core mode (``--ooc``): normalize on the host, lay the graph out
    (``layout="2d"``: the src-block layout, ``src_blocks`` blocks), then run
    ``hops`` hops with ``x``, ``y`` and the edges in host memory.

    Returns ``hops`` (host arrays: numpy f32, or CPU tensors for bf16),
    ``hop_seconds``, ``layout``, ``nnz`` (of the normalized adjacency,
    self-loops included) and ``prepare_seconds`` (normalize + layout).
    """
    t0 = time.perf_counter()
    adj = symmetric_normalized_weights_host(g)
    nnz = int(adj.w.count_nonzero())
    x = torch.as_tensor(g.x).to(dtype or torch.float32)
    if layout == "2d":
        oc = prepare_out_of_core_2d(adj, max_edges_per_part=part_edges, src_blocks=src_blocks,
                                    feat_dim=d, feat_dtype=x.dtype)
        spmm = spmm_out_of_core_2d
        shape = f"{oc.num_parts} parts x {oc.num_blocks} blocks ({oc.num_cells} non-empty cells)"
    else:
        oc = prepare_out_of_core(adj, max_edges_per_part=part_edges)
        spmm = spmm_out_of_core
        shape = f"{oc.num_parts} parts (workspaces {sum(oc.workspace_rows)} rows)"
    prepare_seconds = time.perf_counter() - t0
    print(f"normalized on the host + {layout} out-of-core layout: {shape} ({prepare_seconds:.4f}s)")
    if x.dtype == torch.float32:
        x = x.numpy()
    out, times = [x], []
    for k in range(hops):
        t = time.perf_counter()
        out.append(spmm(oc, out[-1], device=device))
        times.append(time.perf_counter() - t)
        print(f"hop {k + 1} done ({sum(times):.4f}s cumulative)")
    steady = min(times[1:]) if len(times) > 1 else times[0]
    print(f"out-of-core precompute: first hop {times[0]:.4f}s, steady {steady:.4f}s/hop -> "
          f"{nnz / steady / 1e9:.4f} G nonzeros/s (host<->device streamed)")
    return {"hops": out, "hop_seconds": times, "layout": oc, "nnz": nnz, "prepare_seconds": prepare_seconds}


def main(
    n: int = 2_400_000,
    avg_deg: int = 25,
    d: int = 100,
    hops: int = 3,
    part_edges: int = 6 << 20,
    dtype: Optional[torch.dtype] = None,
    train: bool = False,
    device=None,
    ooc: bool = False,
    layout: str = "1d",
) -> dict:
    """Build the graph, normalize, split, run ``hops`` streaming hops and,
    with ``train``, train GAMLP on the stack.  ``device=None`` is the GPU.
    With ``ooc`` the hops run out of core instead (:func:`main_ooc`, its
    keys and ``graph``, ``graph_seconds``).

    Returns ``hops`` (the ``(hops+1, n, d)`` stack in ``dtype``, f32 by
    default), ``hop_seconds``, ``csr`` (the normalized
    :class:`~sgl_tpu_torch.kernels.CsrAdj`), ``parts`` (its
    :class:`~sgl_tpu_torch.kernels.CsrParts`), ``nnz``,
    ``graph`` (the host :class:`~sgl_tpu_torch.graph.Graph`),
    ``graph_seconds``, ``prepare_seconds`` and, with ``train``, the result
    of :func:`train_at_scale` for GAMLP (hidden 512, 3 layers, 47 classes)
    under ``train``.
    """
    device = resolve_device(device)
    if hops < 1:
        raise ValueError(f"hops must be >= 1, got {hops}")
    t0 = time.perf_counter()
    g = random_power_law_graph(n, avg_deg, d, seed=0, pad_multiple=1 << 20)
    graph_seconds = time.perf_counter() - t0
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges ({graph_seconds:.4f}s to generate)")
    if ooc:
        out = main_ooc(g, d, hops, part_edges, dtype, device, layout)
        return dict(out, graph=g, graph_seconds=graph_seconds)

    t0 = time.perf_counter()
    csr = prepare_csr(symmetric_normalized_weights(g, device=device))
    parts = prepare_csr_parts(csr, max_edges_per_part=part_edges)
    _sync(device)
    prepare_seconds = time.perf_counter() - t0
    print(f"normalized + partitioned into {len(parts)} parts of <= {part_edges} nonzeros "
          f"({parts.nnz} nonzeros with self-loops; {prepare_seconds:.4f}s)")

    x = torch.as_tensor(g.x).to(device, dtype or torch.float32)
    stack = torch.empty((hops + 1, *x.shape), dtype=x.dtype, device=device)
    stack[0] = x
    del x
    times = []
    for k in range(hops):
        h, seconds = _timed(device, lambda: spmm_csr_streaming(parts, stack[k]))
        stack[k + 1] = h
        del h
        times.append(seconds)
        print(f"hop {k + 1} done ({sum(times):.4f}s cumulative)")
    # every hop runs the same kernels on the same sizes; the first also
    # meets the card's first-touch costs, so the steady rate is the best
    # of the rest
    steady = min(times[1:]) if len(times) > 1 else times[0]
    print(f"precompute: first hop {times[0]:.4f}s, steady {steady:.4f}s/hop -> "
          f"{parts.nnz / steady / 1e9:.4f} G nonzeros/s")
    out = {
        "hops": stack, "hop_seconds": times, "csr": csr, "parts": parts, "nnz": parts.nnz,
        "graph_seconds": graph_seconds, "prepare_seconds": prepare_seconds, "graph": g,
    }
    if train:
        # the reference's ogbn-products GAMLP: hidden 512, 3 layers, 47 classes
        model = GAMLP(hops, d, 47, hidden_dim=512, num_layers=3)
        model.init(torch.Generator().manual_seed(0))  # drawn on the CPU
        out["train"] = train_at_scale(model, stack)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bf16", action="store_true", help="bf16 features and hops")
    ap.add_argument("--train", action="store_true", help="train GAMLP on the hop stack")
    ap.add_argument("--ooc", action="store_true", help="features, hops and edges in host memory")
    ap.add_argument("--2d", dest="two_d", action="store_true", help="with --ooc: the src-block layout")
    args = ap.parse_args()
    main(dtype=torch.bfloat16 if args.bf16 else None, train=args.train, ooc=args.ooc,
         layout="2d" if args.two_d else "1d")
