#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sgl_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. print the card's name and power limit (``nvidia-smi``); build every CUDA
   kernel of the package from source with ``nvcc`` and print the seconds;
   beside it, a second compile with ``-Xptxas -v`` prints each kernel
   instantiation's registers, static shared memory and spills;
2. hold the one-shot kernels against their plain PyTorch twin at the SpMM
   bench shape (``random_power_law_graph(200_000, 25, 128, seed=0)``: ~5.2M
   nonzeros with self-loops), check that two runs give the same bits, and
   time kernel, twin and the library call (``torch.sparse.mm`` on a CSR
   tensor, used nowhere in the port) with CUDA events; print the split
   plan (long rows cut into segments of ``SPLIT_NNZ`` nonzeros), the f32
   error against a float64 sum, and the hub row alone against the whole
   kernel; then the kernel on the same CSR with each row sorted by source,
   timed in turns with the rows as built;
3. run the main path at full width through the user-facing entry points on
   the default device: ``NodeClassification`` with GAMLP (f32 precompute)
   and with SGC (bf16 precompute) on a 100k-node power-law dataset, with
   the launch counters (first pass and fix-up) set to 0 just before each
   run and read just after; then hold each kernel against its twin again
   at the main path's shape, the f32 one also against a float64 sum
   (``F64_TOL``), and check the outputs against the port's CPU path on a
   small graph;
4. streaming SpMM at the bench shape, in parts of ``1 << 20`` nonzeros:
   the accumulating kernels against their twin, against the one-shot
   product and, f32, against a float64 sum; two runs bit-equal; the
   accumulate contract on one part (rows outside it kept bit for bit),
   and their times;
5. the products-scale pipeline (``sgl_tpu_torch.examples.
   products_scale_demo.main``: 2.4M nodes, ~62.4M nonzeros, d = 100, parts
   of ``6 << 20``) on the default device, f32 with GAMLP training and bf16
   precompute only, counters set to 0 just before each run and read just
   after; one hop of each held against the streaming twin and, within a
   limit for two f32 orders over hub rows, against the one-shot kernel,
   which is timed beside it, f32 also against a float64 sum; first the
   same pipeline at a small size against the port's CPU path;
6. the ports of the ``dev/`` harnesses (TPU kernels D1–D6,
   ``sgl_tpu_torch.dev``) at the bench shape: with the launch counters set
   to 0 just before and read just after, ``exp_spmm.check`` (every SpMM
   variant against ``exp_spmm.sequential_reference``), D2's accumulate probe and D1's
   gather probe (2^20 rows of 128 f32, 2^18 and 2^20 edges, its bound from
   the distinct rows the ids name, ``embedding_bag`` as its library call);
   then each of
   the six segment-reduce instantiations against its twin on its
   variant's messages (D2 into a random accumulator at a row offset,
   storage kept, untouched rows bit-exact) and against a float64 sum of the
   same messages (``F64_TOL``), two runs bit-equal, with its tiles, cut
   rows, workspace and copy path, timed beside its bound and its hub row
   alone (every other row empty), and beside one PyTorch call of the same
   function where there is one (``torch.segment_reduce`` for ``f32``,
   ``torch.sparse.mm`` for ``f32_w2``), with the device time of pass 1 and
   the fix-up apart (``torch.profiler``), one message array at a time;
   then D1's probe five more times back to back, each time printed;
7. the model zoo on the card: ``NodeClassification`` with SIGN, SSGC (bf16
   precompute), GBP, GAMLPRecursive and PASCA_V1–V3 at the main path's
   dataset and widths (hidden 512, 3 layers; 5 epochs), the launch
   counters set to 0 just before each run and read just after, each
   model's preprocessed features against the port's CPU path of the same
   model; NAFS's preprocess (propagation and the over-smoothing
   aggregate) against the CPU path; the README's flow on Planetoid-format
   raw files at pubmed's shape, written from a seed into a temporary
   directory (``Planetoid`` → ``SGC`` → ``NodeClassification``); the
   native graph builder (built with ``g++``; the run fails without it), and on the
   products graph of phase 5 the host normalization against the card's,
   both timed;
8. the label and NAFS tasks on the card, at the main path's dataset:
   first each task's device work on a small graph (``PlantedPartition``)
   against the port's CPU path (label propagation, Correct & Smooth, the
   label-reuse features, the NAFS sweep, KMeans from the same centers, the
   NAFS link AUC and AP); then, the launch counters set to 0 just before
   each task and read just after and held to ``expected_label_launches``,
   ``NodeClassificationWithCorrectAndSmooth`` (SGC(3)),
   ``NodeClassificationWithLabelUse`` (SGC(2) at width 128 + 64), the
   ``Predictor`` of the C&S task saved, loaded and asked for 1, 7, 1000 and
   all ids, ``NodeClusteringNAFS`` and ``LinkPredictionNAFS`` (20 hops, six
   r, KMeans on the card) and ``LinkPredictionGAE`` (SGC(3) to width 64);
   one hop's KMeans alone; K1 at the label widths (3, 47, 64) against its
   twin, timed beside its bound and ``torch.sparse.mm``; K1's gradient
   (one forward, one backward launch) against the CPU path and a float64
   ``Aᵀ(2Ax)``, both kernels timed; NAFS's product at R = 6, D = 128: R
   launches of K1 against the plain one-gather form, beside the bound of
   one R·D-wide pass;
9. the NARS path and graph classification on the card: first both
   families on small graphs (``SyntheticHeteroDataset(seed=1)``,
   ``SyntheticGraphClassification(200)``) against the port's CPU path (the
   subsets chosen, the features, the logits from the same weights, Fast
   NARS's subgraph weights); then, the launch counters set to 0 just
   before each run and read just after and held to
   ``expected_hetero_launches``, ``HeteroNodeClassification`` with
   ``Fast_NARS_SGC_WithLearnableWeights`` and ``NARS_SIGN`` on
   ``SyntheticHeteroDataset`` at a quarter of ogbn-mag's node counts (128
   features, 349 classes, hidden 512, three relation subsets of two, 3
   epochs in batches of 10,000), and ``GraphClassification`` with
   ``GraphSIGN`` (f32) and ``GraphSGC`` (bf16 precompute) on 40,000
   synthetic graphs (20 epochs); each run's host sampling, preprocess,
   epoch times and peak device memory; K1 and K2 at the NARS batch and at
   the graph-level batch against their twin, timed beside their bound and
   ``torch.sparse.mm``;
10. out of core (``sgl_tpu_torch/kernels/spmm_ooc.py``): every form on
   a small graph (``random_power_law_graph(3_000, 8, 64, seed=0)``; 1-D,
   2-D at ``src_blocks`` 1, 2 and 3, the resident executor; f32 and bf16)
   against the port's CPU path and the one-shot ``spmm_csr``, two runs
   bit-equal; then one hop on phase 5's products graph in each of 1-D f32,
   2-D f32, 2-D bf16 and 2-D f32 at ``src_blocks=1``, and the resident
   executor, each held against phase 5's streaming hop of its dtype (f32
   also against phase 5's float64 sum) within ``ORDER_TOL``, its launches
   held to ``expected_ooc_launches`` (one a part or non-empty cell, a
   fix-up for each with a long row), with its layout, cold build and warm
   cache load, transfer bytes, hop, ``null_transfer``, plain pinned
   copies, the host's split of a hop, the overlap share and the card's
   trace (counted only when complete), and its kernel launches alone, each
   held against the plain twin on the same inputs (``TOL``), beside their
   bound, the twin and ``torch.sparse.mm``; then
   ``papers100m_pipeline.main`` at its defaults into a temporary store, its
   launches held, the stored hops against ``GraphOp.propagate`` (K1) and a
   float64 product, training from the store, peak device memory below the
   hop stack's size;
11. NAS (``sgl_tpu_torch.search``) on the card: first one arch of each
   message type on a small graph (``PlantedPartition``) through a
   propagation cache, features, logits and post-processed output against
   the port's CPU path; then OGB raw files at ogbn-arxiv's shape
   (169,343 nodes, 1,166,243 edges, 128 features, 40 classes, the time
   split) written from a seed into a temporary directory, the native csv
   parser against ``numpy.loadtxt`` on the edge and label files (the run
   fails without the parser), and ``Ogbn("arxiv", root)``; then
   ``examples/test_nas.py``'s search, ``run_nas`` (12 trials, the
   evolutionary search where OpenBox is absent) and ``run_sha`` (9
   archs, eta 3), the launch counters set to 0 just before each run and
   read just after, held to ``expected_nas_launches``; one trial of the
   best arch traced on the warm cache (the card's busy and idle share, its
   device time by kernel); the cache's stacks
   against ``GraphOp.propagate``; ``HopCheckpointer.propagate_resumable``
   stopped and resumed, bit-equal to an uninterrupted run;
12. the distributed runtime (``sgl_tpu_torch/parallel``): on phase 5's
   products graph at P = 4, ``ring_bucket_work_time`` (the port of
   ``spmm_dist.py:132``) f32 and bf16, its K3/K4 launches held, each
   bucket's listed rows and the empty rows its launch drops, and each
   of the 16 buckets' launch against its plain twin, timed alone beside
   its bound, the twin and ``torch.sparse.mm`` on the bucket; then
   ``NodeClassificationDist`` on the main path's dataset and widths through
   ``sgl_tpu_torch.dev.dist_worker`` (``spmm_dist.py:777``'s port, one
   process a rank): NCCL at one rank on a (1, 1) mesh, gloo at two ranks
   on (1, 2) and four on (2, 2) with every rank on cuda:0 (the ring's blocks
   through pinned host copies), GAMLP f32 in each, SGC with the bf16
   precompute at two ranks, and the ring alone at four ranks on (1, 4);
   each rank's K3/K4 launches held to the layout's count (a bucket a hop,
   a fix-up for each bucket with a long row), its hop stack against the
   single-device ``spmm_csr`` hops and a float64 propagation, the test
   accuracy the same on every rank, the first data-parallel step's loss
   and gradients against the one-rank run's; kernel and transfer ms a
   ring step, ms a step;
13. the dataset loaders and the examples (``sgl_tpu_torch/datasets``,
   ``sgl_tpu_torch/examples``): raw files of every loader's format written
   from a seed (``datasets.raw_files``) into a temporary directory, no
   network; every loader at a few hundred nodes (Reddit's zip and NELL's
   tarball unpacked by the loader) with SGC(2) through its task on the
   card, K1's launches counted, the logits against the CPU path from the
   same weights; Flickr at its published shape (89,250 nodes, 899,756
   stored nonzeros, 500 features, 7 classes), its hops against the CPU
   path at full size and K1 at D = 500; ``set_default_backend`` on Flickr's
   hop ("segment" launches no K1); the six examples' ``main`` on the card
   (sgc_pubmed on Planetoid files at pubmed's shape, the rest on their
   fallbacks with ``urlopen`` stubbed out) and the papers100M pipeline's
   ``--data`` on OGB files; then Reddit at its published shape (232,965
   nodes, 114,615,892 stored nonzeros, 602 features, 41 classes): the
   files' write, ``Reddit(root)`` and ``Graph.from_coo`` timed, SGC(2)
   and GAMLP (hidden 512, 3 layers) for 5 epochs each with their launches
   held, the first hop against a float64 sum over 1,025 rows (the longest
   among them), and K1 at D = 602 against the plain version by blocks of
   rows, timed beside its bound and ``torch.sparse.mm``; each K1 shape
   with its column panels (``spmm_csr.panel_columns``) and its time over
   ``torch.sparse.mm``'s;
14. the clustering plots (``clustering_metrics.plotClusters``): Planetoid
   files at pubmed's shape written from a seed, NAFS's "simple" smoothing
   at ``PLOT_HOPS`` hops on the card, its K1 launches held to the hop
   count, then ``plotClusters`` on those features (the port's t-SNE on the
   card, its PNG on the host; no K1 launch); the conditional P of 1,024
   sampled rows against a float64 computation on the CPU
   (``PLOT_P_TOL``), the gradient at those rows at the PCA init and at the
   final embedding against a float64 sum over all points on the CPU
   (``PLOT_GRAD_TOL``), the final KL below the KL after the exploration,
   the PNG read back at 768 × 576 with every class colour in it; the kNN,
   P, PCA and descent times, the time an iteration, the peak device memory
   and the trustworthiness (k = 10) of 2,000 sampled rows on the card,
   the phase held to ``PLOT_BUDGET_S``;
15. print one JSON line ``{"kernels": [...]}`` with each kernel's launches
   (for K1–K4 and D2–D6 also the fix-up's; for K1/K2 also phase 7's, as
   ``zoo_launches``, and phase 9's, as ``hetero_launches``, with their
   times at the two phase-9 batches; for K1 also phase 8's, as
   ``label_launches``, with its label widths, its gradient and the NAFS
   product, and phase 11's, as ``nas_launches``; for K3/K4 phase 10's, as
   ``ooc_launches``, with each form's hop times, and phase 12's, as
   ``ring_launches`` and ``ring_work``; for K1 phase 13's, as
   ``loader_launches``, with its times at Reddit's and Flickr's shapes
   under ``shapes``, and phase 14's, as ``plot_launches``), errors and
   times beside its bound;
16. print ``{"ok": true, "device": {...}}`` as the last line.

It needs a CUDA device and the repository's ``sgl_tpu_torch`` package next
to it, and exits non-zero without printing a result when either is missing.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# CUDA-event medians, (max abs, max rel) errors and the H100 SXM's published
# HBM3 bandwidth: the helpers the ported dev/ harnesses time and compare with
from sgl_tpu_torch.datasets import raw_files
from sgl_tpu_torch.dev import HBM_BYTES_PER_S, rel_err, time_ms
from sgl_tpu_torch.dev.ooc_probe import copy_ms, device_overlap, host_split

# H100 SXM published f32 peak outside the tensor cores (NVIDIA data sheet;
# the kernels sum in f32 for both dtypes)
F32_FLOPS = 67e12
REPLACES = "sgl_tpu/kernels/pallas_spmm.py:466"
REPLACES_ACC = "sgl_tpu/kernels/pallas_spmm.py:544"
SOURCE = "sgl_tpu_torch/kernels/csrc/spmm_csr.cu"
# f32: the twin adds each row's messages in the kernel's order (a long row
# as its segments' partial sums, added in segment order), so the two differ
# only by the kernel's fused multiply-add; bf16: one output rounding
# (2^-8).  The f32 accumulator itself is held to the f32 limit for both.
TOL = {"f32": 1e-5, "bf16": 1e-2}
# streaming against one-shot at products scale (``split_order_check``)
ORDER_TOL = {"f32": 1e-4, "bf16": 1e-2}
# the f32 kernel against a float64 sum at the main-path shape, whose hub row
# holds 196,747 nonzeros: no sequential f32 sum spans more than a segment;
# phase 6 holds every segment-reduce form to it at the bench shape (a hub
# row of 484,644 messages), whose sums span at most a tile of messages
F64_TOL = 1e-5
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# the SpMM bench graph of bench.py:115, and the part size of its streaming
# section (bench.py:185): 5 parts
BENCH_GRAPH = dict(num_nodes=200_000, avg_degree=25, feat_dim=128, seed=0)
BENCH_PART_EDGES = 1 << 20
# the products-scale pipeline of examples/products_scale_demo.py
PRODUCTS = dict(n=2_400_000, avg_deg=25, d=100, hops=3, part_edges=6 << 20)
# phase 6: the dev/ harnesses' kernels.  Each segment-reduce instantiation
# is held against its twin on the messages of the harness variant named
# here (D2's on the bf16 features gathered, into a random accumulator at a
# row offset); D1 at its probe's shapes (dev/exp_gather_dma.py:97-103)
DEV_GRAPH = dict(n=200_000, avg_deg=25, d=128)
GATHER = dict(n=1 << 20, d=128, es=(1 << 18, 1 << 20))
DEV_VARIANT = {"bf16_acc": "b", "bf16_hilo": "factored", "f32": "factored_f32",
               "bf16_hilo_w2": "packed", "f32_w2": "a", "bf16_w": "b"}
D2_ROW_OFFSET = 256
# D1's probe is run this many more times back to back after the counted run
D1_REPEATS = 5
# phase 7: the main path's dataset and widths (bench.py:246-247), 5 epochs
ZOO_DATASET = dict(num_nodes=100_000, avg_degree=20, feat_dim=128, num_classes=64, seed=1)
ZOO_HIDDEN, ZOO_LAYERS, ZOO_EPOCHS = 512, 3, 5
# the host normalization against the card's, elementwise relative: one
# powf rounding on each side
HOST_NORM_TOL = 1e-6
# kernel vs twin, of max|y|, for every form: the same messages summed in f32
# in the same order (products of bf16 inputs are exact in f32), so only the
# kernel's fused multiply-adds inside one message differ; D1: two f32 orders
# of one sum over 2^20 rows
DEV_TOL = 1e-5
SEGMENT_SOURCE = "sgl_tpu_torch/kernels/csrc/segment_reduce.cu"
DEV_REPLACES = {
    "bf16_acc": "dev/exp_acc_alias.py:56",
    "bf16_hilo": "dev/exp_spmm.py:100",
    "f32": "dev/exp_spmm.py:175",  # and D6 A' at :662
    "bf16_hilo_w2": "dev/exp_spmm.py:396",
    "f32_w2": "dev/exp_spmm.py:662",
    "bf16_w": "dev/exp_spmm.py:662",
    "gather_sum": "dev/exp_gather_dma.py:77",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def check(ok, msg) -> None:
    if not ok:
        raise RuntimeError(str(msg))


def f64_sum(adj, x):
    """The same product summed in float64, one part's messages at a time
    for a :class:`CsrParts`: what the f32 sums lose over long rows."""
    y = torch.zeros(x.shape, dtype=torch.float64, device=x.device)
    x64 = x.double()
    for p in getattr(adj, "parts", [adj]):
        rows = getattr(p, "row_offset", 0) + torch.repeat_interleave(
            torch.arange(p.rowptr.shape[0] - 1, device=x.device), torch.diff(p.rowptr.long())
        )
        y.index_add_(0, rows, x64.index_select(0, p.col.long()) * p.val.double()[:, None])
    return y


def describe_plan(plan, d: int, elem: int = 4) -> str:
    """A split plan in one phrase: its segment length, long rows, segments
    and f32 workspace at width ``d``, its listed rows (neither empty nor
    long: the accumulating form's row tasks), and the column panels the
    one-shot form takes at ``d`` columns of ``elem`` bytes
    (``spmm_csr.panel_columns``)."""
    from sgl_tpu_torch.kernels.spmm_csr import panel_columns

    n = plan.rowptr.shape[0] - 1
    panel = panel_columns(n, d, elem)
    panels = ("no panels" if panel >= d else
              f"{-(-d // panel)} panels of {panel} columns ({n * panel * elem / 1e6:.1f} MB of x each)")
    return (f"segments of {plan.split} nonzeros: {plan.num_long} long rows in {plan.num_segments} "
            f"segments, workspace {plan.workspace_bytes(d) / 1e6:.3f} MB; {plan.num_listed} listed rows; "
            f"{panels}")


def check_repeatable(fn, where: str) -> None:
    """Two runs of ``fn`` give the same bits: no atomics, a fixed order."""
    first, second = fn(), fn()
    check(torch.equal(first, second), f"{where}: two runs differ")


def compare(adj, x, key: str, where: str, against_f64: bool = True) -> tuple:
    """The kernel against its plain twin on the same inputs; raises past
    ``TOL``.  Returns (max abs err, max rel err, max rel err against the
    float64 sum, or None without ``against_f64``: its E·D float64 messages
    are 30 GB at the NARS batch)."""
    from sgl_tpu_torch.kernels import spmm_csr, spmm_csr_reference

    y_k = spmm_csr(adj, x)
    y_ref = spmm_csr_reference(adj, x)
    torch.cuda.synchronize()
    check(y_k.dtype == x.dtype and y_k.shape == x.shape, f"{key}: {y_k.dtype} {tuple(y_k.shape)}")
    check(torch.isfinite(y_k.float()).all().item(), f"{key}: non-finite kernel output")
    abs_err, rel = rel_err(y_k, y_ref)
    check(rel <= TOL[key], f"spmm_csr {key} disagrees with its plain twin at {where}: {rel:.3e}")
    return abs_err, rel, rel_err(y_k, f64_sum(adj, x))[1] if against_f64 else None


def kernel_phase(dev):
    from sgl_tpu_torch.datasets import random_power_law_graph
    from sgl_tpu_torch.graph import symmetric_normalized_weights
    from sgl_tpu_torch.kernels import prepare_csr, spmm_csr, spmm_csr_reference

    t = time.perf_counter()
    g = random_power_law_graph(**BENCH_GRAPH)
    adj = prepare_csr(symmetric_normalized_weights(g, device=dev))
    n, e, d = adj.num_nodes, adj.nnz, g.num_features
    log(f"[2] bench graph: {n} nodes, {e} nonzeros (with self-loops), d={d} "
        f"({time.perf_counter() - t:.2f} s to build); plan: {describe_plan(adj.plan, d)}")
    x32 = torch.as_tensor(g.x, device=dev)
    results = {}
    for key, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = x32.to(dtype)
        abs_err, rel, rel64 = compare(adj, x, key, "the bench shape")
        check_repeatable(lambda: spmm_csr(adj, x), f"spmm_csr {key} at the bench shape")
        ms = time_ms(lambda: spmm_csr(adj, x))
        plain_ms = time_ms(lambda: spmm_csr_reference(adj, x))
        library_ms, lib_note = library_time(adj, x, spmm_csr_reference(adj, x))
        b = csr_bound(n, e, d, x.element_size())
        nbytes = b.pop("nbytes")
        results[key] = dict(abs_err=abs_err, rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **b)
        log(f"[2] spmm_csr {key}: max abs err {abs_err:.3e}, max rel err {rel:.3e} "
            f"(limit {TOL[key]:.0e}; vs an f64 sum {rel64:.3e}); kernel {ms:.4f} ms/hop = {e / ms / 1e6:.3f} G edges/s; "
            f"plain twin {plain_ms:.4f} ms; bound {results[key]['bound_ms']:.4f} ms "
            f"({nbytes / 1e6:.1f} MB at 3.35 TB/s; ops {2 * e * d / F32_FLOPS * 1e3:.4f} ms); "
            f"library {lib_note}; two runs bit-equal")
    skew_probe(dev, adj, x32, results["f32"]["ms"])
    row_order_probe(adj, x32)
    return results


def bound(nbytes: int, e: int, d: int) -> dict:
    """The least time for the work: ``nbytes`` at the HBM rate or the
    2·E·D f32 operations at the f32 rate, whichever is longer."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * e * d / F32_FLOPS * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def library_time(adj, x, want, warmup: int = 3, iters: int = 20) -> tuple:
    """``torch.sparse.mm`` (cuSPARSE) on the same matrix and features, the
    yardstick only: (median ms or None, a note for the log with its error
    against ``want``)."""
    n = adj.num_nodes
    try:
        # columns are not sorted within a row (each self-loop comes last),
        # which the invariant check would refuse and cuSPARSE accepts
        a = torch.sparse_csr_tensor(
            adj.rowptr, adj.col, adj.val.to(x.dtype), size=(n, n), check_invariants=False
        )
        lib_rel = rel_err(torch.sparse.mm(a, x), want)[1]
        library_ms = time_ms(lambda: torch.sparse.mm(a, x), warmup=warmup, iters=iters)
        return library_ms, f"{library_ms:.4f} ms (max rel err {lib_rel:.2e})"
    except (RuntimeError, NotImplementedError) as exc:  # the yardstick only
        return None, f"not supported for {x.dtype}: {type(exc).__name__}: {exc}"


def skew_probe(dev, adj, x, kernel_ms):
    """Where the f32 kernel's time goes on the power-law graph: its longest
    row alone (every other row empty; a CSR built by hand, so its plan is
    made on first use), against ``kernel_ms`` for the whole graph; the same
    row as a one-row part of the accumulating form, which writes no other
    row; and a degree-uniform graph with the same node count and average
    degree (``alpha=0``)."""
    from sgl_tpu_torch.datasets import random_power_law_graph
    from sgl_tpu_torch.graph import symmetric_normalized_weights
    from sgl_tpu_torch.kernels import CsrAdj, CsrPart, prepare_csr, spmm_csr, spmm_csr_acc

    lengths = torch.diff(adj.rowptr.long())
    top = int(lengths.argmax())
    beg, end = int(adj.rowptr[top]), int(adj.rowptr[top + 1])
    rowptr = torch.zeros_like(adj.rowptr)
    rowptr[top + 1:] = end - beg
    hub = CsrAdj(rowptr, adj.col[beg:end].contiguous(), adj.val[beg:end].contiguous(), adj.num_nodes)
    hub_ms = time_ms(lambda: spmm_csr(hub, x))
    row = CsrPart(torch.tensor([0, end - beg], dtype=torch.int32, device=dev), hub.col, hub.val,
                  top, 1, adj.num_nodes)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=dev)
    row_ms = time_ms(lambda: spmm_csr_acc(row, x, acc))
    g = random_power_law_graph(adj.num_nodes, 25, x.shape[1], seed=0, alpha=0.0)
    uni = prepare_csr(symmetric_normalized_weights(g, device=dev))
    xu = torch.as_tensor(g.x, device=dev)
    uni_ms = time_ms(lambda: spmm_csr(uni, xu))
    log(f"[2] skew probe f32: longest row {top} holds {end - beg} of {adj.nnz} nonzeros "
        f"(mean row {adj.nnz / adj.num_nodes:.1f}); that row alone {hub_ms:.4f} ms, "
        f"{hub_ms / kernel_ms:.1%} of the whole kernel's {kernel_ms:.4f} ms; as a one-row part "
        f"(accumulating form, no other row written) {row_ms:.4f} ms, {row_ms / kernel_ms:.1%}; "
        f"degree-uniform graph ({uni.nnz} nonzeros, longest row {int(torch.diff(uni.rowptr.long()).max())}) "
        f"{uni_ms:.4f} ms")


def row_order_probe(adj, x32) -> None:
    """What the order of the nonzeros within a row costs the CSR kernel:
    the graph as built (above 1M edges each row keeps the input order, as
    ``sgl_tpu`` keeps it) against the same CSR with each row sorted by
    source (the order ``lexsort`` gives smaller graphs), timed in turns
    (as built, sorted, sorted, as built) in this one call."""
    from sgl_tpu_torch.kernels import CsrAdj, spmm_csr

    rows = torch.repeat_interleave(torch.arange(adj.num_nodes, device=x32.device),
                                   torch.diff(adj.rowptr.long()))
    order = torch.argsort(rows * adj.num_nodes + adj.col.long())
    by_src = CsrAdj(adj.rowptr, adj.col[order].contiguous(), adj.val[order].contiguous(), adj.num_nodes,
                    adj.plan)
    for key, dtype in DTYPES.items():
        x = x32.to(dtype)
        err = rel_err(spmm_csr(by_src, x), spmm_csr(adj, x))[1]
        check(err <= TOL[key], f"[2] row order probe {key}: the two orders differ by {err:.3e}")
        built, by_src_ms = [], []
        for csr, out in ((adj, built), (by_src, by_src_ms), (by_src, by_src_ms), (adj, built)):
            out.append(time_ms(lambda: spmm_csr(csr, x)))
        log(f"[2] row order probe {key}: rows as built {[round(t, 4) for t in built]} ms, each row "
            f"sorted by source {[round(t, 4) for t in by_src_ms]} ms (in turns, one call); the two "
            f"orders' outputs differ by {err:.3e} of max|y|")


def main_path_phase(dev):
    from sgl_tpu_torch.datasets import SyntheticPowerLaw
    from sgl_tpu_torch.graph import symmetric_normalized_weights
    from sgl_tpu_torch.kernels import prepare_csr, spmm_csr
    from sgl_tpu_torch.models import GAMLP, SGC
    from sgl_tpu_torch.tasks import NodeClassification

    t = time.perf_counter()
    ds = SyntheticPowerLaw(num_nodes=100_000, avg_degree=20, feat_dim=128, num_classes=64, seed=1)
    log(f"[3] dataset: {ds.num_node} nodes, {ds.graph.num_edges} edges, "
        f"{ds.num_features} features, {ds.num_classes} classes "
        f"({time.perf_counter() - t:.2f} s to build)")
    runs = (
        ("GAMLP f32", "f32", None,
         lambda: GAMLP(3, ds.num_features, ds.num_classes, hidden_dim=512, num_layers=3)),
        ("SGC bf16", "bf16", torch.bfloat16,
         lambda: SGC(3, ds.num_features, ds.num_classes)),
    )
    # the first pass's launches by instantiation, and the fix-up's as "fixup_<key>"
    launches = {"f32": 0, "bf16": 0, "fixup_f32": 0, "fixup_bf16": 0}
    for name, key, pdtype, make in runs:
        model = make()
        reset_launches()
        task = NodeClassification(
            ds, model, lr=0.1, weight_decay=5e-5, epochs=5, verbose=False,
            precompute_dtype=pdtype,
        )
        counts = dict(spmm_csr.launches)
        fixups = dict(spmm_csr.fixup_launches)
        for k in ("f32", "bf16"):
            launches[k] += counts[k]
            launches["fixup_" + k] += fixups[k]
        pf = model.processed_feature
        check(pf.is_cuda and torch.isfinite(pf.float()).all().item(), f"{name}: bad features")
        check(counts[key] >= 3, f"{name}: the {key} kernel ran {counts[key]} times, expected >= 3")
        # the graph's hub rows are long: every product runs the fix-up too
        check(fixups[key] == counts[key], f"{name}: {fixups[key]} fix-ups for {counts[key]} products")
        check(0.0 <= task.test_acc <= 1.0, f"{name}: test accuracy {task.test_acc}")
        epochs_ms = [s * 1e3 for s in task.epoch_seconds]
        log(f"[3] {name}: launches {counts}, fix-up launches {fixups}; features {tuple(pf.shape)} {pf.dtype}; "
            f"preprocess {task.preprocess_seconds:.4f} s; train epoch ms {[round(m, 3) for m in epochs_ms]} "
            f"(median {statistics.median(epochs_ms):.3f}); best-val test acc {task.test_acc:.4f}")

    # each kernel against its twin at the shape the main path gave it (the
    # adjacency its LaplacianGraphOp(r=0.5) built), after the counts were read
    adj = prepare_csr(symmetric_normalized_weights(ds.graph, device=dev))
    x32 = torch.as_tensor(ds.x, device=dev)
    errs = {}
    for key, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = x32.to(dtype)
        errs[key] = compare(adj, x, key, "the main-path shape")
        if key == "f32":
            check(errs[key][2] <= F64_TOL, f"spmm_csr f32 vs a float64 sum at the main-path shape: "
                                           f"{errs[key][2]:.3e} (limit {F64_TOL:.0e})")
        ms = time_ms(lambda: spmm_csr(adj, x))
        log(f"[3] spmm_csr {key} at the main-path shape ({adj.num_nodes} nodes, {adj.nnz} nonzeros, "
            f"d={x.shape[1]}, longest row {int(torch.diff(adj.rowptr.long()).max())}; plan: "
            f"{describe_plan(adj.plan, x.shape[1], x.element_size())}): max abs err {errs[key][0]:.3e}, max rel err "
            f"{errs[key][1]:.3e} (vs an f64 sum {errs[key][2]:.3e}"
            f"{f', limit {F64_TOL:.0e}' if key == 'f32' else ''}); kernel {ms:.4f} ms/hop")
    return launches, errs


def reference_check_phase(dev):
    """Small graph: the CUDA path against the port's CPU path."""
    from sgl_tpu_torch.datasets import PlantedPartition
    from sgl_tpu_torch.models import SGC
    from sgl_tpu_torch.ops import LaplacianGraphOp
    from sgl_tpu_torch.tasks import NodeClassification

    ds = PlantedPartition()
    op = LaplacianGraphOp(3)
    want = op.propagate(ds.graph, ds.x, device="cpu")
    got = op.propagate(ds.graph, ds.x, device=dev).cpu()
    check(got.shape == want.shape == (4, ds.num_node, ds.num_features), tuple(got.shape))
    err = rel_err(got, want)[1]
    check(err <= 1e-5, f"CUDA hops disagree with the CPU path: {err:.3e}")
    accs = {
        d: NodeClassification(ds, SGC(3, ds.num_features, ds.num_classes), lr=0.1,
                              weight_decay=5e-5, epochs=50, verbose=False, device=d).test_acc
        for d in ("cuda", "cpu")
    }
    check(accs["cuda"] >= 0.8, accs)
    log(f"[3] small graph check: hops max rel err vs CPU path {err:.3e}; SGC test acc {accs}")


def ptxas_summary(log_text: str) -> list:
    """One line per kernel entry of ``ptxas -v``'s log: its name and
    template arguments (the mangled name's: ``13__nv_bfloat16fLi4ELb1E`` is
    bf16 in, f32 out, VEC 4, accumulate; ``S1_`` repeats the first type),
    registers, static shared memory (the dynamic ring is sized at launch)
    and spill bytes."""
    lines, name, spill = [], None, ""
    for line in log_text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            # the name follows its length in the mangled name
            args = re.search(r"(?<=\d)([a-z_]+_kernel)I(\w+?)EEv", entry.group(1))
            name = f"{args.group(1)}<{args.group(2)}>" if args else entry.group(1)
        elif name and "spill stores" in line:
            spill = re.sub(r".*?(\d+) bytes spill stores, (\d+) bytes spill loads.*",
                           r"spill \1 B stored / \2 B loaded", line.strip())
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            lines.append(f"{name}: {regs} registers, {smem.group(1) if smem else 0} B static shared "
                         f"memory, {spill}")
            name, spill = None, ""
    return lines


def reset_launches() -> None:
    from sgl_tpu_torch.kernels import spmm_csr

    for counts in (spmm_csr.launches, spmm_csr.fixup_launches):
        for k in counts:
            counts[k] = 0


def stream_bytes(parts, x) -> int:
    """Compulsory bytes of one streaming product: every part's row pointer,
    col and val, x read once, the f32 accumulator read and written once."""
    n, d = x.shape
    return 4 * (n + len(parts)) + 8 * parts.nnz + n * d * x.element_size() + 2 * n * d * 4


def describe_parts(parts) -> str:
    """Each part's nonzeros, rows, longest row and plan, and how many rows
    are cut between consecutive parts."""
    pairs = zip(parts.parts[:-1], parts.parts[1:])
    cut = sum(a.row_offset + a.num_rows - 1 == b.row_offset for a, b in pairs)
    return (f"nonzeros {[p.nnz for p in parts]}, rows "
            f"{[(p.row_offset, p.row_offset + p.num_rows) for p in parts]}, longest rows "
            f"{[int(torch.diff(p.rowptr.long()).max()) for p in parts]}, "
            f"{cut} of {len(parts) - 1} boundaries inside a row; plans (segments of "
            f"{parts.parts[0].plan.split}): long rows {[p.plan.num_long for p in parts]}, segments "
            f"{[p.plan.num_segments for p in parts]}")


def check_accumulate(part, x, where: str) -> tuple:
    """The accumulate contract on the card: a random non-zero ``acc``; rows
    the part does not touch keep it bit for bit, the rest equal ``acc``
    plus the part's sum (the twin's) within the f32 limit.  Returns (max
    abs err, max rel err)."""
    from sgl_tpu_torch.kernels import spmm_csr_acc, spmm_csr_acc_reference

    n, d = x.shape
    gen = torch.Generator(x.device).manual_seed(0)
    acc0 = torch.randn(n, d, device=x.device, generator=gen)
    got = spmm_csr_acc(part, x, acc0.clone())
    want = spmm_csr_acc_reference(part, x, acc0.clone())
    torch.cuda.synchronize()
    lo, hi = part.row_offset, part.row_offset + part.num_rows
    touched = torch.zeros(n, dtype=torch.bool, device=x.device)
    touched[lo:hi] = torch.diff(part.rowptr) > 0
    outside = torch.ones(n, dtype=torch.bool, device=x.device)
    outside[lo:hi] = False
    check(torch.equal(got[outside], acc0[outside]), f"{where}: rows outside the part changed")
    check(torch.equal(got[~touched], acc0[~touched]), f"{where}: untouched rows changed")
    abs_err, rel = rel_err(got[touched], want[touched])
    check(rel <= TOL["f32"], f"{where}: accumulator vs twin {rel:.3e}")
    log(f"{where}: part rows [{lo}, {hi}) of {n}, {part.nnz} nonzeros; rows outside the part "
        f"bit-exact ({int(outside.sum())}), untouched rows inside bit-exact "
        f"({int((~touched).sum()) - int(outside.sum())}); touched rows vs acc + twin's sum: "
        f"max abs err {abs_err:.3e}, max rel err {rel:.3e}")
    return abs_err, rel


def part_times_ms(parts, x) -> list:
    """Each part's accumulating launch alone, CUDA events, one pass."""
    from sgl_tpu_torch.kernels import spmm_csr_acc

    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(parts) + 1)]
    torch.cuda.synchronize()
    events[0].record()
    for part, ev in zip(parts, events[1:]):
        spmm_csr_acc(part, x, acc)
        ev.record()
    events[-1].synchronize()
    return [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]


def streaming_bench_phase(dev, bench):
    """Streaming SpMM at the bench shape, 5 parts of <= 1 << 20 nonzeros."""
    from sgl_tpu_torch.datasets import random_power_law_graph
    from sgl_tpu_torch.graph import symmetric_normalized_weights
    from sgl_tpu_torch.kernels import (
        prepare_csr, prepare_csr_parts, spmm_csr, spmm_csr_streaming, spmm_csr_streaming_reference,
    )

    g = random_power_law_graph(**BENCH_GRAPH)
    adj = prepare_csr(symmetric_normalized_weights(g, device=dev))
    parts = prepare_csr_parts(adj, BENCH_PART_EDGES)
    check(len(parts) == -(-adj.nnz // BENCH_PART_EDGES), f"bench shape split into {len(parts)} parts")
    log(f"[4] bench graph in {len(parts)} parts: {describe_parts(parts)}")
    x32 = torch.as_tensor(g.x, device=dev)
    results = {}
    for key, dtype in DTYPES.items():
        x = x32.to(dtype)
        y = spmm_csr_streaming(parts, x)
        twin = spmm_csr_streaming_reference(parts, x)
        one_shot = spmm_csr(adj, x)
        torch.cuda.synchronize()
        check(y.dtype == dtype and y.shape == x.shape, f"streaming {key}: {y.dtype} {tuple(y.shape)}")
        check(torch.isfinite(y.float()).all().item(), f"streaming {key}: non-finite output")
        abs_t, rel_t = rel_err(y, twin)
        abs_o, rel_o = rel_err(y, one_shot)
        check(rel_t <= TOL[key], f"streaming {key} vs its twin at the bench shape: {rel_t:.3e}")
        check(rel_o <= TOL[key], f"streaming {key} vs one-shot at the bench shape: {rel_o:.3e}")
        check_repeatable(lambda: spmm_csr_streaming(parts, x), f"streaming {key} at the bench shape")
        rel64 = rel_err(y, f64_sum(parts, x))[1]
        del twin, one_shot
        acc_abs, acc_rel = check_accumulate(parts.parts[len(parts) // 2], x, f"[4] acc_{key} contract")
        # each part's launch alone, then the whole call, then the twin
        per_part = part_times_ms(parts, x)
        call_ms = time_ms(lambda: spmm_csr_streaming(parts, x), warmup=2, iters=10)
        plain_ms = time_ms(lambda: spmm_csr_streaming_reference(parts, x), warmup=1, iters=3)
        b = bound(stream_bytes(parts, x), parts.nnz, x.shape[1])
        results[key] = dict(
            abs_err=max(abs_t, acc_abs), rel_err=max(rel_t, acc_rel), ms=sum(per_part),
            call_ms=call_ms, plain_ms=plain_ms, library_ms=bench[key]["library_ms"], **b,
        )
        log(f"[4] streaming {key}: vs twin max abs err {abs_t:.3e}, max rel err {rel_t:.3e}; "
            f"vs one-shot spmm_csr max rel err {rel_o:.3e} (limit {TOL[key]:.0e}); vs an f64 sum "
            f"{rel64:.3e}; two runs bit-equal; "
            f"acc_{key} launches {sum(per_part):.4f} ms (per part {[round(t, 4) for t in per_part]}); "
            f"spmm_csr_streaming call {call_ms:.4f} ms; plain twin {plain_ms:.4f} ms; "
            f"bound {b['bound_ms']:.4f} ms ({stream_bytes(parts, x) / 1e6:.1f} MB at 3.35 TB/s, "
            f"ops {2 * parts.nnz * x.shape[1] / F32_FLOPS * 1e3:.4f} ms); "
            f"library (torch.sparse.mm, phase 2) {bench[key]['library_ms']}")
    return results



def split_order_check(adj, streamed, one_shot, x, where: str) -> str:
    """Streaming against one-shot where rows of millions of nonzeros are cut
    between parts: a cut row sums its shares apart, each share cut into
    segments from its own first nonzero, so the two add the same terms in
    two f32 orders.  They are held to ``ORDER_TOL``, which a wrong part
    still breaks by orders of magnitude.  The worst row is summed in
    float64 to show how far each is from exact.  Returns a note for the
    log."""
    abs_o, rel_o = rel_err(streamed, one_shot)
    key = "bf16" if x.dtype == torch.bfloat16 else "f32"
    check(rel_o <= ORDER_TOL[key], f"{where}: streaming vs one-shot spmm_csr {rel_o:.3e}")
    row = int((streamed.float() - one_shot.float()).abs().amax(1).argmax())
    beg, end = int(adj.rowptr[row]), int(adj.rowptr[row + 1])
    exact = (x[adj.col[beg:end].long()].double() * adj.val[beg:end].double()[:, None]).sum(0)
    scale = one_shot.double().abs().max().item()
    off = [(y[row].double() - exact).abs().max().item() / scale for y in (streamed, one_shot)]
    return (f"vs one-shot spmm_csr max abs err {abs_o:.3e}, max rel err {rel_o:.3e} "
            f"(limit {ORDER_TOL[key]:.0e}); at the row where they differ most ({row}, {end - beg} "
            f"nonzeros) streaming is {off[0]:.3e} and one-shot {off[1]:.3e} of max|y| from a float64 sum")


def products_phase(dev):
    """The products-scale pipeline through its entry point, f32 with GAMLP
    training and bf16 precompute only; then one hop of each against the
    streaming twin and the one-shot kernel, each part's launch and the
    one-shot kernel timed, and the library yardstick."""
    from sgl_tpu_torch.examples import products_scale_demo
    from sgl_tpu_torch.kernels import spmm_csr, spmm_csr_streaming_reference

    # the same pipeline at a small size, on the card and on the CPU
    small = dict(n=3000, avg_deg=10, d=16, hops=3, part_edges=2048)
    got = products_scale_demo.main(**small, device=dev)["hops"].cpu()
    want = products_scale_demo.main(**small, device="cpu")["hops"]
    err = rel_err(got, want)[1]
    check(err <= TOL["f32"], f"small pipeline: CUDA hops vs the CPU path {err:.3e}")
    log(f"[5] small pipeline ({small}): CUDA hop stack vs the CPU path max rel err {err:.3e}")

    results, graph, refs = {}, None, {}
    for key, dtype, train in (("f32", None, True), ("bf16", torch.bfloat16, False)):
        reset_launches()
        t = time.perf_counter()
        out = products_scale_demo.main(**PRODUCTS, dtype=dtype, train=train)
        wall = time.perf_counter() - t
        if graph is None:
            graph = out["graph"]  # phase 7 normalizes the f32 run's graph on the host
        counts, fixups = dict(spmm_csr.launches), dict(spmm_csr.fixup_launches)
        parts, stack = out["parts"], out["hops"]
        want_counts = {k: 0 for k in counts}
        want_counts["acc_" + key] = PRODUCTS["hops"] * len(parts)
        check(counts == want_counts, f"products {key}: launches {counts}, expected {want_counts}")
        # one fix-up per hop for each part that holds a long row
        want_fixups = {k: 0 for k in fixups}
        want_fixups["acc_" + key] = PRODUCTS["hops"] * sum(p.plan.num_long > 0 for p in parts)
        check(fixups == want_fixups and want_fixups["acc_" + key] > 0,
              f"products {key}: fix-up launches {fixups}, expected {want_fixups}")
        check(stack.shape == (PRODUCTS["hops"] + 1, PRODUCTS["n"], PRODUCTS["d"]), tuple(stack.shape))
        check(torch.isfinite(stack.float()).all().item(), f"products {key}: non-finite hops")
        hop_s = out["hop_seconds"]
        steady = min(hop_s[1:])
        log(f"[5] products {key}: launches {counts} (hops x parts = {PRODUCTS['hops']} x {len(parts)}), "
            f"fix-up launches {fixups}; "
            f"graph build {out['graph_seconds']:.4f} s; normalize + CSR + parts {out['prepare_seconds']:.4f} s; "
            f"{out['nnz']} nonzeros in {len(parts)} parts: {describe_parts(parts)}; "
            f"s/hop {[round(v, 6) for v in hop_s]} "
            f"-> {out['nnz'] / steady / 1e9:.6f} G nonzeros/s steady; pipeline wall {wall:.2f} s")
        if train:
            tr = out["train"]
            check(all(v == v and abs(v) < float("inf") for v in tr["losses"]), f"losses {tr['losses']}")
            log(f"[5] products {key} GAMLP(hidden 512, 3 layers, 47 classes): train "
                f"{tr['train_ms_per_step']:.4f} ms/step over {len(tr['losses']) - 2} steps after 2 warm-up; "
                f"eval forward over {PRODUCTS['n']} rows {tr['eval_ms']:.4f} ms; losses "
                f"{[round(v, 4) for v in tr['losses']]}")
        # one hop against the streaming twin (part by part: its memory is
        # one part's messages), timed once with CUDA events
        x = stack[0]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        twin = spmm_csr_streaming_reference(parts, x)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        abs_err, rel = rel_err(stack[1], twin)
        check(rel <= TOL[key], f"products {key}: hop 1 vs the streaming twin {rel:.3e}")
        del twin
        acc_abs, acc_rel = check_accumulate(parts.parts[len(parts) // 2], x, f"[5] products acc_{key} contract")
        per_part = part_times_ms(parts, x)
        # the one-shot kernel on the same CSR: what the split costs on this card
        one_shot = spmm_csr(out["csr"], x)
        order_note = split_order_check(out["csr"], stack[1], one_shot, x, f"products {key}")
        # phase 10 holds each out-of-core hop against this streaming hop
        refs[key] = stack[1].cpu()
        if key == "f32":
            exact = f64_sum(parts, x)
            order_note += (f"; vs an f64 sum: streaming {rel_err(stack[1], exact)[1]:.3e}, one-shot "
                           f"{rel_err(one_shot, exact)[1]:.3e}")
            refs["f64"] = exact.cpu()
            del exact
        del one_shot
        one_shot_ms = time_ms(lambda: spmm_csr(out["csr"], x), warmup=1, iters=3)
        library_ms, lib_note = library_time(out["csr"], x, stack[1], 1, 5)
        b = bound(stream_bytes(parts, x), parts.nnz, x.shape[1])
        log(f"[5] products {key}: hop 1 vs streaming twin max abs err {abs_err:.3e}, max rel err {rel:.3e} "
            f"(limit {TOL[key]:.0e}); {order_note}; acc_{key} launches alone {sum(per_part):.4f} ms "
            f"(per part {[round(t, 4) for t in per_part]}); one-shot spmm_csr {key} {one_shot_ms:.4f} ms "
            f"(plan: {describe_plan(out['csr'].plan, x.shape[1])}); plain twin {plain_ms:.4f} ms; "
            f"bound {b['bound_ms']:.4f} ms ({stream_bytes(parts, x) / 1e9:.4f} GB at 3.35 TB/s, "
            f"ops {2 * parts.nnz * x.shape[1] / F32_FLOPS * 1e3:.4f} ms); library {lib_note}")
        results[key] = dict(
            launches=counts["acc_" + key], fixup_launches=fixups["acc_" + key],
            abs_err=max(abs_err, acc_abs), rel_err=max(rel, acc_rel),
            ms=sum(per_part), plain_ms=plain_ms, library_ms=library_ms, **b,
        )
        del out, stack, x, parts
        torch.cuda.empty_cache()
    return results, graph, refs


def reset_dev_launches() -> None:
    from sgl_tpu_torch.kernels import gather_sum, segment_reduce

    for counts in (segment_reduce.launches, segment_reduce.fixup_launches, gather_sum.launches):
        for k in counts:
            counts[k] = 0


def segment_bound(m, kw, n: int, d: int, accumulate: bool) -> dict:
    """The least time of one segment reduce: ``4(N+1) + E·W·s_m + E·s_w +
    N·D·4`` bytes (the window read too when it accumulates) at the HBM
    rate, or its f32 operations (1, 2 or 6 per message element) at the f32
    rate, whichever is longer."""
    e, w = m.shape
    n_w = (kw.get("wh") is not None) + (kw.get("wl") is not None)
    nbytes = 4 * (n + 1) + e * w * m.element_size() + 2 * e * n_w + n * d * 4 * (2 if accumulate else 1)
    flops = e * d * {0: kw.get("halves", 1), 1: 2, 2: 6 if kw.get("halves", 1) == 2 else 2}[n_w]
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                nbytes=nbytes)


def dev_library_time(key, m, rowptr, kw, want) -> tuple:
    """One PyTorch call that computes form ``key`` on the same messages,
    the yardstick only: (median ms or None, a note with its error).
    ``f32``: ``torch.segment_reduce`` (sum over offsets); ``f32_w2``:
    ``torch.sparse.mm`` of the ``[N, E]`` CSR whose row r holds ``wh + wl``
    (exact in f32) at columns ``rowptr[r]`` .. ``rowptr[r+1]``, built
    outside the timed call, with ``m``.  The bf16 and two-half forms have
    none: no one call sums bf16 into f32 or adds two halves."""
    if key == "f32":
        name, offsets = "torch.segment_reduce", rowptr.long()
        call = lambda: torch.segment_reduce(m, "sum", offsets=offsets, axis=0)  # noqa: E731
    elif key == "f32_w2":
        e = m.shape[0]
        a = torch.sparse_csr_tensor(rowptr, torch.arange(e, dtype=torch.int32, device=m.device),
                                    kw["wh"].float() + kw["wl"].float(), size=(rowptr.shape[0] - 1, e),
                                    check_invariants=False)
        name = "torch.sparse.mm"
        call = lambda: torch.sparse.mm(a, m)  # noqa: E731
    else:
        return None, "no one PyTorch call computes this form"
    try:
        lib_rel = rel_err(call(), want)[1]
        ms = time_ms(call, warmup=1, iters=5)
        return ms, f"{name} {ms:.4f} ms (max rel err {lib_rel:.2e})"
    except (RuntimeError, NotImplementedError) as exc:  # the yardstick only
        return None, f"{name} failed: {type(exc).__name__}: {exc}"


def device_split(fn, iters: int = 5) -> dict:
    """Device time of one ``fn()`` by segment-reduce kernel, in ms, from
    ``torch.profiler`` (CUPTI) over ``iters`` calls: pass 1 apart from the
    fix-up, without the host's gaps between calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        name = re.search(r"segment_reduce\w*_kernel", ev.key)
        if name and ev.device_time_total > 0:
            split[name.group(0)] = round(split.get(name.group(0), 0.0) + ev.device_time_total / iters / 1e3, 4)
    return split


def f64_segment_sum(rowptr, m, kw):
    """The segment sum of the form's f32 messages in float64: what the f32
    sums lose, in any order."""
    from sgl_tpu_torch.kernels.segment_reduce import messages_f32

    e = int(rowptr[-1])
    wh, wl = (None if kw.get(k) is None else kw[k][:e] for k in ("wh", "wl"))
    msgs = messages_f32(m[:e], kw.get("halves", 1), wh, wl).double()
    rows = torch.repeat_interleave(torch.arange(rowptr.shape[0] - 1, device=m.device),
                                   torch.diff(rowptr.long()), output_size=e)
    y = torch.zeros((rowptr.shape[0] - 1, msgs.shape[1]), dtype=torch.float64, device=m.device)
    return y.index_add_(0, rows, msgs)


def dev_phase(dev):
    """The ports of the ``dev/`` harnesses (TPU kernels D1–D6) at the bench
    shape: their paths with the counters set to 0 just before and read just
    after, then each instantiation against its twin on the harness's own
    messages, timed beside its bound."""
    from sgl_tpu_torch.dev import exp_acc_alias, exp_gather_dma, exp_spmm
    from sgl_tpu_torch.kernels import gather_sum, segment_reduce, segment_reduce_reference
    from sgl_tpu_torch.kernels.segment_reduce import INSTANTIATIONS, TILE_MESSAGES, tiling

    t = time.perf_counter()
    g, csr = exp_spmm.make_graph(**DEV_GRAPH, device=dev)
    ops = exp_spmm.prepare(csr)
    x = torch.as_tensor(g.x, device=dev)
    n, d = x.shape
    # the hub row alone (every other row empty), for where the time goes
    lengths = torch.diff(csr.rowptr.long())
    top = int(lengths.argmax())
    beg, end = int(csr.rowptr[top]), int(csr.rowptr[top + 1])
    hub_rowptr = torch.zeros_like(csr.rowptr)
    hub_rowptr[top + 1:] = end - beg
    log(f"[6] bench graph: {n} nodes, {csr.nnz} nonzeros, d={d}, longest row {top} of {end - beg} "
        f"({time.perf_counter() - t:.2f} s to build)")

    reset_dev_launches()
    harness_errs = exp_spmm.check(ops, x)  # D3, D4, D5, D6 A, A', B
    alias = exp_acc_alias.probe(dev)  # D2 at its probe's shapes
    gather = exp_gather_dma.probe(**GATHER, device=dev)  # D1
    torch.cuda.synchronize()
    launches = dict(segment_reduce.launches)
    launches["gather_sum"] = gather_sum.launches["f32"]
    fixups = dict(segment_reduce.fixup_launches)
    check(all(v > 0 for v in launches.values()), f"[6] a kernel was not launched: {launches}")
    # every exp_spmm call at the bench shape has a cut row (D2's probe has
    # one tile: no fix-up)
    check(all(fixups[k] == launches[k] for k in DEV_VARIANT if k != "bf16_acc"),
          f"[6] fix-ups {fixups} for launches {launches}")
    launches.update({"fixup_" + k: v for k, v in fixups.items()})
    errs = ", ".join(f"{k} {v:.3e}" for k, v in harness_errs.items())
    log(f"[6] harness paths: launches {launches}; exp_spmm --check errors (against a float64 sum): "
        f"{errs}; acc_alias {alias}")

    results = {}
    for key, variant in DEV_VARIANT.items():
        m, kw = exp_spmm.kernel_inputs(variant, ops, x)
        accumulate = INSTANTIATIONS[key][3]
        if accumulate:
            # into a random accumulator at a row offset, rows on both sides
            # of the window outside it
            acc0 = torch.randn(n + 2 * D2_ROW_OFFSET, d, device=dev,
                               generator=torch.Generator(dev).manual_seed(0))
            kw = dict(row_offset=D2_ROW_OFFSET)  # the gathered bf16 rows, unweighted
            acc = acc0.clone()
            got = segment_reduce(csr.rowptr, m, out=acc, **kw)
            want = segment_reduce_reference(csr.rowptr, m, out=acc0.clone(), **kw)
            torch.cuda.synchronize()
            check(got is acc and got.data_ptr() == acc.data_ptr(), f"[6] {key}: not in place")
            touched = torch.zeros(acc.shape[0], dtype=torch.bool, device=dev)
            touched[D2_ROW_OFFSET:D2_ROW_OFFSET + n] = torch.diff(csr.rowptr) > 0
            check(torch.equal(got[~touched], acc0[~touched]), f"[6] {key}: untouched rows changed")
            note = f"storage kept, {int((~touched).sum())} untouched rows bit-exact; "
            check(torch.equal(segment_reduce(csr.rowptr, m, out=acc0.clone(), **kw), got),
                  f"[6] {key}: two runs differ")
            f64 = acc0.double()
            f64[D2_ROW_OFFSET:D2_ROW_OFFSET + n] += f64_segment_sum(csr.rowptr, m, kw)
            got, want, f64 = got[touched], want[touched], f64[touched]
            got_out = acc
            run = lambda: segment_reduce(csr.rowptr, m, out=acc, **kw)  # noqa: E731
            twin = lambda: segment_reduce_reference(csr.rowptr, m, out=acc, **kw)  # noqa: E731
        else:
            got = segment_reduce(csr.rowptr, m, **kw)
            want = segment_reduce_reference(csr.rowptr, m, **kw)
            torch.cuda.synchronize()
            check(got.shape == (n, d) and got.dtype == torch.float32, f"[6] {key}: {tuple(got.shape)}")
            check(torch.equal(segment_reduce(csr.rowptr, m, **kw), got), f"[6] {key}: two runs differ")
            f64 = f64_segment_sum(csr.rowptr, m, kw)
            note, got_out = "", None
            run = lambda: segment_reduce(csr.rowptr, m, **kw)  # noqa: E731
            twin = lambda: segment_reduce_reference(csr.rowptr, m, **kw)  # noqa: E731
        check(torch.isfinite(got).all().item(), f"[6] {key}: non-finite output")
        abs_err, rel = rel_err(got, want)
        check(rel <= DEV_TOL, f"[6] segment_reduce {key} disagrees with its twin: {rel:.3e}")
        rel64 = rel_err(got, f64)[1]
        check(rel64 <= F64_TOL, f"[6] segment_reduce {key} vs a float64 sum: {rel64:.3e} (limit {F64_TOL:.0e})")
        del f64
        ms = time_ms(run, warmup=2, iters=10)
        plain_ms = time_ms(twin, warmup=1, iters=3)
        hub_kw = {k: (v[beg:end] if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
        hub_ms = time_ms(lambda: segment_reduce(hub_rowptr, m[beg:end], out=got_out, **hub_kw),
                         warmup=1, iters=5)
        split = device_split(run)
        library_ms, lib_note = dev_library_time(key, m, csr.rowptr, kw, want)
        b = segment_bound(m, kw, n, d, accumulate)
        results[key] = dict(abs_err=abs_err, rel_err=rel, rel_err_f64=rel64, ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                            hub_share=hub_ms / ms)
        cut = tiling(csr.rowptr, m, kw.get("halves", 1))
        log(f"[6] segment_reduce {key} ({INSTANTIATIONS[key][4]}; {variant} messages "
            f"{tuple(m.shape)} {m.dtype}): {cut['tiles']} tiles of {TILE_MESSAGES}, {cut['cut_rows']} cut "
            f"rows, workspace {cut['workspace_bytes'] / 1e6:.3f} MB, {cut['path']} copies; {note}max abs err "
            f"{abs_err:.3e}, max rel err {rel:.3e} (limit {DEV_TOL:.0e}; vs a float64 sum {rel64:.3e}, limit "
            f"{F64_TOL:.0e}); two runs bit-equal; kernel {ms:.4f} ms, {b['bound_ms'] / ms:.1%} of the bound "
            f"(the hub row alone, every other row empty, {hub_ms:.4f} ms, {hub_ms / ms:.1%} of the kernel, "
            f"{hub_ms * 1e6 / (end - beg):.3f} ns a message row); device time a call (torch.profiler) "
            f"{split}; plain twin {plain_ms:.4f} ms; bound "
            f"{b['bound_ms']:.4f} ms ({b['nbytes'] / 1e9:.4f} GB at 3.35 TB/s, {b['bound_by']}); "
            f"library: {lib_note}")
        del m, got, want, run, twin
        torch.cuda.empty_cache()

    # D1 again, D1_REPEATS probes back to back: its 2^18-id time moved
    # between runs of the same code
    repeats = [exp_gather_dma.probe(**GATHER, device=dev) for _ in range(D1_REPEATS)]
    for i, r in enumerate(zip(*repeats)):
        log(f"[6] gather_sum (D1) E={GATHER['es'][i]}, {D1_REPEATS} probes back to back: ms "
            f"{[round(p['ms'], 4) for p in r]} (bound {r[0]['bound_ms']:.4f} ms; share of the bound "
            f"{[round(p['bound_ms'] / p['ms'], 3) for p in r]})")

    big = gather[-1]  # E = 2^20
    results["gather_sum"] = dict(
        abs_err=max(r["abs_err"] for r in gather), rel_err=max(r["err"] for r in gather),
        ms=big["ms"], plain_ms=big["plain_ms"], library_ms=big["library_ms"], bound_ms=big["bound_ms"],
        bound_by="bytes",
    )
    log(f"[6] gather_sum (D1) at n={GATHER['n']}, d={GATHER['d']}: "
        + "; ".join(f"E={r['e']} ({r['distinct']} distinct rows): {r['ms']:.4f} ms ({r['ns_per_row']:.4f} "
                    f"ns/row, {r['bound_ms'] / r['ms']:.1%} of the bound {r['bound_ms']:.4f} ms), plain "
                    f"{r['plain_ms']:.4f} ms, library (embedding_bag, one bag) {r['library_ms']:.4f} ms "
                    f"(max rel err {r['library_err']:.2e})" for r in gather))
    return launches, results



def zoo_run(name, key, make, pdtype, ds, want_launches, dev) -> dict:
    """One zoo model through ``NodeClassification`` on the card, the launch
    counters set to 0 just before and read just after; its preprocessed
    features against the port's CPU path of the same model."""
    from sgl_tpu_torch.kernels import spmm_csr
    from sgl_tpu_torch.tasks import NodeClassification

    model = make()
    reset_launches()
    task = NodeClassification(ds, model, lr=0.1, weight_decay=5e-5, epochs=ZOO_EPOCHS, verbose=False,
                              precompute_dtype=pdtype)
    counts, fixups = dict(spmm_csr.launches), dict(spmm_csr.fixup_launches)
    pf = model.processed_feature
    check(pf.is_cuda and torch.isfinite(pf.float()).all().item(), f"[7] {name}: bad features")
    check(counts[key] >= want_launches,
          f"[7] {name}: the {key} kernel ran {counts[key]} times, expected >= {want_launches}")
    check(0.0 <= task.test_acc <= 1.0, f"[7] {name}: test accuracy {task.test_acc}")
    cpu = make()
    cpu.preprocess(ds.graph, ds.x, dtype=pdtype, device="cpu")
    err = rel_err(pf.cpu(), cpu.processed_feature)[1]
    check(err <= TOL[key], f"[7] {name}: features vs the CPU path {err:.3e} (limit {TOL[key]:.0e})")
    epochs_ms = [t * 1e3 for t in task.epoch_seconds]
    log(f"[7] {name}: launches {counts}, fix-up launches {fixups}; features {tuple(pf.shape)} {pf.dtype}, "
        f"vs the CPU path max rel err {err:.3e} (limit {TOL[key]:.0e}); preprocess "
        f"{task.preprocess_seconds:.4f} s; train epoch ms {[round(m, 3) for m in epochs_ms]} (median "
        f"{statistics.median(epochs_ms):.3f}); best-val test acc {task.test_acc:.4f}")
    return dict(counts=counts, fixups=fixups, preprocess_s=task.preprocess_seconds,
                epoch_ms=statistics.median(epochs_ms))


def zoo_phase(dev, products_graph):
    """The model zoo through the user's entry points on the card (section
    7 of the module docstring).  Returns the CSR kernel's launches, summed
    over the zoo's runs."""
    from sgl_tpu_torch.datasets import Planetoid, SyntheticPowerLaw
    from sgl_tpu_torch.datasets.planetoid import write_raw_files
    from sgl_tpu_torch.graph import native, symmetric_normalized_weights, symmetric_normalized_weights_host
    from sgl_tpu_torch.kernels import spmm_csr
    from sgl_tpu_torch.models import GBP, NAFS, PASCA_V1, PASCA_V2, PASCA_V3, SGC, SIGN, SSGC, GAMLPRecursive
    from sgl_tpu_torch.tasks import NodeClassification

    ds = SyntheticPowerLaw(**ZOO_DATASET)
    d, c, k = ds.num_features, ds.num_classes, 3
    wide = (d, c, ZOO_HIDDEN, ZOO_LAYERS)
    runs = (  # name, kernel, constructor, precompute dtype, launches at least
        ("SIGN", "f32", lambda: SIGN(k, *wide), None, k),
        ("SSGC bf16", "bf16", lambda: SSGC(k, d, c), torch.bfloat16, k),
        ("GBP", "f32", lambda: GBP(k, *wide), None, k),
        ("GAMLPRecursive", "f32", lambda: GAMLPRecursive(k, *wide), None, k),
        ("PASCA_V1", "f32", lambda: PASCA_V1(k, *wide), None, k),
        ("PASCA_V2", "f32", lambda: PASCA_V2(k, *wide), None, k),
        ("PASCA_V3", "f32", lambda: PASCA_V3(k, k, *wide), None, 2 * k),  # post_steps 3
    )
    launches = {"f32": 0, "bf16": 0, "fixup_f32": 0, "fixup_bf16": 0}
    times = {}

    def add(counts, fixups):
        for key in ("f32", "bf16"):
            launches[key] += counts[key]
            launches["fixup_" + key] += fixups[key]

    for name, key, make, pdtype, want in runs:
        r = zoo_run(name, key, make, pdtype, ds, want, dev)
        add(r["counts"], r["fixups"])
        times[name] = (round(r["preprocess_s"], 4), round(r["epoch_ms"], 3))
        torch.cuda.empty_cache()
    log(f"[7] zoo (preprocess s, median epoch ms): {times}")

    # NAFS: training-free; its preprocess propagates and takes the
    # over-smoothing aggregate
    reset_launches()
    nafs = {dv: NAFS(k, d, c) for dv in ("cuda", "cpu")}
    t = time.perf_counter()
    nafs["cuda"].preprocess(ds.graph, device=dev)
    torch.cuda.synchronize()
    nafs_s = time.perf_counter() - t
    counts, fixups = dict(spmm_csr.launches), dict(spmm_csr.fixup_launches)
    add(counts, fixups)
    nafs["cpu"].preprocess(ds.graph, device="cpu")
    got, want = nafs["cuda"].processed_feature, nafs["cpu"].processed_feature
    check(got.is_cuda and got.shape == (ds.num_node, d) and torch.isfinite(got).all().item(), "[7] NAFS output")
    check(counts["f32"] >= k, f"[7] NAFS: launches {counts}")
    err = rel_err(got.cpu(), want)[1]
    check(err <= TOL["f32"], f"[7] NAFS vs the CPU path {err:.3e}")
    log(f"[7] NAFS preprocess on the card {nafs_s:.4f} s, launches {counts}; vs the CPU path max rel err "
        f"{err:.3e} (limit {TOL['f32']:.0e})")

    # the README's flow, on Planetoid-format files at pubmed's shape
    with tempfile.TemporaryDirectory() as root:
        t = time.perf_counter()
        write_raw_files(f"{root}/Planetoid/pubmed/raw", "pubmed", seed=0)
        write_s = time.perf_counter() - t
        reset_launches()
        t = time.perf_counter()
        dataset = Planetoid("pubmed", root + "/", "official")
        parse_s = time.perf_counter() - t
        model = SGC(prop_steps=3, feat_dim=dataset.num_features, output_dim=dataset.num_classes)
        task = NodeClassification(dataset, model, lr=0.2, weight_decay=5e-5, epochs=100, verbose=False)
        counts, fixups = dict(spmm_csr.launches), dict(spmm_csr.fixup_launches)
        add(counts, fixups)
        cpu = SGC(3, dataset.num_features, dataset.num_classes)
        cpu.preprocess(dataset.graph, dataset.x, device="cpu")
        err = rel_err(model.processed_feature.cpu(), cpu.processed_feature)[1]
    check((dataset.num_node, dataset.num_features, dataset.num_classes) == (19_717, 500, 3),
          f"[7] pubmed shape {dataset.num_node}, {dataset.num_features}, {dataset.num_classes}")
    check(dataset.graph.num_edges == 2 * 44_324, f"[7] pubmed edges {dataset.graph.num_edges}")
    check(counts["f32"] >= 3 and err <= TOL["f32"], f"[7] pubmed SGC: launches {counts}, vs CPU {err:.3e}")
    check(0.6 <= task.test_acc <= 1.0, f"[7] pubmed SGC test accuracy {task.test_acc}")
    log(f"[7] Planetoid pubmed (raw files written in {write_s:.2f} s, parsed in {parse_s:.2f} s: "
        f"{dataset.num_node} nodes, {dataset.graph.num_edges} directed edges, {dataset.num_features} "
        f"features, {dataset.num_classes} classes) -> SGC(3) -> NodeClassification on the card: launches "
        f"{counts}, preprocess {task.preprocess_seconds:.4f} s, median epoch ms "
        f"{statistics.median(task.epoch_seconds) * 1e3:.3f}, test acc {task.test_acc:.4f}; features vs "
        f"the CPU path {err:.3e}")

    # the native graph builder, and the host normalization of the products graph
    check(native.native_available(), "[7] the native graph builder did not build with g++")
    t = time.perf_counter()
    host = symmetric_normalized_weights_host(products_graph)
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    on_card = symmetric_normalized_weights(products_graph, device=dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    check(torch.equal(host.src, on_card.src.cpu()) and torch.equal(host.dst, on_card.dst.cpu()),
          "[7] host and card normalization order the edges differently")
    w = on_card.w.cpu()
    nz = w != 0
    rel = ((host.w[nz] - w[nz]).abs() / w[nz].abs()).max().item()
    check(rel <= HOST_NORM_TOL and torch.equal(host.w[~nz], w[~nz]),
          f"[7] host normalization vs the card's: {rel:.3e} (limit {HOST_NORM_TOL:.0e})")
    log(f"[7] native graph builder: available; products graph ({products_graph.num_nodes} nodes, "
        f"{host.w.shape[0]} edges with self-loops): symmetric_normalized_weights_host {host_s:.4f} s, "
        f"on the card {card_s:.4f} s; max elementwise rel diff {rel:.3e} (limit {HOST_NORM_TOL:.0e}), "
        f"edge order identical")
    return launches


# -- phase 8: the label and NAFS tasks ------------------------------------------

# tests/test_tasks.py:38-49 (C&S) and :119-131 (label use and reuse), at the
# main path's dataset; C&S over SGC(3), label reuse over SGC(2) at width
# num_features + num_classes
CS_SETTINGS = dict(lr=0.1, weight_decay=5e-5, epochs=15, num_correct_layers=10, correct_alpha=0.8,
                   num_smooth_layers=10, smooth_alpha=0.8)
CS_STEPS = 3
LABEL_USE_SETTINGS = dict(lr=0.1, weight_decay=5e-5, epochs=12, mask_rate=0.5, use_labels=True,
                          label_iters=1, reuse_start_epoch=5)
LABEL_USE_STEPS = 2
# the NAFS tasks' defaults (hops 0..19, six r) with four KMeans seedings
NAFS_HOPS, NAFS_N_INIT, NAFS_METHOD = 20, 4, "mean"
NAFS_R_LIST = (0.5, 0.4, 0.3, 0.2, 0.1, 0.0)
# the GAE: an SGC(3) encoder of width 64, 20 epochs
GAE_STEPS, GAE_WIDTH, GAE_SETTINGS = 3, 64, dict(lr=0.01, weight_decay=5e-5, epochs=20)
PREDICT_SIZES = (1, 7, 1000)
# K1 at the label widths (pubmed's 3 classes, an odd width, the main path's 64)
LABEL_WIDTHS = (3, 47, 64)
# the small graph's AUC and AP, card against the CPU path
AUC_TOL = 1e-6


def expected_label_launches() -> dict:
    """K1 (f32) launches of each phase-8 task on the card, from its
    settings (``PERF.md`` §6 states them)."""
    s = LABEL_USE_SETTINGS
    reuse_epochs = sum(e > s["reuse_start_epoch"] for e in range(s["epochs"]))
    nafs = (NAFS_HOPS - 1) * len(NAFS_R_LIST)  # the sweep's last hop is 19
    return {
        "C&S": CS_STEPS + CS_SETTINGS["num_correct_layers"] + CS_SETTINGS["num_smooth_layers"],
        "label reuse": LABEL_USE_STEPS * (1 + s["epochs"] + s["label_iters"] * reuse_epochs),
        "predictor": 0,
        "NAFS clustering": nafs,
        "NAFS link prediction": nafs,
        "GAE": GAE_STEPS,
    }


def nafs_bound(n: int, e: int, r: int, d: int) -> dict:
    """The least time of the R products in one R·D-wide pass: ``4(N+1) +
    4E + 4E·R + 2·N·R·D·4`` bytes (the column indices once, R weights a
    nonzero, x and y once each at width R·D), or ``2·E·R·D`` f32
    operations, whichever is longer."""
    nbytes = 4 * (n + 1) + 4 * e + 4 * e * r + 2 * n * r * d * 4
    b = bound(nbytes, e, r * d)
    return dict(b, nbytes=nbytes)


def count_launches(fn) -> tuple:
    """``fn()`` with the CSR kernel's counters set to 0 just before and read
    just after.  Returns ``(result, seconds, launches, fix-ups, peak device
    bytes)``, the counts by instantiation."""
    from sgl_tpu_torch.kernels import spmm_csr

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts, fixup_counts = dict(spmm_csr.launches), dict(spmm_csr.fixup_launches)
    return out, seconds, counts, fixup_counts, torch.cuda.max_memory_allocated()


def hold_launches(name: str, phase: str, counts: dict, fixup_counts: dict, launches: dict, fixups: dict) -> None:
    """Raise unless the counts equal ``launches`` and ``fixups`` by
    instantiation (0 for every one not named)."""
    for what, got, want in (("launches", counts, launches), ("fix-up launches", fixup_counts, fixups)):
        expect = {k: want.get(k, 0) for k in got}
        check(got == expect, f"[{phase}] {name}: {what} {got}, expected {expect}")


def run_counted(name: str, fn, launches: dict, fixups: dict, phase: str) -> tuple:
    """:func:`count_launches` of ``fn``, held to ``launches`` and ``fixups``
    (:func:`hold_launches`)."""
    out, seconds, counts, fixup_counts, peak = count_launches(fn)
    hold_launches(name, phase, counts, fixup_counts, launches, fixups)
    return out, seconds, counts, fixup_counts, peak


def label_small_graph(dev) -> None:
    """Every phase-8 task's device work on a small graph, on the card
    against the port's CPU path."""
    from sgl_tpu_torch.datasets import PlantedPartition
    from sgl_tpu_torch.graph import symmetric_normalized_weights
    from sgl_tpu_torch.models import SGC
    from sgl_tpu_torch.tasks import (
        KMeans, LinkPredictionGAE, LinkPredictionNAFS, NodeClustering, mask_test_edges, nafs_smooth_sweep,
    )
    from sgl_tpu_torch.tasks.node_classification_with_label_use import reuse_labels
    from sgl_tpu_torch.tasks.utils import add_labels
    from sgl_tpu_torch.tricks import CorrectAndSmooth, label_propagation

    ds = PlantedPartition()
    cpu = torch.device("cpu")
    n, c = ds.num_node, ds.num_classes
    y = torch.as_tensor(np.asarray(ds.y).reshape(-1))
    train = np.asarray(ds.train_idx)
    gen = torch.Generator().manual_seed(0)
    y_soft = torch.softmax(torch.randn(n, c, generator=gen), dim=1)
    errs = {}

    def both(name, fn):
        got, want = fn(dev), fn(cpu)
        for a, b in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            check(a.is_cuda, f"[8] small graph {name}: not on the card")
            errs[name] = max(errs.get(name, 0.0), rel_err(a.cpu(), b)[1])
        check(errs[name] <= TOL["f32"], f"[8] small graph {name}: card vs CPU {errs[name]:.3e}")

    def adj(device, r=0.5):
        return symmetric_normalized_weights(ds.graph, r=r, device=device)

    both("label propagation", lambda v: label_propagation(y.to(v), adj(v), 10, 0.9))
    both("label propagation, soft, masked",
         lambda v: label_propagation(y_soft.to(v), adj(v), 10, 0.9, mask=train))

    def cs(v):
        post = CorrectAndSmooth(10, 0.8, 10, 0.8)
        out = post.correct(y_soft.to(v), y.to(v), train, adj(v, 0.3))
        return out, post.smooth(out, y.to(v), train, adj(v))

    both("C&S correct, smooth", cs)

    features = add_labels(ds.x, y.numpy(), train[::2], c)
    unlabeled = np.concatenate([train[1::2], ds.val_idx, ds.test_idx])
    init = SGC(2, ds.num_features + c, c)
    init.init(torch.Generator().manual_seed(0))
    weights = init.net.state_dict()

    def reuse(v):
        model = SGC(2, ds.num_features + c, c)
        model.net.load_state_dict(weights)
        model.net.to(v)
        model.preprocess(ds.graph, features.copy(), device=v)
        feat = features.copy()
        reuse_labels(model, model.net, ds.graph, feat, unlabeled, c, v)
        return model.processed_feature

    both("label reuse features", reuse)
    both("NAFS sweep", lambda v: tuple(f for _, f in nafs_smooth_sweep(
        ds.graph, ds.x, [0, 3, 7], NAFS_R_LIST, NAFS_METHOD, device=v)))
    feats = torch.as_tensor(ds.x)
    km_card, km_cpu = (KMeans(c).fit(feats.to(v), init=feats[:c].to(v)).labels_ for v in (dev, cpu))
    check(km_card.is_cuda and torch.equal(km_card.cpu(), km_cpu),
          "[8] small graph KMeans: card and CPU labels differ from the same centers")

    # the trained tasks: their propagated features (their seeding and
    # dropout draw from each device's own generator)
    scores = {}

    def trained(name, make_task, kind):
        def propagated(v):
            model = SGC(2, ds.num_features, 16 if kind == "gae" else c)
            task = make_task(model, v)
            scores.setdefault(name, []).append(task.test_roc_auc if kind == "gae" else task.nmi)
            return model.processed_feature
        both(name, propagated)

    trained("GAE features", lambda m, v: LinkPredictionGAE(
        ds, m, lr=0.01, weight_decay=5e-5, epochs=5, verbose=False, device=v), "gae")
    trained("NodeClustering features", lambda m, v: NodeClustering(
        ds, m, lr=0.01, weight_decay=5e-5, epochs=2, n_init=2, verbose=False, device=v), "clustering")
    split = [mask_test_edges(ds.graph, seed=s) for s in (0, 0)]
    check(all(np.array_equal(a, b) for a, b in zip(split[0][1:], split[1][1:])),
          "[8] small graph mask_test_edges: two splits of one seed differ")
    kw = dict(hops=[0, 3, 7], method=NAFS_METHOD, r_list=NAFS_R_LIST, verbose=False)
    auc_card, auc_cpu = ((t.test_roc_auc, t.test_avg_prec, t.best_hop_roc_auc, t.best_hop_avg_prec)
                         for t in (LinkPredictionNAFS(ds, device=v, **kw) for v in (dev, cpu)))
    d_auc = max(abs(a - b) for a, b in zip(auc_card[:2], auc_cpu[:2]))
    check(d_auc <= AUC_TOL and auc_card[2:] == auc_cpu[2:],
          f"[8] small graph NAFS link prediction: card {auc_card}, CPU {auc_cpu}")
    log(f"[8] small graph ({n} nodes): card vs the CPU path, max rel err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (limit {TOL['f32']:.0e}); KMeans from the same centers: the same labels; "
        f"mask_test_edges: the same arrays; NAFS link AUC, AP, best hops card {auc_card}, CPU "
        f"{auc_cpu} (|diff| {d_auc:.3e}, limit {AUC_TOL:.0e}); GAE test AUC (card, CPU) "
        f"{scores['GAE features']}, NodeClustering nmi (card, CPU) {scores['NodeClustering features']}")


def label_width_probe(adj, dev) -> dict:
    """K1 at the label widths on the main path's adjacency: against its
    twin, timed beside its bound and ``torch.sparse.mm``."""
    from sgl_tpu_torch.kernels import spmm_csr, spmm_csr_reference

    out = {}
    gen = torch.Generator(dev).manual_seed(3)
    for d in LABEL_WIDTHS:
        x = torch.rand(adj.num_nodes, d, device=dev, generator=gen)
        abs_err, rel, rel64 = compare(adj, x, "f32", f"the main-path shape, d={d}")
        ms = time_ms(lambda: spmm_csr(adj, x))
        plain_ms = time_ms(lambda: spmm_csr_reference(adj, x), warmup=1, iters=3)
        library_ms, lib_note = library_time(adj, x, spmm_csr_reference(adj, x))
        nbytes = 4 * (adj.num_nodes + 1) + 8 * adj.nnz + 2 * adj.num_nodes * d * 4
        b = bound(nbytes, adj.nnz, d)
        out[d] = dict(max_abs_err=abs_err, max_rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                      **b)
        log(f"[8] spmm_csr f32 at d={d} (main-path adjacency, {adj.nnz} nonzeros): max rel err {rel:.3e} "
            f"(limit {TOL['f32']:.0e}; vs an f64 sum {rel64:.3e}); kernel {ms:.4f} ms, plain twin "
            f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({nbytes / 1e6:.2f} MB, {b['bound_by']}), "
            f"{b['bound_ms'] / ms:.1%} of it; library {lib_note}")
    return out


def gradient_probe(ds, dev) -> dict:
    """K1's gradient at the main path's shape: ``sum(spmm(adj, x)**2)``'s
    gradient against the CPU path and a float64 ``Aᵀ(2Ax)``, one forward
    and one backward launch; the forward and backward kernels timed."""
    from sgl_tpu_torch.graph import symmetric_normalized_weights
    from sgl_tpu_torch.kernels import prepare_csr, spmm, spmm_csr, spmm_csr_reference, transposed

    adj = prepare_csr(symmetric_normalized_weights(ds.graph, device=dev))
    x = torch.as_tensor(ds.x, device=dev).requires_grad_(True)
    reset_launches()
    y = spmm(adj, x)
    forward = dict(spmm_csr.launches)
    (y ** 2).sum().backward()
    torch.cuda.synchronize()
    both = dict(spmm_csr.launches)
    check(forward["f32"] == 1 and both["f32"] == 2 and sum(both.values()) == 2,
          f"[8] gradient: launches after the forward {forward}, after the backward {both}")
    grad = x.grad
    # the CPU path of the same call (the CSR's plain twin, forward and
    # backward, in the kernel's order), and the CPU's edge-list path, whose
    # sequential f32 sums over hub rows are shown, not held
    cpu_grads = []
    for layout in (prepare_csr, lambda a: a):
        xc = torch.as_tensor(ds.x).requires_grad_(True)
        (spmm(layout(symmetric_normalized_weights(ds.graph, device="cpu")), xc) ** 2).sum().backward()
        cpu_grads.append(xc.grad)
    rows = torch.repeat_interleave(torch.arange(adj.num_nodes, device=dev), torch.diff(adj.rowptr.long()))
    val, col = adj.val.double()[:, None], adj.col.long()
    y64 = torch.zeros(x.shape, dtype=torch.float64, device=dev).index_add_(
        0, rows, x.detach().double()[col] * val)
    dx64 = torch.zeros_like(y64).index_add_(0, col, 2 * y64[rows] * val)
    err_cpu = rel_err(grad.cpu(), cpu_grads[0])
    err64 = rel_err(grad, dx64)[1]
    edge_list = (rel_err(cpu_grads[1], cpu_grads[0])[1], rel_err(cpu_grads[1].to(dev), dx64)[1])
    del y64, dx64, rows, val, col
    check(torch.isfinite(grad).all().item() and err_cpu[1] <= TOL["f32"] and err64 <= F64_TOL,
          f"[8] gradient: vs the CPU path {err_cpu[1]:.3e}, vs float64 {err64:.3e}")
    at = transposed(adj)
    g = (2 * y).detach()
    out = {}
    for name, csr, inp in (("forward", adj, x.detach()), ("backward", at, g)):
        ms = time_ms(lambda: spmm_csr(csr, inp))
        plain_ms = time_ms(lambda: spmm_csr_reference(csr, inp), warmup=1, iters=3)
        library_ms, lib_note = library_time(csr, inp, spmm_csr_reference(csr, inp))
        nbytes = 4 * (csr.num_nodes + 1) + 8 * csr.nnz + 2 * csr.num_nodes * inp.shape[1] * 4
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bound(nbytes, csr.nnz, inp.shape[1]))
        log(f"[8] K1 {name} ({'Aᵀ' if name == 'backward' else 'A'}: {describe_plan(csr.plan, inp.shape[1])}): "
            f"kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms, bound {out[name]['bound_ms']:.4f} ms; "
            f"library {lib_note}")
    out["backward"].update(launches=both["f32"] - forward["f32"], max_abs_err=err_cpu[0], max_rel_err=err_cpu[1])
    log(f"[8] K1 gradient of sum(spmm(adj, x)**2) at the main-path shape: launches forward {forward['f32']}, "
        f"backward {both['f32'] - forward['f32']}; vs the CPU path (the CSR's twin) max rel err "
        f"{err_cpu[1]:.3e} (limit {TOL['f32']:.0e}); vs a float64 Aᵀ(2Ax) {err64:.3e} (limit {F64_TOL:.0e}); "
        f"the CPU's edge-list path is {edge_list[0]:.3e} from the twin's and {edge_list[1]:.3e} from float64")
    return out


def multi_weight_probe(ds, dev) -> dict:
    """NAFS's product at R = 6, D = 128: R launches of K1 (``spmm_multi``)
    against the plain one-gather form on the card, beside the bytes bound
    of one R·D-wide pass and R times the one-r bound."""
    from sgl_tpu_torch.graph import symmetric_normalized_weights
    from sgl_tpu_torch.kernels import prepare_csr, spmm_csr, spmm_multi, spmm_multi_gather

    adjs = [symmetric_normalized_weights(ds.graph, r=r, device=dev) for r in NAFS_R_LIST]
    csrs = [prepare_csr(a) for a in adjs]
    r, n, d = len(adjs), ds.num_node, ds.num_features
    h = torch.rand(r, n, d, device=dev, generator=torch.Generator(dev).manual_seed(4))
    # both against a float64 sum per r: the one-gather form adds each row's
    # messages in one sequential f32 order, which a hub row's length shows
    errs = {"per r": 0.0, "one gather": 0.0}
    for name, out in (("per r", spmm_multi(csrs, h)), ("one gather", spmm_multi_gather(adjs, h))):
        for i, csr in enumerate(csrs):
            errs[name] = max(errs[name], rel_err(out[i], f64_sum(csr, h[i]))[1])
        del out
    check(errs["per r"] <= F64_TOL, f"[8] spmm_multi vs a float64 sum: {errs['per r']:.3e}")
    per_r = time_ms(lambda: [spmm_csr(c, h[i]) for i, c in enumerate(csrs)])
    multi = time_ms(lambda: spmm_multi(csrs, h))
    gather = time_ms(lambda: spmm_multi_gather(adjs, h), warmup=1, iters=3)
    torch.cuda.empty_cache()
    e = csrs[0].nnz
    one_pass = nafs_bound(n, e, r, d)
    per_r_bound = r * bound(4 * (n + 1) + 8 * e + 2 * n * d * 4, e, d)["bound_ms"]
    log(f"[8] NAFS product, R={r}, D={d}, N={n}, E={e}: {r} x K1 {per_r:.4f} ms (spmm_multi with its stack "
        f"{multi:.4f} ms); the plain one-gather form {gather:.4f} ms; bound of one R·D-wide pass "
        f"{one_pass['bound_ms']:.4f} ms ({one_pass['nbytes'] / 1e6:.1f} MB), R x the one-r bound "
        f"{per_r_bound:.4f} ms; vs a float64 sum per r: spmm_multi {errs['per r']:.3e} (limit "
        f"{F64_TOL:.0e}), the one-gather form {errs['one gather']:.3e}")
    return dict(per_r_ms=per_r, multi_ms=multi, gather_ms=gather, bound_ms=one_pass["bound_ms"],
                per_r_bound_ms=per_r_bound)


def label_phase(dev) -> dict:
    """The label and NAFS tasks through the user's entry points on the card
    (section 8 of the module docstring).  Returns the CSR kernel's launches
    summed over the tasks, and the probes' numbers for the kernels line."""
    from sgl_tpu_torch.datasets import SyntheticPowerLaw
    from sgl_tpu_torch.graph import symmetric_normalized_weights
    from sgl_tpu_torch.kernels import prepare_csr
    from sgl_tpu_torch.models import SGC
    from sgl_tpu_torch.tasks import (
        KMeans, LinkPredictionGAE, LinkPredictionNAFS, NodeClassificationWithCorrectAndSmooth,
        NodeClassificationWithLabelUse, NodeClusteringNAFS, Predictor, predictor_from_task,
    )
    from sgl_tpu_torch.tasks.utils import make_logits_fn

    label_small_graph(dev)
    ds = SyntheticPowerLaw(**ZOO_DATASET)
    d, c = ds.num_features, ds.num_classes
    want = expected_label_launches()
    seconds, launches = {}, {}

    def run(name, fn):
        # every product on these graphs has a long row: each has its fix-up
        f32 = {"f32": want[name]}
        out, seconds[name], counts, _, _ = run_counted(name, fn, f32, f32, "8")
        launches[name] = counts["f32"]
        return out

    cs = run("C&S", lambda: NodeClassificationWithCorrectAndSmooth(
        ds, SGC(CS_STEPS, d, c), verbose=False, **CS_SETTINGS))
    check(cs._best_y_soft.is_cuda and 0.0 <= cs.test_acc <= 1.0, f"[8] C&S: test acc {cs.test_acc}")
    log(f"[8] C&S (SGC({CS_STEPS}), {CS_SETTINGS}): {seconds['C&S']:.4f} s, {launches['C&S']} K1 launches "
        f"(expected {want['C&S']}), test acc {cs.test_acc:.4f}")

    lu = run("label reuse", lambda: NodeClassificationWithLabelUse(
        ds, SGC(LABEL_USE_STEPS, d + c, c), verbose=False, **LABEL_USE_SETTINGS))
    check(0.0 <= lu.test_acc <= 1.0, f"[8] label reuse: test acc {lu.test_acc}")
    log(f"[8] label use and reuse (SGC({LABEL_USE_STEPS}) at width {d} + {c}, {LABEL_USE_SETTINGS}): "
        f"{seconds['label reuse']:.4f} s, {launches['label reuse']} K1 launches (expected "
        f"{want['label reuse']}), propagation s an epoch {[round(s, 4) for s in lu.propagate_seconds]}, "
        f"test acc {lu.test_acc:.4f}")

    all_idx = torch.arange(ds.num_node, device=dev)
    logits = make_logits_fn(cs.net)(cs._model.batch_input(all_idx)).cpu().numpy()

    def serve():
        with tempfile.TemporaryDirectory() as tmp:
            predictor_from_task(cs).save(f"{tmp}/predictor.pt")
            loaded = Predictor.load(f"{tmp}/predictor.pt")  # in place of a fresh process
        rng = np.random.default_rng(0)
        requests = [rng.choice(ds.num_node, k, replace=False) for k in PREDICT_SIZES] + [np.arange(ds.num_node)]
        return [(ids, loaded.predict(ids)) for ids in requests]

    served = run("predictor", serve)
    scale = np.abs(logits).max()
    pred_err = max(np.abs(out - logits[ids]).max() / scale for ids, out in served)
    exact = all(np.array_equal(out, logits[ids]) for ids, out in served)
    check(pred_err <= TOL["f32"], f"[8] predictor: vs the task's logits {pred_err:.3e}")
    log(f"[8] Predictor of the C&S task: saved, loaded and asked for {[len(i) for i, _ in served]} ids in "
        f"{seconds['predictor']:.4f} s; vs the task's logits max rel err {pred_err:.3e} "
        f"(limit {TOL['f32']:.0e}), bit-equal: {exact}")

    clus = run("NAFS clustering", lambda: NodeClusteringNAFS(
        ds, hops=NAFS_HOPS, method=NAFS_METHOD, n_init=NAFS_N_INIT, r_list=NAFS_R_LIST, verbose=False))
    km_s = clus.kmeans_seconds
    check(len(km_s) == NAFS_HOPS and 0.0 <= clus.nmi <= 1.0, f"[8] NAFS clustering: nmi {clus.nmi}")
    log(f"[8] NodeClusteringNAFS (hops 0..{NAFS_HOPS - 1}, {NAFS_METHOD}, r {NAFS_R_LIST}, n_init "
        f"{NAFS_N_INIT}): {seconds['NAFS clustering']:.4f} s, {launches['NAFS clustering']} K1 launches "
        f"(expected {want['NAFS clustering']}); KMeans s a hop {[round(s, 4) for s in km_s]} (median "
        f"{statistics.median(km_s):.4f}); best acc {clus.acc:.4f} (hop {clus.best_hop_acc}), nmi "
        f"{clus.nmi:.4f} (hop {clus.best_hop_nmi}), ari {clus.adjscore:.4f}")

    link = run("NAFS link prediction", lambda: LinkPredictionNAFS(
        ds, hops=NAFS_HOPS, method=NAFS_METHOD, r_list=NAFS_R_LIST, verbose=False))
    check(0.0 <= link.test_roc_auc <= 1.0, f"[8] NAFS link prediction: AUC {link.test_roc_auc}")
    log(f"[8] LinkPredictionNAFS: {seconds['NAFS link prediction']:.4f} s (mask_test_edges on the host "
        f"{link.split_seconds:.4f} s), {launches['NAFS link prediction']} K1 launches (expected "
        f"{want['NAFS link prediction']}); best AUC {link.test_roc_auc:.4f} (hop {link.best_hop_roc_auc}), "
        f"AP {link.test_avg_prec:.4f} (hop {link.best_hop_avg_prec})")

    gae = run("GAE", lambda: LinkPredictionGAE(ds, SGC(GAE_STEPS, d, GAE_WIDTH), verbose=False, **GAE_SETTINGS))
    check(0.0 <= gae.test_roc_auc <= 1.0, f"[8] GAE: AUC {gae.test_roc_auc}")
    log(f"[8] LinkPredictionGAE (SGC({GAE_STEPS}) to width {GAE_WIDTH}, {GAE_SETTINGS}): {seconds['GAE']:.4f} s "
        f"(mask_test_edges {gae.split_seconds:.4f} s, preprocess {gae.preprocess_seconds:.4f} s), "
        f"{launches['GAE']} K1 launches (expected {want['GAE']}); test AUC {gae.test_roc_auc:.4f}, "
        f"AP {gae.test_avg_prec:.4f}")

    # KMeans of one hop on the card, alone: the main path's features
    feats = torch.as_tensor(ds.x, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    km = KMeans(c, n_init=NAFS_N_INIT, random_state=0).fit(feats)
    torch.cuda.synchronize()
    km_one = time.perf_counter() - t
    check(km.labels_.is_cuda and km.cluster_centers_.shape == (c, d), "[8] KMeans did not run on the card")
    log(f"[8] KMeans({c}, n_init {NAFS_N_INIT}) of {tuple(feats.shape)} on the card: {km_one:.4f} s, "
        f"{km.n_iter_} Lloyd iterations in the kept run, inertia {km.inertia_:.6g}")
    log(f"[8] tasks (s, K1 launches): " + ", ".join(f"{k} ({seconds[k]:.4f}, {launches[k]})" for k in seconds))

    adj = prepare_csr(symmetric_normalized_weights(ds.graph, device=dev))
    widths = label_width_probe(adj, dev)
    grad = gradient_probe(ds, dev)
    multi = multi_weight_probe(ds, dev)
    total = sum(launches.values())
    return dict(launches=total, fixup_launches=total, widths=widths, gradient=grad, multi=multi,
                tasks={k: dict(seconds=seconds[k], launches=launches[k]) for k in seconds})


# -- phase 9: the NARS path and graph classification -----------------------------

# ogbn-mag's paper : author : field counts (736,389 : 1,134,649 : 59,965) at
# about a quarter, its 128 features and 349 classes (OgbnMag); the main
# path's hidden width (bench.py:247); every connected relation pair
NARS_DATASET = dict(counts={"paper": 200_000, "author": 308_000, "subject": 16_000}, avg_degree=10,
                    feat_dim=128, num_classes=349, seed=0)
NARS_MODEL = dict(prop_steps=3, hidden_dim=512, num_layers=2)
NARS_SUBSETS = dict(random_subgraph_num=3, subgraph_edge_type_num=2)
NARS_TRAIN = dict(lr=0.01, weight_decay=5e-5, epochs=3, train_batch_size=10_000)
NARS_SEED = 42  # HeteroNodeClassification's default seed, which draws the subsets
# ogbg-molhiv's graph count (41,127), 20-40 nodes a graph, 128 features
GRAPH_DATASET = dict(num_graphs=40_000, nodes_per_graph=(20, 40), feat_dim=128, seed=0)
GRAPH_STEPS, GRAPH_HIDDEN = 3, 512
GRAPH_TRAIN = dict(lr=0.01, weight_decay=5e-5, epochs=20)


def expected_hetero_launches() -> dict:
    """The CSR kernel's launches of each phase-9 run, by instantiation, and
    its fix-ups: one propagation of ``prop_steps`` products each (the S
    subgraphs, or the dataset's graphs, in one block-diagonal batch), no
    fix-up (no row of these graphs passes ``SPLIT_NNZ``).  ``PERF.md`` §6
    states them."""
    k_nars, k_graph = NARS_MODEL["prop_steps"], GRAPH_STEPS
    f32 = lambda k: {"f32": k, "bf16": 0}  # noqa: E731
    return {
        "Fast NARS": dict(launches=f32(k_nars), fixups={"f32": 0, "bf16": 0}),
        "NARS_SIGN": dict(launches=f32(k_nars), fixups={"f32": 0, "bf16": 0}),
        "GraphSIGN": dict(launches=f32(k_graph), fixups={"f32": 0, "bf16": 0}),
        "GraphSGC bf16": dict(launches={"f32": 0, "bf16": k_graph}, fixups={"f32": 0, "bf16": 0}),
    }


def csr_bound(n: int, e: int, d: int, elem: int) -> dict:
    """:func:`bound` of one one-shot product: ``4(N+1) + 8E + 2·N·D·s``
    bytes, or ``2·E·D`` f32 operations."""
    nbytes = 4 * (n + 1) + 8 * e + 2 * n * d * elem
    return dict(bound(nbytes, e, d), nbytes=nbytes)


def hetero_small_graph(dev) -> None:
    """Both families on small graphs, on the card against the port's CPU
    path: the subsets chosen, the features, the logits from the same
    weights, Fast NARS's subgraph weights after two epochs (dropout 0)."""
    from sgl_tpu_torch.datasets import SyntheticGraphClassification, SyntheticHeteroDataset
    from sgl_tpu_torch.models import Fast_NARS_SGC_WithLearnableWeights, GraphSGC, GraphSIGN, NARS_SIGN
    from sgl_tpu_torch.models.blocks import FastDropout
    from sgl_tpu_torch.tasks import HeteroNodeClassification

    cpu = torch.device("cpu")
    ds = SyntheticHeteroDataset(seed=1)
    idx = torch.arange(0, ds.data.num_node["paper"], 2)
    errs = {}
    for name, cls in (("Fast NARS", Fast_NARS_SGC_WithLearnableWeights), ("NARS_SIGN", NARS_SIGN)):
        card, host = (cls(2, 16, ds.num_classes, 16, 2, 2) for _ in range(2))
        for m, d in ((card, dev), (host, cpu)):
            m.preprocess(ds, "paper", random_subgraph_num=2, subgraph_edge_type_num=2, device=d)
        check(card.subgraph_keys == host.subgraph_keys, f"[9] {name}: subsets {card.subgraph_keys} vs "
                                                          f"{host.subgraph_keys}")
        check(card.processed_feature.is_cuda, f"[9] {name}: features not on the card")
        feat = rel_err(card.processed_feature.cpu(), host.processed_feature)[1]
        host.init(torch.Generator().manual_seed(0))
        card.net.load_state_dict(host.net.state_dict())
        card.net.to(dev)
        logit = rel_err(card.apply(idx.to(dev)).detach().cpu(), host.apply(idx).detach())[1]
        check(max(feat, logit) <= TOL["f32"], f"[9] {name}: card vs CPU features {feat:.3e}, logits {logit:.3e}")
        errs[name] = (feat, logit)
    weights = []
    for d in (dev, cpu):
        m = Fast_NARS_SGC_WithLearnableWeights(2, 16, ds.num_classes, 16, 2, 2)
        for mod in m.net.modules():
            if isinstance(mod, FastDropout):
                mod.rate = 0.0
        weights.append(torch.as_tensor(HeteroNodeClassification(
            ds, "paper", m, lr=0.05, weight_decay=5e-5, epochs=2, device=d, random_subgraph_num=2,
            subgraph_edge_type_num=2, record_subgraph_weight=True, verbose=False).subgraph_weight))
    w_err = rel_err(*weights)[1]
    check(w_err <= TOL["f32"], f"[9] Fast NARS subgraph_weight card vs CPU {w_err:.3e}")

    gds = SyntheticGraphClassification(200)
    for name, key, make, dtype in (
        ("GraphSIGN", "f32", lambda: GraphSIGN(2, gds.num_features, gds.num_classes, hidden_dim=16), None),
        ("GraphSGC bf16", "bf16", lambda: GraphSGC(2, gds.num_features, gds.num_classes, readout="max"),
         torch.bfloat16),
    ):
        card, host = make(), make()
        for m, d in ((card, dev), (host, cpu)):
            m.preprocess(gds.batch(), dtype=dtype, device=d)
        check(card.processed_feature.is_cuda, f"[9] {name}: features not on the card")
        feat = rel_err(card.processed_feature.cpu(), host.processed_feature)[1]
        host.init(torch.Generator().manual_seed(0))
        card.net.load_state_dict(host.net.state_dict())
        card.net.to(dev)
        logit = rel_err(card.net(card.net_inputs()[0]).detach().cpu(), host.net(host.net_inputs()[0]).detach())[1]
        check(max(feat, logit) <= TOL[key], f"[9] {name}: card vs CPU features {feat:.3e}, logits {logit:.3e} "
                                            f"(limit {TOL[key]:.0e})")
        errs[name] = (feat, logit)
    log(f"[9] small graphs, card vs the CPU path (max rel err of features, logits): "
        + ", ".join(f"{k} ({a:.3e}, {b:.3e})" for k, (a, b) in errs.items())
        + f"; the same subsets; Fast NARS subgraph_weight after 2 epochs {w_err:.3e} (limits 1e-05 f32, 1e-02 bf16)")


def batch_kernel_times(batch, dev, where: str) -> dict:
    """K1 and K2 on the adjacency a phase-9 run propagates over, against
    their twin, timed beside their bound and ``torch.sparse.mm``."""
    from sgl_tpu_torch.graph import symmetric_normalized_weights
    from sgl_tpu_torch.kernels import prepare_csr, spmm_csr, spmm_csr_reference

    adj = prepare_csr(symmetric_normalized_weights(batch.graph, device=dev))
    n, e = adj.num_nodes, adj.nnz
    x32 = torch.as_tensor(batch.graph.x, device=dev)
    d = x32.shape[1]
    out = {}
    for key, dtype in DTYPES.items():
        x = x32.to(dtype)
        abs_err, rel, _ = compare(adj, x, key, where, against_f64=False)
        ms = time_ms(lambda: spmm_csr(adj, x))
        plain_ms = time_ms(lambda: spmm_csr_reference(adj, x))
        library_ms, lib_note = library_time(adj, x, spmm_csr_reference(adj, x))
        b = csr_bound(n, e, d, x.element_size())
        out[key] = dict(max_abs_err=abs_err, max_rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                        bound_ms=b["bound_ms"], bound_by=b["bound_by"], nodes=n, nonzeros=e)
        log(f"[9] spmm_csr {key} at {where} ({n} nodes, {e} nonzeros with self-loops, d={d}, longest row "
            f"{int(torch.diff(adj.rowptr.long()).max())}, {adj.plan.num_long} long rows): max rel err "
            f"{rel:.3e} (limit {TOL[key]:.0e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['nbytes'] / 1e6:.1f} MB, {b['bound_by']}), library {lib_note}")
    return out


def hetero_phase(dev) -> dict:
    """The NARS path and graph classification through the user's entry
    points on the card (section 9 of the module docstring).  Returns the
    CSR kernel's launches of the counted runs and the kernels' times at
    the two batch shapes."""
    from sgl_tpu_torch.datasets import SyntheticGraphClassification, SyntheticHeteroDataset
    from sgl_tpu_torch.graph import batch_graphs
    from sgl_tpu_torch.models import Fast_NARS_SGC_WithLearnableWeights, GraphSGC, GraphSIGN, NARS_SIGN
    from sgl_tpu_torch.tasks import GraphClassification, HeteroNodeClassification

    hetero_small_graph(dev)
    want = expected_hetero_launches()
    launches = {"f32": 0, "bf16": 0, "fixup_f32": 0, "fixup_bf16": 0}
    runs = {}

    def add(name, counts, fixups, peak, **numbers):
        for key in ("f32", "bf16"):
            launches[key] += counts[key]
            launches["fixup_" + key] += fixups[key]
        runs[name] = dict(launches=counts, fixups=fixups, peak_bytes=peak, **numbers)

    t = time.perf_counter()
    ds = SyntheticHeteroDataset(**NARS_DATASET)
    build_s = time.perf_counter() - t
    hg = ds.data
    log(f"[9] NARS dataset: {hg.num_node} nodes, " + ", ".join(
        f"{et} {e.num_edges}" for et, e in hg.edges.items()) + f" edges, {NARS_DATASET['feat_dim']} features, "
        f"{ds.num_classes} classes ({build_s:.2f} s on the host)")
    f, c, k = NARS_DATASET["feat_dim"], ds.num_classes, NARS_MODEL["prop_steps"]
    wide = (k, f, c, NARS_MODEL["hidden_dim"], NARS_MODEL["num_layers"], NARS_SUBSETS["random_subgraph_num"])
    for name, cls in (("Fast NARS", Fast_NARS_SGC_WithLearnableWeights), ("NARS_SIGN", NARS_SIGN)):
        model = cls(*wide)
        task, _, counts, fixups, peak = run_counted(name, lambda: HeteroNodeClassification(
            ds, "paper", model, device=dev, verbose=False, seed=NARS_SEED, **NARS_TRAIN, **NARS_SUBSETS,
            record_subgraph_weight=name == "Fast NARS"), **want[name], phase="9")
        pf = model.processed_feature
        check(pf.is_cuda and torch.isfinite(pf).all().item(), f"[9] {name}: bad features")
        check(0.0 <= task.test_acc <= 1.0, f"[9] {name}: test accuracy {task.test_acc}")
        epochs_ms = [s * 1e3 for s in task.epoch_seconds]
        add(name, counts, fixups, peak, sampling_s=model.sampling_seconds,
            preprocess_s=task.preprocess_seconds, epoch_ms=statistics.median(epochs_ms))
        extra = f", subgraph_weight {np.round(task.subgraph_weight, 4).tolist()}" if name == "Fast NARS" else ""
        log(f"[9] {name} ({NARS_MODEL}, {NARS_SUBSETS}, {NARS_TRAIN}): subsets {model.subgraph_keys}; "
            f"launches {counts}, fix-ups {fixups} (expected {want[name]['launches']}, {want[name]['fixups']}); "
            f"features {tuple(pf.shape)}; host sampling {model.sampling_seconds:.4f} s of preprocess "
            f"{task.preprocess_seconds:.4f} s; train epoch ms {[round(m, 3) for m in epochs_ms]}; peak device "
            f"memory {peak / 2**30:.3f} GiB; best-val test acc {task.test_acc:.4f}{extra}")
        del model, task, pf
    t = time.perf_counter()
    subgraphs = ds.nars_preprocess(ds.edge_types, "paper", seed=NARS_SEED, **NARS_SUBSETS)
    nars_batch = batch_graphs([g.replace(x=feat) for g, feat, _ in subgraphs.values()])
    log(f"[9] NARS batch rebuilt for the kernel probe in {time.perf_counter() - t:.2f} s: "
        f"{nars_batch.num_nodes} nodes, {nars_batch.graph.num_edges} edges")
    times = {"nars": batch_kernel_times(nars_batch, dev, "the NARS batch")}
    del ds, subgraphs, nars_batch
    torch.cuda.empty_cache()

    t = time.perf_counter()
    gds = SyntheticGraphClassification(**GRAPH_DATASET)
    build_s = time.perf_counter() - t
    fg, cg = gds.num_features, gds.num_classes
    graph_runs = (
        ("GraphSIGN", lambda: GraphSIGN(GRAPH_STEPS, fg, cg, hidden_dim=GRAPH_HIDDEN, num_layers=2,
                                        readout="mean"), None),
        ("GraphSGC bf16", lambda: GraphSGC(GRAPH_STEPS, fg, cg, readout="max"), torch.bfloat16),
    )
    batch_s = None
    for name, make, dtype in graph_runs:
        model = make()
        task, _, counts, fixups, peak = run_counted(name, lambda: GraphClassification(
            gds, model, device=dev, verbose=False, precompute_dtype=dtype, **GRAPH_TRAIN), **want[name], phase="9")
        batch_s = task.batch_seconds if batch_s is None else batch_s
        pf = model.processed_feature
        check(pf.is_cuda and pf.dtype == (dtype or torch.float32) and torch.isfinite(pf.float()).all().item(),
              f"[9] {name}: bad features")
        check(0.0 <= task.test_acc <= 1.0, f"[9] {name}: test accuracy {task.test_acc}")
        epochs_ms = [s * 1e3 for s in task.epoch_seconds]
        add(name, counts, fixups, peak, preprocess_s=task.preprocess_seconds,
            epoch_ms=statistics.median(epochs_ms))
        log(f"[9] {name} ({GRAPH_STEPS} hops, {GRAPH_TRAIN}): launches {counts}, fix-ups {fixups} (expected "
            f"{want[name]['launches']}, {want[name]['fixups']}); pooled features {tuple(pf.shape)} {pf.dtype}; "
            f"preprocess {task.preprocess_seconds:.4f} s; train epoch ms median "
            f"{statistics.median(epochs_ms):.3f} (first {epochs_ms[0]:.3f}); peak device memory "
            f"{peak / 2**30:.3f} GiB; best-val test acc {task.test_acc:.4f}")
        del model, task, pf
    batch = gds.batch()
    log(f"[9] graph dataset: {gds.num_graphs} graphs, {batch.num_nodes} nodes, {batch.graph.num_edges} edges, "
        f"{fg} features, {cg} classes; {build_s:.2f} s to generate the graphs and {batch_s:.2f} s to batch "
        f"them on the host")
    times["graph"] = batch_kernel_times(batch, dev, "the graph-level batch")
    log(f"[9] runs (s / ms / GiB): " + ", ".join(
        f"{k} (" + ", ".join(f"{m} {v:.4f}" if isinstance(v, float) else f"{m} {v}" for m, v in r.items()
                             if m not in ("launches", "fixups")) + ")" for k, r in runs.items()))
    return dict(launches=launches, times=times, runs=runs)


# -- phase 10: out of core ---------------------------------------------------------

# the small graph of phase 10's first part, and a part size that cuts it in ~7
OOC_SMALL = dict(num_nodes=3_000, avg_degree=8, feat_dim=64, seed=0)
OOC_SMALL_PART_EDGES = 4096
OOC_SOURCE = "sgl_tpu_torch/kernels/spmm_ooc.py"
# the TPU path's calls of its CSR kernel that the out-of-core forms replace
OOC_REPLACES = {
    "1d": "sgl_tpu/kernels/spmm_ooc.py:211",  # _ooc_step
    "2d": "sgl_tpu/kernels/spmm_ooc.py:893",  # _ooc_step_2d, and _ooc_cell_2d at :921
    "resident": "sgl_tpu/kernels/spmm_ooc.py:1310",  # _resident_class_scan
}
# the products hops of phase 10: (name, layout, dtype, src_blocks)
OOC_FORMS = (
    ("1d f32", "1d", "f32", None),
    ("2d f32", "2d", "f32", "auto"),
    ("2d bf16", "2d", "bf16", "auto"),
    ("2d f32 src_blocks=1", "2d", "f32", 1),
)


def expected_ooc_launches(oc) -> tuple:
    """One hop's (first-pass, fix-up) launches, worked out from the layout on
    the host: a 1-D hop launches each part once, a 2-D hop (and the
    resident executor) each non-empty cell once; each adds a fix-up where
    the part or cell holds a row of more than ``SPLIT_NNZ`` nonzeros."""
    from sgl_tpu_torch.kernels import OutOfCoreAdj

    subs = [p.csr for p in oc.parts] if isinstance(oc, OutOfCoreAdj) else [c for row in oc.parts for c in row]
    subs = [c for c in subs if c.nnz]
    return len(subs), sum(c.counts[3] > 0 for c in subs)


def ooc_small_graph(dev) -> None:
    """Every out-of-core form on a small graph, f32 and bf16: on the card
    against the port's CPU path of the same function and against the
    one-shot ``spmm_csr``; two runs bit-equal."""
    from sgl_tpu_torch.datasets import random_power_law_graph
    from sgl_tpu_torch.graph import symmetric_normalized_weights, symmetric_normalized_weights_host
    from sgl_tpu_torch.kernels import (
        prepare_csr, prepare_out_of_core, prepare_out_of_core_2d, spmm_2d_resident, spmm_csr,
        spmm_out_of_core, spmm_out_of_core_2d,
    )

    g = random_power_law_graph(**OOC_SMALL)
    adj = symmetric_normalized_weights_host(g)
    csr = prepare_csr(symmetric_normalized_weights(g, device=dev))
    layouts = {"1d": prepare_out_of_core(adj, OOC_SMALL_PART_EDGES)}
    for k in (1, 2, 3):
        layouts[f"2d src_blocks={k}"] = prepare_out_of_core_2d(adj, OOC_SMALL_PART_EDGES, k, feat_dim=64)
    x32 = torch.as_tensor(g.x)
    for key, dtype in DTYPES.items():
        x = x32.to(dtype)
        one_shot = spmm_csr(csr, x.to(dev)).cpu()
        worst = {"cpu": 0.0, "one-shot": 0.0}
        for name, oc in layouts.items():
            if name == "1d":
                forms = [(name, lambda d_, oc=oc: spmm_out_of_core(oc, x, device=d_))]
            else:
                forms = [(name, lambda d_, oc=oc: spmm_out_of_core_2d(oc, x, device=d_, max_device_acc_bytes=1 << 20)),
                         (f"resident {name}", lambda d_, oc=oc: spmm_2d_resident(oc, x.to(d_)).cpu())]
            for fname, run in forms:
                got = torch.as_tensor(run(dev))
                torch.cuda.synchronize()
                want = torch.as_tensor(run("cpu"))
                where = f"[10] small graph {fname} {key}"
                check(got.dtype == dtype and got.shape == x.shape and not got.is_cuda,
                      f"{where}: {got.dtype} {tuple(got.shape)} {got.device}")
                check(torch.isfinite(got.float()).all().item(), f"{where}: non-finite output")
                e_cpu, e_one = rel_err(got, want)[1], rel_err(got, one_shot)[1]
                check(e_cpu <= TOL[key], f"{where}: card vs the CPU path {e_cpu:.3e}")
                check(e_one <= ORDER_TOL[key], f"{where}: vs one-shot spmm_csr {e_one:.3e}")
                check_repeatable(lambda: torch.as_tensor(run(dev)), where)
                worst = {"cpu": max(worst["cpu"], e_cpu), "one-shot": max(worst["one-shot"], e_one)}
        log(f"[10] small graph ({OOC_SMALL}, parts of {OOC_SMALL_PART_EDGES}) {key}: 1-D "
            f"({layouts['1d'].num_parts} parts), 2-D at src_blocks 1/2/3 and the resident executor: max rel "
            f"err vs the CPU path {worst['cpu']:.3e} (limit {TOL[key]:.0e}), vs one-shot spmm_csr "
            f"{worst['one-shot']:.3e} (limit {ORDER_TOL[key]:.0e}); two runs bit-equal")


def describe_split(split: dict) -> str:
    """The host's split of one hop (``host_split``), for the log line."""
    steps = ", ".join(f"{k.strip()} {v:.4f}" for k, v in split["steps_s"].items())
    return (f"the host's split of a hop {split['hop_s']:.4f} s: {steps}, the rest {split['rest_s']:.4f} s "
            f"(into an output written before {split['pretouched_s']:.4f} s)")


def describe_trace(t: dict) -> str:
    """A hop's trace (``device_overlap``), for the log line: its numbers
    only when it is complete."""
    head = (f"{t['tries']} trace(s), the last {t['copies']} copies of {t['h2d_bytes'] / 1e9:.4f} + "
            f"{t['d2h_bytes'] / 1e9:.4f} GB in {t['copy_sum_ms']:.4f} ms")
    if not t["complete"]:
        return head + ": incomplete (fewer bytes or less time than the plain copies), overlap not measured"
    return (head + f": copies {t['copy_ms']:.4f} ms, kernels and memsets {t['compute_ms']:.4f} ms, busy "
            f"{t['busy_ms']:.4f} ms, overlap share {t['overlap_share']:.4f}, idle share of the hop "
            f"{t['idle_share']:.4f}")


def ooc_launch_times(items, d: int, key: str) -> dict:
    """K3/K4 at an out-of-core call site alone: each part's or cell's launch
    on inputs already on the card, held against its plain twin on the same
    inputs (each into a zeroed accumulator of its own, the worst relative
    error within ``TOL[key]``), then timed (CUDA events) and summed; beside
    it the plain twin's time and ``torch.sparse.mm`` on each part (its
    duplicate entries summed), and the bound of the kernel's own bytes
    (each part's rowptr, col and val, its workspace read once, its
    accumulator rows read and written once).  ``items`` yields ``(CsrPart,
    workspace, accumulator)``."""
    from sgl_tpu_torch.kernels import spmm_csr_acc, spmm_csr_acc_reference

    ms = plain = 0.0
    lib, nbytes, nnz, errs = 0.0, 0, 0, (0.0, 0.0)
    for part, ws, acc in items:
        got = spmm_csr_acc(part, ws, torch.zeros_like(acc)).narrow(0, part.row_offset, part.num_rows)
        want = spmm_csr_acc_reference(part, ws, torch.zeros_like(acc)).narrow(0, part.row_offset, part.num_rows)
        err = rel_err(got, want)
        check(err[1] <= TOL[key], f"[10] {key} part or cell at row {part.row_offset}: kernel vs its plain "
                                  f"twin {err[1]:.3e}")
        errs = (max(errs[0], err[0]), max(errs[1], err[1]))
        del got, want
        ms += time_ms(lambda: spmm_csr_acc(part, ws, acc), warmup=1, iters=5)
        plain += time_ms(lambda: spmm_csr_acc_reference(part, ws, acc), warmup=0, iters=1)
        if lib is not None:
            try:
                # duplicate entries summed first: cuSPARSE refuses a part whose
                # entries outnumber its rows x columns (the graph has multi-edges)
                rows = torch.repeat_interleave(torch.arange(part.num_rows, device=ws.device),
                                               torch.diff(part.rowptr.long()))
                a = torch.sparse_coo_tensor(torch.stack([rows, part.col.long()]), part.val.to(ws.dtype),
                                            (part.num_rows, ws.shape[0])).coalesce().to_sparse_csr()
                lib += time_ms(lambda: torch.sparse.mm(a, ws), warmup=1, iters=5)
            except (RuntimeError, NotImplementedError):  # the yardstick only
                lib = None
        nbytes += 4 * (part.num_rows + 1) + 8 * part.nnz + ws.numel() * ws.element_size() + 2 * part.num_rows * d * 4
        nnz += part.nnz
    return dict(ms=ms, plain_ms=plain, library_ms=lib, kernel_bytes=nbytes, max_abs_err=errs[0],
                max_rel_err=errs[1], **bound(nbytes, nnz, d))


def ooc_items(oc, x_dev, dev):
    """``(CsrPart, workspace, accumulator)`` for each part (1-D, its
    workspace gathered on the card) or non-empty cell (2-D) of a layout
    whose edges the last hop left on the card."""
    from sgl_tpu_torch.kernels import OutOfCoreAdj
    from sgl_tpu_torch.kernels.spmm_ooc import _upload

    d = x_dev.shape[1]
    if isinstance(oc, OutOfCoreAdj):
        for i, p in enumerate(oc.parts):
            if p.csr.nnz:
                part = oc._dev_edges.get(i) or _upload(p.csr, dev, p.cols.shape[0])
                ws = x_dev.index_select(0, torch.as_tensor(p.cols, device=dev).long())
                yield part, ws, torch.zeros((p.num_rows, d), device=dev)
        return
    for p, row in enumerate(oc.parts):
        acc = torch.zeros((oc.valid_rows[p], d), device=dev)
        for b, c in enumerate(row):
            if c.nnz:
                lo, rows = oc.block_range(b)
                part = oc._dev_edges.get((p, b)) or _upload(c, dev, rows)
                yield part, x_dev.narrow(0, lo, rows), acc


def ooc_products_phase(dev, graph, refs) -> dict:
    """One out-of-core hop of each form on phase 5's products graph, held
    against phase 5's streaming hop of the same dtype (and f32 against its
    float64 sum); its layout, cold build and warm cache load, transfer
    bytes, hop time, ``null_transfer`` time, plain pinned copies, the
    host's split of a hop, the overlap shares and each part's or cell's
    launch against its plain twin; then the resident executor."""
    from sgl_tpu_torch.graph import symmetric_normalized_weights_host
    from sgl_tpu_torch.kernels import (
        hop_transfer_bytes, load_out_of_core_2d, prepare_out_of_core, prepare_out_of_core_2d,
        spmm_2d_resident, spmm_out_of_core, spmm_out_of_core_2d,
    )
    t = time.perf_counter()
    adj = symmetric_normalized_weights_host(graph)
    norm_s = time.perf_counter() - t
    ref = {k: v.to(dev) for k, v in refs.items()}
    x32 = torch.as_tensor(graph.x)
    n, d = x32.shape
    results, resident_layout = {}, None
    for name, layout, key, blocks in OOC_FORMS:
        dtype = DTYPES[key]
        x_host = x32.numpy() if key == "f32" else x32.to(dtype)
        elem = torch.empty((), dtype=dtype).element_size()
        with tempfile.TemporaryDirectory() as cache:
            t = time.perf_counter()
            if layout == "1d":
                oc = prepare_out_of_core(adj, PRODUCTS["part_edges"])
                cold, warm, open_s = time.perf_counter() - t, None, None
                spmm = spmm_out_of_core
                shape = (f"{oc.num_parts} parts, workspaces {sum(oc.workspace_rows)} rows "
                         f"({sum(oc.workspace_rows) / n:.3f} feature volumes)")
            else:
                kw = dict(src_blocks=blocks, feat_dim=d, feat_dtype=dtype, cache_dir=cache)
                built = prepare_out_of_core_2d(adj, PRODUCTS["part_edges"], **kw)
                cold = time.perf_counter() - t
                t = time.perf_counter()
                oc = prepare_out_of_core_2d(adj, PRODUCTS["part_edges"], **kw)  # from the cache
                warm = time.perf_counter() - t
                (entry,) = os.listdir(cache)
                t = time.perf_counter()
                load_out_of_core_2d(os.path.join(cache, entry))
                open_s = time.perf_counter() - t
                check(oc.num_cells == built.num_cells and oc.row_offsets == built.row_offsets,
                      f"{name}: the cached layout differs from the built one")
                if name == "2d f32":
                    resident_layout = built
                spmm = spmm_out_of_core_2d
                shape = (f"{oc.num_parts} parts x {oc.num_blocks} blocks of {oc.block_rows} rows, "
                         f"{oc.num_cells} non-empty cells")
            h2d, d2h = hop_transfer_bytes(oc, d, elem)
            want = expected_ooc_launches(oc)
            acc_key = "acc_" + key
            y, first_s, *_ = run_counted(f"products {name}", lambda: spmm(oc, x_host, device=dev),
                                         {acc_key: want[0]}, {acc_key: want[1]}, "10")
            y_dev = torch.as_tensor(y).to(dev)
            check(y_dev.dtype == dtype and tuple(y_dev.shape) == (n, d), f"{name}: {y_dev.dtype} {tuple(y_dev.shape)}")
            check(torch.isfinite(y_dev.float()).all().item(), f"{name}: non-finite hop")
            e_stream = rel_err(y_dev, ref[key])[1]
            check(e_stream <= ORDER_TOL[key], f"products {name}: vs phase 5's streaming hop {e_stream:.3e}")
            e64 = rel_err(y_dev, ref["f64"])[1] if key == "f32" else None
            check(e64 is None or e64 <= ORDER_TOL["f32"], f"products {name}: vs phase 5's float64 sum {e64}")
            del y_dev
            t = time.perf_counter()
            spmm(oc, x_host, device=dev)
            hop_s = time.perf_counter() - t
            spmm(oc, x_host, device=dev, null_transfer=True)
            t = time.perf_counter()
            spmm(oc, x_host, device=dev, null_transfer=True)
            null_s = time.perf_counter() - t
            split = host_split(spmm, oc, x_host, dev)
            h2d_ms, d2h_ms = copy_ms(h2d, True, dev), copy_ms(d2h, False, dev)
            copy_s = (h2d_ms + d2h_ms) / 1e3
            overlap = (copy_s + null_s - hop_s) / min(copy_s, null_s)
            traced = device_overlap(lambda: spmm(oc, x_host, device=dev), (h2d, d2h), h2d_ms + d2h_ms, hop_s * 1e3)
            x_dev = (torch.from_numpy(x_host) if key == "f32" else x_host).to(dev)
            kt = ooc_launch_times(ooc_items(oc, x_dev, dev), d, key)
            del x_dev
            nnz_all = int(adj.w.count_nonzero())
            log(f"[10] products {name}: {shape}; normalize on the host {norm_s:.4f} s; layout cold build "
                f"{cold:.4f} s" + (f", warm cache load {warm:.4f} s (opening its files {open_s:.4f} s, the "
                                   f"rest the content key's hash of the edges)" if warm is not None else "")
                + f"; launches {want[0]} + {want[1]} fix-ups a hop (held); H2D {h2d / 1e9:.4f} GB, D2H "
                f"{d2h / 1e9:.4f} GB a hop; first hop {first_s:.4f} s, hop {hop_s:.4f} s "
                f"({nnz_all / hop_s / 1e9:.4f} G nonzeros/s); null_transfer {null_s:.4f} s; plain pinned "
                f"copy_ H2D {h2d_ms:.4f} ms ({h2d / h2d_ms / 1e6:.2f} GB/s), D2H {d2h_ms:.4f} ms "
                f"({d2h / d2h_ms / 1e6:.2f} GB/s); overlap share "
                f"{overlap:.4f}; {describe_split(split)}; on the card (torch.profiler) {describe_trace(traced)}"
                + f"; each part or cell's launch vs its plain twin max rel err {kt['max_rel_err']:.3e} (limit "
                f"{TOL[key]:.0e}); the hop vs phase 5's streaming hop {e_stream:.3e} (limit "
                f"{ORDER_TOL[key]:.0e})" + (f", vs its float64 sum {e64:.3e}" if e64 is not None else "")
                + f"; {acc_key} launches alone {kt['ms']:.4f} ms (plain twin {kt['plain_ms']:.4f} ms, "
                f"torch.sparse.mm on each part {kt['library_ms']}, bound {kt['bound_ms']:.4f} ms: "
                f"{kt['kernel_bytes'] / 1e9:.4f} GB at 3.35 TB/s)")
            results[name] = dict(
                key=key, replaces=OOC_REPLACES[layout], launches=want[0], fixup_launches=want[1],
                parts=oc.num_parts, cells=getattr(oc, "num_cells", oc.num_parts),
                blocks=getattr(oc, "num_blocks", None), cold_build_s=cold, warm_load_s=warm, open_s=open_s,
                h2d_bytes=h2d, d2h_bytes=d2h, first_hop_s=first_s, hop_s=hop_s, null_transfer_s=null_s,
                h2d_copy_ms=h2d_ms, d2h_copy_ms=d2h_ms, overlap_share=overlap,
                host_split=split, device_overlap=traced,
                rel_err_stream=e_stream, rel_err_f64=e64, transfer_ms=h2d_ms + d2h_ms, **kt,
            )
            del oc, y
    # the resident executor: x on the card, the 2-D f32 layout's cells
    x_dev = x32.to(dev)
    want = expected_ooc_launches(resident_layout)
    y = run_counted("products resident", lambda: spmm_2d_resident(resident_layout, x_dev),
                    {"acc_f32": want[0]}, {"acc_f32": want[1]}, "10")[0]
    e_stream = rel_err(y, ref["f32"])[1]
    e64 = rel_err(y, ref["f64"])[1]
    check(e_stream <= ORDER_TOL["f32"] and e64 <= ORDER_TOL["f32"],
          f"products resident: vs phase 5's streaming hop {e_stream:.3e}, float64 {e64:.3e}")
    call_ms = time_ms(lambda: spmm_2d_resident(resident_layout, x_dev), warmup=1, iters=5)
    y_acc = torch.zeros((n, d), device=dev)
    items = ((part, x_dev.narrow(0, *resident_layout.block_range(b)), y_acc)
             for b, part in resident_layout._dev_stacks[x_dev.device])
    kt = ooc_launch_times(items, d, "f32")
    log(f"[10] products resident (spmm_2d_resident, f32, {resident_layout.num_cells} cells): launches "
        f"{want[0]} + {want[1]} fix-ups (held); call {call_ms:.4f} ms; each cell's launch vs its plain twin "
        f"{kt['max_rel_err']:.3e} (limit {TOL['f32']:.0e}); the call vs phase 5's streaming hop "
        f"{e_stream:.3e}, vs its float64 sum {e64:.3e}; acc_f32 launches alone {kt['ms']:.4f} ms (plain twin "
        f"{kt['plain_ms']:.4f} ms, torch.sparse.mm on each cell {kt['library_ms']}, bound "
        f"{kt['bound_ms']:.4f} ms)")
    results["resident f32"] = dict(key="f32", replaces=OOC_REPLACES["resident"], launches=want[0],
                                   fixup_launches=want[1], call_ms=call_ms, rel_err_stream=e_stream,
                                   rel_err_f64=e64, **kt)
    del ref, x_dev, y, y_acc
    torch.cuda.empty_cache()
    return results


def papers_phase(dev) -> dict:
    """``papers100m_pipeline.main`` at its defaults into a temporary store,
    its launches held; the stored hops against ``GraphOp.propagate`` of the
    same graph on the card (K1) and, f32, each against a float64 product of
    the one before; training from the store; its peak device memory beside
    the size of the hop stack."""
    from sgl_tpu_torch.datasets import SyntheticPowerLaw
    from sgl_tpu_torch.examples import papers100m_pipeline
    from sgl_tpu_torch.graph import symmetric_normalized_weights_host
    from sgl_tpu_torch.kernels import prepare_out_of_core_2d
    from sgl_tpu_torch.ops import LaplacianGraphOp

    # the launches to expect, from the pipeline's layout built on the host first
    args = papers100m_pipeline.parse_args([])
    graph = SyntheticPowerLaw(num_nodes=args.nodes, avg_degree=args.avg_deg, feat_dim=args.d,
                              num_classes=args.classes, seed=0).graph
    layout = prepare_out_of_core_2d(symmetric_normalized_weights_host(graph), args.part_edges,
                                    args.src_blocks, feat_dim=args.d)
    per_hop = expected_ooc_launches(layout)
    # what earlier phases left allocated: the pipeline's own peak is above it
    base = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as tmp:
        out, _, counts, fixups, peak = run_counted(
            "papers100m pipeline", lambda: papers100m_pipeline.main(["--store", f"{tmp}/store"]),
            {"acc_f32": args.hops * per_hop[0]}, {"acc_f32": args.hops * per_hop[1]}, "10")
        oc = out["layout"]
        check(oc.num_cells == layout.num_cells and oc.row_offsets == layout.row_offsets,
              "papers100m pipeline: its layout differs from the one built first")
        ds, sink, task = out["dataset"], out["sink"], out["task"]
        peak, precompute_peak = peak - base, out["precompute_peak_bytes"] - base
        n, d = ds.num_node, ds.num_features
        stack_bytes = (args.hops + 1) * n * d * 4
        check(peak < stack_bytes, f"papers100m pipeline: peak {peak} bytes, the hop stack {stack_bytes}")
        op = LaplacianGraphOp(args.hops)
        in_memory = op.propagate(ds.graph, ds.x, device=dev)
        csr = op._adj_for(ds.graph, dev)
        stored = [torch.from_numpy(np.load(sink.path(k))).to(dev) for k in range(args.hops + 1)]
        e_k1 = max(rel_err(stored[k], in_memory[k])[1] for k in range(1, args.hops + 1))
        e64 = max(rel_err(stored[k], f64_sum(csr, stored[k - 1]))[1] for k in range(1, args.hops + 1))
        check(e_k1 <= TOL["f32"], f"papers100m pipeline: stored hops vs GraphOp.propagate {e_k1:.3e}")
        check(e64 <= F64_TOL, f"papers100m pipeline: stored hops vs a float64 product {e64:.3e}")
        check(all(np.isfinite(task.train_losses)), f"papers100m losses {task.train_losses}")
        log(f"[10] papers100m pipeline (defaults: {n} nodes, avg degree {args.avg_deg}, d={d}, "
            f"{ds.num_classes} classes, GAMLP hidden 256 x 3 layers, {args.hops} hops, batch {args.batch}, "
            f"{args.epochs} epochs): layout {oc.num_parts} parts x {oc.num_blocks} blocks ({oc.num_cells} cells); "
            f"its peak device memory by the end of the precompute {precompute_peak / 1e9:.4f} GB; "
            f"launches {counts['acc_f32']} + {fixups['acc_f32']} fix-ups (held: {args.hops} x {per_hop}); "
            f"ingest {out['ingest_seconds']:.4f} s; precompute {out['precompute_seconds'] / args.hops:.4f} s/hop; "
            f"store {out['store_bytes'] / 1e9:.4f} GB; epochs {[round(v, 4) for v in task.epoch_seconds]} s; "
            f"losses {[round(v, 4) for v in task.train_losses]}; test acc {task.test_acc:.4f}; its peak device "
            f"memory {peak / 1e9:.4f} GB = {peak / stack_bytes:.4f} of the {stack_bytes / 1e9:.4f} GB hop stack "
            f"(above the {base / 1e9:.4f} GB earlier phases hold); "
            f"stored hops vs GraphOp.propagate (K1) {e_k1:.3e} (limit {TOL['f32']:.0e}), vs a float64 "
            f"product {e64:.3e} (limit {F64_TOL:.0e})")
        result = dict(launches=counts["acc_f32"], fixup_launches=fixups["acc_f32"],
                      precompute_s_per_hop=out["precompute_seconds"] / args.hops, store_bytes=out["store_bytes"],
                      epoch_s=task.epoch_seconds, test_acc=task.test_acc, peak_bytes=peak,
                      precompute_peak_bytes=precompute_peak,
                      stack_bytes=stack_bytes, max_rel_err=e_k1, rel_err_f64=e64)
        del out, in_memory, stored, task, ds, sink, csr, oc
    torch.cuda.empty_cache()
    return result


def ooc_phase(dev, graph, refs) -> dict:
    """Phase 10: the small graph, the products hops and the papers100M
    pipeline."""
    ooc_small_graph(dev)
    products = ooc_products_phase(dev, graph, refs)
    return {"products": products, "papers": papers_phase(dev)}


# -- phase 11: NAS on the card ------------------------------------------------------

# ogbn-arxiv's published shape: nodes, directed edges, width, classes, and
# the time split's train / valid / test sizes; the graph, features and
# labels from SyntheticPowerLaw (14 edges a node: ~1.18M draws)
NAS_OGB = dict(num_nodes=169_343, num_edges=1_166_243, feat_dim=128, num_classes=40,
               split=(90_941, 29_799, 48_603), avg_degree=14, seed=0)
# examples/test_nas.py's search
NAS_ARCH = (2, 1, 1, 2, 3, 1, 0)
NAS_TRAIN = dict(lr=1e-2, weight_decay=5e-4, epochs=50, hidden_dim=128)
NAS_RESTARTS = 2
NAS_RUN = dict(max_runs=12, optimizer="auto", seed=1)
NAS_SHA = dict(n_configs=9, eta=3, min_epochs=5, seed=1)
# tests/test_search.py's small graph, and one arch for each message type 0-8
# (post types 0-5 among them; every graph-op type)
NAS_SMALL = dict(num_nodes=200, feat_dim=12, p_in=0.08, seed=4)
NAS_SMALL_ARCHS = tuple((1 + m % 3, 1 + m % 4, m, 1 + m % 3, 1 + (m + 1) % 3, 1 + (m + 2) % 4, m % 6)
                        for m in range(9))
# the resumable precompute: stopped after this hop, then resumed to the last
NAS_RESUME = (2, 5)


def write_ogb_raw(root: str, shape: dict = None, name: str = "arxiv") -> dict:
    """OGB raw files of ``shape`` in the standard layout under
    ``root/ogbn/<name>/ogbn_<name>`` (what ``Ogbn(name, root)`` reads, the
    split under the dataset's official split directory), gzip level 1,
    from ``SyntheticPowerLaw``: ``num_edges`` of its edges, each drawn pair
    once in a seeded order, its features and labels, and a seeded split.
    Returns the arrays written and the paths."""
    import gzip

    from sgl_tpu_torch.datasets import SyntheticPowerLaw
    from sgl_tpu_torch.datasets.ogbn import _SPLIT_DIRS

    shape = shape or NAS_OGB
    n, e = shape["num_nodes"], shape["num_edges"]
    ds = SyntheticPowerLaw(num_nodes=n, avg_degree=shape["avg_degree"], feat_dim=shape["feat_dim"],
                           num_classes=shape["num_classes"], seed=shape["seed"])
    src, dst, _ = ds.graph.edges()
    once = src < dst  # the graph holds each drawn pair both ways
    check(int(once.sum()) >= e, f"the synthetic graph has {int(once.sum())} pairs, fewer than {e}")
    rng = np.random.default_rng(shape["seed"])
    pick = rng.permutation(int(once.sum()))[:e]
    edges = np.stack([src[once][pick], dst[once][pick]], axis=1).astype(np.int64)
    perm = rng.permutation(n)
    n_train, n_valid, _ = shape["split"]
    split = {"train": perm[:n_train], "valid": perm[n_train:n_train + n_valid], "test": perm[n_train + n_valid:]}
    d = os.path.join(root, "ogbn", name, f"ogbn_{name}")
    split_dir = os.path.join("split", _SPLIT_DIRS[name])
    os.makedirs(os.path.join(d, "raw"), exist_ok=True)
    os.makedirs(os.path.join(d, split_dir), exist_ok=True)

    def write(rel, arr, fmt):
        path = os.path.join(d, rel)
        with gzip.open(path, "wt", compresslevel=1) as f:
            np.savetxt(f, arr, fmt=fmt, delimiter=",")
        return path

    paths = {
        "edge": write("raw/edge.csv.gz", edges, "%d"),
        "node-feat": write("raw/node-feat.csv.gz", ds.x, "%.6g"),
        "node-label": write("raw/node-label.csv.gz", np.asarray(ds.y)[:, None], "%d"),
    }
    for part, idx in split.items():
        paths[part] = write(os.path.join(split_dir, f"{part}.csv.gz"), idx[:, None], "%d")
    return dict(paths=paths, edges=edges, x=ds.x, y=np.asarray(ds.y), split=split)


def expected_nas_launches(history, cache, split_rows: bool) -> tuple:
    """K1's (f32) launches of a NAS run and its fix-ups: the cache's
    ``hops_computed`` (the pre-propagation's products: misses and
    extensions) plus each trial's ``post_steps`` (every trial with a post
    graph op post-propagates once), and as many fix-ups when the graph's
    plan has split rows (every op of the space shares the graph's rows),
    else none.  ``PERF.md`` §6 states them."""
    post = sum(t.config["post_steps"] for t in history.trials
               if t.config["post_types"] != 0 and t.config["post_steps"] != 0)
    launches = cache.hops_computed + post
    return launches, launches if split_rows else 0


def nas_small_graph(dev) -> None:
    """One arch of each message type on the small graph: the card's
    preprocessed features (through a propagation cache), logits and
    post-processed output against the port's CPU path, the same weights
    (the CPU model's ``state_dict``)."""
    from sgl_tpu_torch.datasets import PlantedPartition
    from sgl_tpu_torch.search import PropagationCache, SearchModel

    cpu = torch.device("cpu")
    ds = PlantedPartition(**NAS_SMALL)
    caches = {cpu: PropagationCache(), dev: PropagationCache()}
    worst = 0.0
    for arch in NAS_SMALL_ARCHS:
        out = {}
        models = {where: SearchModel(arch, ds.num_features, ds.num_classes, hidden_dim=16) for where in (cpu, dev)}
        models[cpu].init(torch.Generator().manual_seed(sum(arch)))
        models[dev].net.load_state_dict(models[cpu].net.state_dict())
        models[dev].net.to(dev)
        for where, m in models.items():
            m.preprocess(ds.graph, ds.x, device=where, prop_cache=caches[where])
            with torch.no_grad():
                logits = m.net(m.batch_input(torch.arange(ds.num_node, device=where)))
                out[where] = (m.processed_feature, logits, m.postprocess(ds.graph, logits))
        check(all(t.is_cuda for t in out[dev]), f"[11] arch {arch}: not on the card")
        for name, got, want in zip(("features", "logits", "post-processed"), out[dev], out[cpu]):
            err = rel_err(got.cpu(), want)[1]
            worst = max(worst, err)
            check(err <= TOL["f32"], f"[11] arch {arch}: {name} card vs CPU {err:.3e}")
    log(f"[11] small graph ({NAS_SMALL}): {len(NAS_SMALL_ARCHS)} archs {list(NAS_SMALL_ARCHS)} (message types "
        f"0-8, post types 0-5): features, logits and post-processed output, card vs CPU, max rel err "
        f"{worst:.3e} (limit {TOL['f32']:.0e})")


def nas_cache_check(dev, ds) -> dict:
    """The cache's stacks (a first request, a prefix, an extension) against
    ``GraphOp.propagate`` at the same depth on the card, one Laplacian and
    one PPR config; whether the extension is bit-equal to the direct run."""
    from sgl_tpu_torch.ops import LaplacianGraphOp, PprGraphOp
    from sgl_tpu_torch.search import PropagationCache

    out = {}
    for name, make in (("laplacian", lambda k: LaplacianGraphOp(k, r=0.5)),
                       ("ppr 0.2", lambda k: PprGraphOp(k, r=0.5, alpha=0.2))):
        cache = PropagationCache()
        direct = make(5).propagate(ds.graph, ds.x, device=dev)
        first, _ = cache.hops_for(ds.graph, ds.x, make(3), device=dev)
        prefix, _ = cache.hops_for(ds.graph, ds.x, make(2), device=dev)
        extended, _ = cache.hops_for(ds.graph, ds.x, make(5), device=dev)
        errs = [rel_err(got, direct[: got.shape[0]])[1] for got in (first, prefix, extended)]
        check(max(errs) <= TOL["f32"], f"[11] cache {name}: vs direct propagation {errs}")
        check((cache.misses, cache.hits, cache.hops_computed) == (1, 2, 5), f"[11] cache {name}: stats")
        out[name] = dict(max_rel_err=max(errs), bit_equal=bool(torch.equal(extended, direct)))
        del cache, direct, first, prefix, extended
    log(f"[11] cache vs GraphOp.propagate (hops 3, a prefix of 2, extended to 5; limit {TOL['f32']:.0e}): "
        + ", ".join(f"{k} max rel err {v['max_rel_err']:.3e}, extension bit-equal {v['bit_equal']}"
                    for k, v in out.items()))
    return out


def nas_resume_check(dev, ds, tmp: str) -> dict:
    """``HopCheckpointer.propagate_resumable`` stopped after hop
    ``NAS_RESUME[0]`` and resumed to ``NAS_RESUME[1]``: bit-equal to an
    uninterrupted run on the card, within ``TOL`` of the CPU path."""
    from sgl_tpu_torch.graph import symmetric_normalized_weights
    from sgl_tpu_torch.kernels import prepare_csr
    from sgl_tpu_torch.utils import HopCheckpointer

    stop, k = NAS_RESUME
    adj = prepare_csr(symmetric_normalized_weights(ds.graph, device=dev))
    t = time.perf_counter()
    HopCheckpointer(f"{tmp}/resumed").propagate_resumable(adj, ds.x, stop, device=dev)
    resumed = HopCheckpointer(f"{tmp}/resumed").propagate_resumable(adj, ds.x, k, device=dev)
    resume_s = time.perf_counter() - t
    whole = HopCheckpointer(f"{tmp}/whole").propagate_resumable(adj, ds.x, k, device=dev)
    adj_cpu = prepare_csr(symmetric_normalized_weights(ds.graph, device="cpu"))
    on_cpu = HopCheckpointer(f"{tmp}/cpu").propagate_resumable(adj_cpu, ds.x, k, device="cpu")
    check(resumed.is_cuda and tuple(resumed.shape) == (k + 1, ds.num_node, ds.num_features), "[11] resumed stack")
    check(torch.equal(resumed, whole), "[11] the resumed precompute differs from an uninterrupted one")
    err = rel_err(resumed.cpu(), on_cpu)[1]
    check(err <= TOL["f32"], f"[11] resumed precompute vs the CPU path {err:.3e}")
    log(f"[11] resumable precompute: {stop} hops, resumed to {k} ({resume_s:.4f} s with the hop files), "
        f"bit-equal to an uninterrupted run; vs the CPU path max rel err {err:.3e} (limit {TOL['f32']:.0e})")
    return dict(max_rel_err=err, bit_equal=True, seconds=resume_s)


def nas_trial_split(configer, config: dict) -> dict:
    """Where one NAS trial's time goes: its wall milliseconds (host clock
    around a run that ends in a synchronize), the card's busy time from a
    trace of another run (``ooc_probe.device_events``: after a warm-up run;
    the union of its kernels, copies and memsets), the idle share, and the
    device time by kernel name, the largest first.  The trace is held to
    the trial's K1 launches: its post steps, each with its fix-up when the
    plan has split rows, and no pre-hop (a prefix of the warm cache)."""
    from sgl_tpu_torch.dev.ooc_probe import busy_ms, device_events

    def run():
        return configer._configFunction(dict(config))

    run()
    torch.cuda.synchronize()
    t = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    events = device_events(run)
    busy = busy_ms([(e[2], e[2] + e[3]) for e in events])
    by_name = {}
    for e in events:
        by_name[e[1]] = by_name.get(e[1], 0.0) + e[3] / 1e3
    k1 = sum(1 for e in events if "spmm_csr_kernel" in e[1])
    k1_fixups = sum(1 for e in events if "spmm_csr_fixup_kernel" in e[1])
    k1_ms = sum(v for k, v in by_name.items() if "spmm_csr" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(wall_ms=wall_ms, busy_ms=busy, idle_share=1.0 - busy / wall_ms, events=len(events),
                k1_launches=k1, k1_fixups=k1_fixups, k1_ms=k1_ms, top=top)


def nas_phase(dev) -> dict:
    """NAS through the user's entry points on the card (section 11 of the
    module docstring).  Returns K1's launches of the counted runs, each
    run's numbers and the checks' errors."""
    import importlib.util

    from sgl_tpu_torch.datasets import Ogbn
    from sgl_tpu_torch.datasets import utils as csv_utils
    from sgl_tpu_torch.datasets.utils import read_csv_numpy
    from sgl_tpu_torch.graph import native
    from sgl_tpu_torch.graph import symmetric_normalized_weights
    from sgl_tpu_torch.kernels import prepare_csr
    from sgl_tpu_torch.kernels.spmm_csr import _plan
    from sgl_tpu_torch.search import ConfigManager, run_nas, run_sha
    from sgl_tpu_torch.utils import TrainConfig

    nas_small_graph(dev)
    check(native.csv_native_available(), "[11] the native csv parser did not build")
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        raw = write_ogb_raw(tmp)
        write_s = time.perf_counter() - t
        sizes = {k: os.path.getsize(p) for k, p in raw["paths"].items()}
        parse = {}
        written = {"edge": raw["edges"], "node-label": raw["y"][:, None]}
        for stem, want_arr in written.items():
            t = time.perf_counter()
            got = native.load_csv_native(raw["paths"][stem], np.int64)
            native_s = time.perf_counter() - t
            t = time.perf_counter()
            want = read_csv_numpy(raw["paths"][stem], np.int64)
            numpy_s = time.perf_counter() - t
            check(got is not None and np.array_equal(got, want), f"[11] {stem}: native parse != numpy.loadtxt")
            check(np.array_equal(got, want_arr), f"[11] {stem}: parsed != written")
            parse[stem] = dict(native_s=native_s, numpy_s=numpy_s)
        del got, want
        # every file of the load through the native parser: the numpy
        # fallback is counted, and must not run
        fallbacks = []
        real_numpy = csv_utils.read_csv_numpy
        csv_utils.read_csv_numpy = lambda path, dtype=np.float32: fallbacks.append(path) or real_numpy(path, dtype)
        try:
            t = time.perf_counter()
            ds = Ogbn("arxiv", tmp)
            load_s = time.perf_counter() - t
        finally:
            csv_utils.read_csv_numpy = real_numpy
        check(not fallbacks, f"[11] Ogbn fell back to numpy.loadtxt for {fallbacks}")
        n, d, c = NAS_OGB["num_nodes"], NAS_OGB["feat_dim"], NAS_OGB["num_classes"]
        check((ds.num_node, ds.num_features, ds.num_classes) == (n, d, c), f"[11] Ogbn: {ds.num_node} nodes")
        check([len(ds.train_idx), len(ds.val_idx), len(ds.test_idx)] == list(NAS_OGB["split"]), "[11] Ogbn split")
        check(np.array_equal(ds.y, raw["y"]) and np.array_equal(ds.test_idx, raw["split"]["test"]),
              "[11] Ogbn labels or split differ from the files")
        feat_err = float(np.abs(ds.x - raw["x"]).max() / np.abs(raw["x"]).max())
        check(feat_err <= 1e-5, f"[11] Ogbn features vs the values written (6 digits): {feat_err:.3e}")
        log(f"[11] OGB raw files at ogbn-arxiv's shape written in {write_s:.2f} s (gzip level 1; "
            + ", ".join(f"{k} {v / 1e6:.2f} MB" for k, v in sizes.items())
            + f"); native csv parser built {'with' if native.csv_native_zlib() else 'without'} zlib "
            f"(every file of the load parsed natively); "
            + "; ".join(f"{k}.csv.gz native {v['native_s']:.4f} s vs numpy.loadtxt {v['numpy_s']:.4f} s, equal"
                        for k, v in parse.items())
            + f"; Ogbn('arxiv') {load_s:.2f} s: {ds.num_node} nodes, {ds.graph.num_edges} undirected edges, "
            f"{d} features ({feat_err:.2e} off the values written), {c} classes, split "
            f"{len(ds.train_idx)}/{len(ds.val_idx)}/{len(ds.test_idx)}")

        split_rows = bool(_plan(prepare_csr(symmetric_normalized_weights(ds.graph, device=dev))).num_long)
        log(f"[11] openbox importable: {importlib.util.find_spec('openbox') is not None} "
            f"(optimizer='auto' takes OpenBox when it is, else the evolutionary search); the graph's plan "
            f"{'has' if split_rows else 'has no'} split rows")
        runs = {}
        for name, drive in (
            ("run_nas", lambda cfgr: run_nas(cfgr, verbose=False, **NAS_RUN)),
            ("run_sha", lambda cfgr: run_sha(cfgr, verbose=False, **NAS_SHA)),
        ):
            configer = ConfigManager(list(NAS_ARCH))
            configer._setParameters(ds, restarts=NAS_RESTARTS, config=TrainConfig(**NAS_TRAIN))
            history, seconds, counts, fixups, peak = count_launches(lambda: drive(configer))
            cache = configer._prop_cache
            launches, fixup_want = expected_nas_launches(history, cache, split_rows)
            hold_launches(name, "11", counts, fixups, {"f32": launches}, {"f32": fixup_want})
            accs = [-float(tr.objs[0]) for tr in history.trials]
            check(all(0.0 <= a <= 1.0 for a in accs) and all(np.isfinite(tr.objs[1]) and tr.objs[1] > 0
                                                            for tr in history.trials),
                  f"[11] {name}: objectives {[tr.objs.tolist() for tr in history.trials]}")
            front = history.pareto_front()
            runs[name] = dict(trials=len(history.trials), launches=counts["f32"], fixup_launches=fixups["f32"],
                              seconds=seconds, trial_s=[tr.elapsed for tr in history.trials], peak_bytes=peak,
                              hits=cache.hits, misses=cache.misses, hops_computed=cache.hops_computed,
                              best_acc=max(accs), pareto=len(front))
            for i, tr in enumerate(history.trials):
                log(f"[11] {name} trial {i + 1}: {tuple(tr.config[k] for k in configer.ranges)} acc "
                    f"{-tr.objs[0]:.4f} objective time {tr.objs[1]:.4f} s, trial {tr.elapsed:.4f} s")
            log(f"[11] {name} ({NAS_RUN if name == 'run_nas' else NAS_SHA}, restarts {NAS_RESTARTS}, {NAS_TRAIN}): "
                f"{len(history.trials)} trials in {seconds:.2f} s (trial s median "
                f"{statistics.median(runs[name]['trial_s']):.4f}, max {max(runs[name]['trial_s']):.4f}); cache "
                f"{cache.hits} hits, {cache.misses} misses, {cache.hops_computed} hops computed; K1 launches "
                f"{counts} + fix-ups {fixups} (expected {launches} + {fixup_want}: hops computed + post steps); "
                f"Pareto front {[(tuple(tr.config.values()), round(-float(tr.objs[0]), 4), round(float(tr.objs[1]), 4)) for tr in front]}; "
                f"peak device memory {peak / 2**30:.3f} GiB")
            if name == "run_nas":
                best = history.best_accuracy_trial.config
                split = nas_trial_split(configer, best)
                post = best["post_steps"] if best["post_types"] and best["post_steps"] else 0
                check(split["k1_launches"] == post and split["k1_fixups"] == (post if split_rows else 0),
                      f"[11] traced trial: K1 {split['k1_launches']} + {split['k1_fixups']} in the trace, "
                      f"expected {post}")
                log(f"[11] one trial of {tuple(best.values())} on the warm cache: {split['wall_ms']:.2f} ms wall, "
                    f"the card busy {split['busy_ms']:.2f} ms (idle share {split['idle_share']:.4f}; "
                    f"{split['events']} device events, K1 {split['k1_launches']} + {split['k1_fixups']} fix-ups "
                    f"= {split['k1_ms']:.3f} ms); device ms by kernel: "
                    + "; ".join(f"{k[:60]} {v:.3f}" for k, v in split["top"]))
                runs[name]["trial_split"] = split
            del configer, history, cache
        cache_check = nas_cache_check(dev, ds)
        resume = nas_resume_check(dev, ds, tmp)
        del ds
    torch.cuda.empty_cache()
    return dict(launches=sum(r["launches"] for r in runs.values()),
                fixup_launches=sum(r["fixup_launches"] for r in runs.values()),
                runs=runs, parse=parse, write_s=write_s, load_s=load_s, cache=cache_check, resume=resume)


# -- phase 12: the distributed runtime ------------------------------------------------

DIST_SOURCE = "sgl_tpu_torch/parallel/spmm_dist.py"
# the two former K1 call sites of the ring: the per-bucket reduce and its timing
DIST_REPLACES = {"ring": "sgl_tpu/parallel/spmm_dist.py:777", "work": "sgl_tpu/parallel/spmm_dist.py:132"}
# ring_bucket_work_time on phase 5's products graph: P, and its timing protocol
DIST_WORK = dict(parts=4, rounds=3, iters=2)
# the main path's workload through NodeClassificationDist (phase 3's dataset,
# GAMLP's widths and training; SGC with the bf16 precompute)
DIST_DATASET = {"name": "SyntheticPowerLaw", "kwargs": ZOO_DATASET}
DIST_TRAIN = dict(lr=0.1, weight_decay=5e-5, epochs=5)
DIST_GAMLP = {"name": "GAMLP f32", "model": {"name": "GAMLP", "args": [3, 128, 64],
                                             "kwargs": dict(hidden_dim=512, num_layers=3)}, "train": DIST_TRAIN}
DIST_SGC = {"name": "SGC bf16", "model": {"name": "SGC", "args": [3, 128, 64]}, "train": DIST_TRAIN,
            "precompute_dtype": "bfloat16"}
DIST_HOPS4 = {"name": "hops (1, 4)", "hops_only": True, "mesh": [1, 4], "prop_steps": 3}
# (label, ranks, mesh, backend, workload runs): NCCL does not take two ranks
# on one card, so it runs alone; gloo ranks share cuda:0 and stage the ring's
# blocks through pinned host buffers
DIST_RUNS = (
    ("nccl (1, 1)", 1, (1, 1), "nccl", (DIST_GAMLP,)),
    ("gloo (1, 2)", 2, (1, 2), "gloo", (DIST_GAMLP, DIST_SGC)),
    ("gloo (2, 2)", 4, (2, 2), "gloo", (DIST_GAMLP, DIST_HOPS4)),
)
DIST_LIMIT_S = 300  # a launch's limit, after which every rank is killed


def bucket_bytes(part, d: int, elem: int) -> int:
    """Compulsory bytes of one bucket's accumulating launch (the streaming
    form of ``PERF.md`` §6 on one part): its row pointer, col and val, each
    source row that a nonzero reads, once, and each non-empty f32 row read
    and written once (the kernel skips an empty row; an unread source row
    is never touched)."""
    rows = int((part.rowptr[1:] > part.rowptr[:-1]).sum())
    sources = int(torch.unique(part.col).numel())
    return 4 * (part.num_rows + 1) + 8 * part.nnz + sources * d * elem + 2 * rows * d * 4


def ring_work_probe(dev, graph) -> dict:
    """``ring_bucket_work_time`` (``spmm_dist.py:132``'s port) on the products
    graph at P = 4, f32 and bf16, its launches counted and held; then each
    of the P² buckets' K3/K4 launch against its plain twin and timed alone,
    beside its bound, the twin and ``torch.sparse.mm`` on the bucket."""
    from sgl_tpu_torch.graph import symmetric_normalized_weights
    from sgl_tpu_torch.kernels import spmm_csr, spmm_csr_acc, spmm_csr_acc_reference
    from sgl_tpu_torch.parallel import partition_adj_chunked, ring_bucket_work_time, ring_padding_stats

    p = DIST_WORK["parts"]
    t = time.perf_counter()
    adj = symmetric_normalized_weights(graph, device=dev)
    torch.cuda.synchronize()
    normalize_s = time.perf_counter() - t
    t = time.perf_counter()
    dadj = partition_adj_chunked(adj, p)
    layout_s = time.perf_counter() - t
    del adj
    t = time.perf_counter()
    buckets = [(o, b, part) for o in range(p) for b, part in enumerate(dadj.local(o, dev).buckets)]
    torch.cuda.synchronize()
    to_card_s = time.perf_counter() - t
    n_long = sum(part.plan.num_long > 0 for *_, part in buckets)
    # the rows each bucket's row tasks walk, and the empty rows they drop
    listed = [part.plan.num_listed for *_, part in buckets]
    dropped = [int((torch.diff(part.rowptr) == 0).sum()) if part.plan.num_listed else 0 for *_, part in buckets]
    d = graph.num_features
    log(f"[12] products graph at P = {p}: block {dadj.block}, {dadj.nnz} bucket nonzeros (padding ratio "
        f"{ring_padding_stats(dadj)['ratio']:.1f}), diag {dadj.diag is not None}, out-hubs "
        f"{0 if dadj.hub_ids is None else dadj.hub_ids.numel()}, dst-hubs "
        f"{0 if dadj.hub_in_ids is None else dadj.hub_in_ids.numel()}; bucket nonzeros "
        f"{[part.nnz for *_, part in buckets]}, {n_long} with a long row; listed rows a bucket {listed}, empty rows "
        f"dropped before the launch {dropped} ({sum(dropped)} of {sum(part.num_rows for *_, part in buckets)}); "
        f"normalize {normalize_s:.2f} s, layout {layout_s:.2f} s, buckets to the card {to_card_s:.2f} s")
    hops = 1 + DIST_WORK["rounds"] * DIST_WORK["iters"]
    results = {}
    for key, dtype in DTYPES.items():
        started = time.perf_counter()
        reset_launches()
        hop_s = ring_bucket_work_time(dadj, d, dtype=dtype, rounds=DIST_WORK["rounds"],
                                      iters=DIST_WORK["iters"], device=dev)
        launches = spmm_csr.launches["acc_" + key]
        fixups = spmm_csr.fixup_launches["acc_" + key]
        check((launches, fixups) == (hops * p * p, hops * n_long),
              f"[12] ring_bucket_work_time {key}: launches {launches} + {fixups}, expected "
              f"{hops * p * p} + {hops * n_long}")
        x = torch.as_tensor(np.random.default_rng(1).standard_normal((p, dadj.block, d)), dtype=dtype).to(dev)
        errs, ms, plain, lib = [], [], [], []
        for o, b, part in buckets:
            got = spmm_csr_acc(part, x[b], torch.zeros((dadj.block, d), device=dev))
            want = spmm_csr_acc_reference(part, x[b], torch.zeros((dadj.block, d), device=dev))
            errs.append(rel_err(got, want))
            check(torch.isfinite(got).all().item() and errs[-1][1] <= TOL[key],
                  f"[12] bucket ({o}, {b}) {key} vs its twin: {errs[-1][1]:.3e}")
            acc = torch.zeros((dadj.block, d), device=dev)
            ms.append(time_ms(lambda: spmm_csr_acc(part, x[b], acc), warmup=2, iters=10))
            plain.append(time_ms(lambda: spmm_csr_acc_reference(part, x[b], acc), warmup=1, iters=2))
            lib.append(library_time(part, x[b], want.to(dtype), 1, 5)[0])
        nbytes = sum(bucket_bytes(part, d, x.element_size()) for *_, part in buckets)
        b = bound(nbytes, dadj.nnz, d)
        results[key] = dict(
            launches=launches, fixup_launches=fixups, hop_ms=hop_s * 1e3, ms=sum(ms),
            bucket_ms=ms, bucket_library_ms=lib, empty_rows_dropped=sum(dropped), plain_ms=sum(plain),
            library_ms=None if None in lib else sum(lib),
            max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs), **b,
        )
        log(f"[12] ring_bucket_work_time {key}: {hop_s * 1e3:.4f} ms a hop of {p * p} launches; "
            f"launches {launches} + {fixups} fix-ups (held: {hops} hops); each bucket alone "
            f"{[round(v, 4) for v in ms]} ms, sum {sum(ms):.4f} (torch.sparse.mm a bucket "
            f"{[None if v is None else round(v, 4) for v in lib]}); vs twin max abs err "
            f"{results[key]['max_abs_err']:.3e}, max rel err {results[key]['max_rel_err']:.3e} "
            f"(limit {TOL[key]:.0e}); plain twin {sum(plain):.4f} ms; bound {b['bound_ms']:.4f} ms "
            f"({nbytes / 1e9:.4f} GB at 3.35 TB/s); torch.sparse.mm on the buckets "
            f"{results[key]['library_ms']}; {time.perf_counter() - started:.2f} s")
        del x
    del dadj, buckets
    torch.cuda.empty_cache()
    return results


# Adam's eps (``adam_l2`` is ``torch.optim.Adam``'s defaults), and the margin
# over eps and the gradients' difference at which an element's first
# update no longer turns on rounding
ADAM_EPS = 1e-8
HELD_MARGIN = 1e3


def adam_first_update(g, p, lr: float, wd: float):
    """Adam's first step with the L2 term, in float64: ``(g', lr·g'/(|g'| +
    eps), slack)`` with ``g' = g + wd·p``; ``slack`` bounds how far the
    update moves when g' is off by the float32 rounding of ``g + wd·p``."""
    gp = g + wd * p
    rounding = 2.0 ** -22 * (np.abs(g) + wd * np.abs(p))

    def ratio(v):
        return v / (np.abs(v) + ADAM_EPS)

    update = lr * ratio(gp)
    slack = lr * np.maximum(np.abs(ratio(gp + rounding) - ratio(gp)), np.abs(ratio(gp - rounding) - ratio(gp)))
    return gp, update, slack


def first_step_check(base: dict, run: dict, lr: float, wd: float) -> dict:
    """One run's first data-parallel step against the base run's, each a
    dict ``{what: {name: array}}`` of ``params_before``, ``grads`` and
    ``params``.  Adam's first update is ``lr·g'/(|g'| + eps)`` with
    ``g' = g + wd·p``: about ±lr whatever |g'|, so where g' is within the
    gradients' rounding of 0, rounding alone moves a parameter by up to
    2·lr.  Returns ``start_err`` (starting parameters, max abs),
    ``grad_err`` (max rel, by tensor), ``replay_err`` (each run's
    parameters against Adam's update of its own gradients, every element,
    beyond the slack of ``adam_first_update``), ``held_err`` (the runs'
    parameters on the elements whose |g'| is at least ``HELD_MARGIN`` ×
    (eps + the tensor's largest gradient difference); ``held`` of ``total``
    elements) and ``worst``, the element where the parameters differ most,
    with its g, g' and updates.  Errors are relative to the tensor's
    largest parameter after the step."""
    out = dict(start_err=0.0, grad_err=0.0, replay_err=0.0, held_err=0.0, held=0, total=0, worst=None)
    for k in base["grads"]:
        p0b, p0r, gb, gr, p1b, p1r = (np.asarray(d[what][k], np.float64)
                                      for what in ("params_before", "grads", "params") for d in (base, run))
        scale = max(float(np.abs(p1b).max()), 1e-30)
        out["start_err"] = max(out["start_err"], float(np.abs(p0r - p0b).max()))
        delta = float(np.abs(gr - gb).max())
        out["grad_err"] = max(out["grad_err"], delta / max(float(np.abs(gb).max()), 1e-30))
        (gpb, ub, slack_b), (gpr, ur, slack_r) = adam_first_update(gb, p0b, lr, wd), adam_first_update(gr, p0r, lr, wd)
        for p0, p1, u, slack in ((p0b, p1b, ub, slack_b), (p0r, p1r, ur, slack_r)):
            out["replay_err"] = max(out["replay_err"], float((np.abs(p1 - (p0 - u)) - slack).max()) / scale)
        held = np.abs(gpb) >= HELD_MARGIN * (ADAM_EPS + delta)
        diff = np.abs(p1r - p1b)
        if held.any():
            out["held_err"] = max(out["held_err"], float(diff[held].max()) / scale)
        out["held"] += int(held.sum())
        out["total"] += held.size
        i = int(diff.argmax())
        if out["worst"] is None or diff.flat[i] / scale > out["worst"]["rel"]:
            out["worst"] = dict(param=k, rel=float(diff.flat[i]) / scale, g=(gb.flat[i], gr.flat[i]),
                                g_l2=(gpb.flat[i], gpr.flat[i]), p=p0b.flat[i], update=(ub.flat[i], ur.flat[i]))
    return out


def first_steps(ranks, name: str) -> list:
    """Each rank's first step of run ``name`` (``first_step_check``'s dicts)."""
    whats = ("params_before", "grads", "params")
    return [{what: {k[len(f"{name}.first_{what}."):]: v for k, v in r["arrays"].items()
                    if k.startswith(f"{name}.first_{what}.")} for what in whats} for r in ranks]


def dist_runs(tmp: str) -> dict:
    """``NodeClassificationDist`` through ``dev/dist_worker.py``, each run a
    launch of its own (``DIST_RUNS``; a world of one in this process, as
    ``dist_worker.run_here``), every check made here on what the ranks
    wrote."""
    from sgl_tpu_torch.dev import dist_worker

    out = {}
    for label, world, mesh, backend, runs in DIST_RUNS:
        spec = {"checks": ["workload"], "workload": {"dataset": DIST_DATASET, "runs": list(runs)}}
        where = os.path.join(tmp, label.replace(" ", "_"))
        t = time.perf_counter()
        if world == 1:
            ranks = dist_worker.run_here(mesh, spec, where, device="cuda", backend=backend)
        else:
            ranks = dist_worker.launch(world, mesh, spec, where, device="cuda", backend=backend,
                                       limit_s=DIST_LIMIT_S)
        out[label] = ranks
        log(f"[12] {label}: {world} rank(s){' in this process' if world == 1 else ''}, backend "
            f"{ranks[0]['backend']}, {time.perf_counter() - t:.2f} s; rank 0's seconds {ranks[0]['seconds']}, "
            f"dataset {ranks[0]['dataset_s']:.2f} s")
        for run in runs:
            name = run["name"]
            rows = [r[name] for r in ranks]
            key = "bf16" if run.get("precompute_dtype") == "bfloat16" else "f32"
            for r, row in zip(ranks, rows):
                where = f"[12] {label} {name} rank {r['rank']}"
                check(row["launches"] == row["want_launches"] and not row["other_launches"],
                      f"{where}: launches {row['launches']} (others {row['other_launches']}), "
                      f"expected {row['want_launches']}")
                check(row["err_vs_single"] <= TOL[key], f"{where}: hops vs single-device {row['err_vs_single']:.3e}")
                if key == "f32":
                    check(row["err_vs_f64"] <= F64_TOL, f"{where}: hops vs float64 {row['err_vs_f64']:.3e}")
            if "test_acc" in rows[0]:
                accs = {row["test_acc"] for row in rows}
                check(len(accs) == 1, f"[12] {label} {name}: test accuracy differs between ranks {accs}")
            row = rows[0]
            kernel = [round(v, 4) for v in row["kernel_ms"]]
            transfer = [round(v, 4) for v in row["transfer_ms"] or []]
            log(f"[12] {label} {name}: mesh {tuple(row['mesh'])}, launches a rank "
                f"{[r[name]['launches'] for r in ranks]} (held), route {row['route']}; hops vs single-device "
                f"{max(r[name]['err_vs_single'] for r in ranks):.3e}, vs float64 "
                f"{max(r[name]['err_vs_f64'] for r in ranks):.3e} (single-device vs float64 "
                f"{row['single_vs_f64']:.3e}); ring step kernel ms {kernel}, transfer ms {transfer}"
                + (f"; DP step ms median {statistics.median(row['step_ms']):.3f} over {len(row['step_ms'])} "
                   f"(the first {row['step_ms'][0]:.1f}); epoch s {[round(v, 3) for v in row['epoch_s']]}; "
                   f"preprocess {row['preprocess_s']:.4f} s; test acc "
                   f"{row['test_acc']:.4f} on every rank" if "step_ms" in row else "")
                + f"; wall {row['wall_s']:.2f} s, references {row['reference_s']:.2f} s")
    # the first data-parallel step of every run against the one-rank run's
    base_rank = out[DIST_RUNS[0][0]][0]
    name = DIST_GAMLP["name"]
    base = first_steps([base_rank], name)[0]
    lr, wd = DIST_GAMLP["train"]["lr"], DIST_GAMLP["train"]["weight_decay"]
    for label, *_ in DIST_RUNS[1:]:
        for r, first in zip(out[label], first_steps(out[label], name)):
            loss_err = abs(r[name]["first_loss"] - base_rank[name]["first_loss"]) / abs(base_rank[name]["first_loss"])
            c = first_step_check(base, first, lr, wd)
            check(c["start_err"] == 0 and loss_err <= 1e-5 and c["grad_err"] <= 1e-5 and c["replay_err"] <= 1e-5
                  and c["held_err"] <= 1e-5,
                  f"[12] {label} rank {r['rank']}: first step vs (1, 1): start {c['start_err']:.3e}, loss "
                  f"{loss_err:.3e}, gradients {c['grad_err']:.3e}, Adam replay {c['replay_err']:.3e}, "
                  f"parameters held {c['held_err']:.3e}")
            w = c["worst"]
            log(f"[12] {label} rank {r['rank']}: first DP step vs the (1, 1) run (limit 1e-5 each): start "
                f"{c['start_err']:.1e}, loss rel err {loss_err:.3e}, gradients max rel err {c['grad_err']:.3e}; "
                f"parameters vs Adam's update of their own gradients (beyond the float32 rounding of g + wd·p) "
                f"{c['replay_err']:.3e}; parameters vs "
                f"(1, 1) {c['held_err']:.3e} on the {c['held']} of {c['total']} elements with |g + wd·p| >= "
                f"{HELD_MARGIN:.0e} × (eps + the gradient difference); the worst element of all, in {w['param']}: "
                f"{w['rel']:.3e} with g {w['g'][0]:.4e} / {w['g'][1]:.4e}, g + wd·p {w['g_l2'][0]:.4e} / "
                f"{w['g_l2'][1]:.4e}, p {w['p']:.4e}, update {w['update'][0]:.4e} / {w['update'][1]:.4e}")
    return out


def dist_phase(dev, graph) -> dict:
    """The distributed runtime (section 12 of the module docstring)."""
    work = ring_work_probe(dev, graph)
    with tempfile.TemporaryDirectory() as tmp:
        runs = dist_runs(tmp)
    # each instantiation's ring launches a rank, by run
    ring = {"f32": {}, "bf16": {}}
    for label, *_rest, specs in DIST_RUNS:
        for run in specs:
            key = "bf16" if run.get("precompute_dtype") == "bfloat16" else "f32"
            ring[key][f"{label} {run['name']}"] = [
                [r[run["name"]]["launches"]["acc_" + key], r[run["name"]]["launches"]["fixup_acc_" + key]]
                for r in runs[label]]
    return {"work": work, "ring_launches": ring}


# -- phase 13: the dataset loaders and the examples -----------------------------------

# every loader at a small size: raw files from a seed, SGC(2) through the
# task on the card, the logits against the port's CPU path from the same
# weights
LOADER_SMALL = dict(num_nodes=400, num_features=32, num_classes=5, avg_degree=8)
LOADER_TRAIN = dict(lr=0.1, weight_decay=5e-5, epochs=3, seed=0)
# the published shapes of Reddit (DGL) and Flickr (GraphSAINT); Reddit's
# edges are the only thing a time budget may cut (``REDDIT_EDGE_SHARE``)
REDDIT_SHAPE = dict(raw_files.REDDIT)
REDDIT_EDGE_SHARE = 1.0
FLICKR_SHAPE = dict(raw_files.FLICKR)
# the SGC paper's setting for Reddit (two hops), and GAMLP at the main
# path's widths; 5 epochs each, Flickr's SGC too
REDDIT_MODELS = {"SGC": dict(prop_steps=2), "GAMLP": dict(prop_steps=3, hidden_dim=512, num_layers=3)}
SHAPE_TRAIN = dict(lr=0.1, weight_decay=5e-5, epochs=5, seed=0)
# Reddit's first hop against a float64 sum over these rows and the longest
# row; the plain version by blocks of rows (the whole graph's x[src] is
# 276 GB)
REDDIT_F64_ROWS = 1024
REDDIT_PLAIN_BLOCKS = 64
# the examples: short runs, sgc_pubmed on Planetoid files at pubmed's shape
# (``write_raw_files``' defaults), papers100M's --data on a small OGB fixture
EXAMPLE_EPOCHS = 5
EXAMPLE_PUBMED = {}
PAPERS_DATA = dict(NAS_OGB, num_nodes=20_000, num_edges=120_000, feat_dim=128, num_classes=32,
                   split=(10_000, 4_000, 6_000))
PAPERS_ARGS = ["--epochs", "2", "--batch", "5000", "--part-edges", str(1 << 16)]


# what the JSON line keeps of K1 at Reddit's and Flickr's shapes
SHAPE_KEYS = ("n", "nnz", "d", "launches", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err",
              "max_rel_err", "panel", "library_ratio")


def on_card(t, what: str, phase: str = "13") -> None:
    check(t.is_cuda, f"[{phase}] {what}: not on the card")


def offline_urlopen(asked: list):
    """A stand-in for ``urllib.request.urlopen`` that fails at once and
    notes the URL: a loader without its raw files falls back, and nothing
    reaches the network."""
    def urlopen(url, *a, **k):
        asked.append(url)
        raise OSError("no network in the smoke run")
    return urlopen


def same_weights_logits(model, host, n: int, dev, what: str) -> float:
    """The trained card model's logits for ``n`` nodes against ``host``'s
    (preprocessed on the CPU), ``host`` given the card model's weights."""
    host.init(torch.Generator().manual_seed(0))
    host.net.load_state_dict({k: v.cpu() for k, v in model.net.state_dict().items()})
    with torch.no_grad():
        got = model.apply(torch.arange(n, device=dev))
        want = host.apply(torch.arange(n))
    on_card(got, f"{what} logits")
    return rel_err(got.cpu(), want)[1]


def loader_runs(dev, root: str) -> dict:
    """Every loader of ``raw_files.LOADERS`` at ``LOADER_SMALL``: files
    written (Reddit's zip and NELL's tarball as the download brings them,
    unpacked by the loader), the dataset loaded, SGC(2) on the card through
    its task, K1's launches counted, the logits against the CPU path."""
    from sgl_tpu_torch import datasets
    from sgl_tpu_torch.models import SGC, Fast_NARS_SGC_WithLearnableWeights
    from sgl_tpu_torch.tasks import HeteroNodeClassification, NodeClassification

    out = {}
    for name in raw_files.LOADERS:
        sub = os.path.join(root, name)
        kw = raw_files.write_loader_files(name, sub + "/", seed=0, downloaded=name in ("Reddit", "Nell"),
                                          **LOADER_SMALL)
        ds = getattr(datasets, name)(root=sub + "/", **kw)
        if name == "Custom_Hetero":
            d = np.shape(ds.data["paper"].x)[1]
            make = lambda: Fast_NARS_SGC_WithLearnableWeights(2, d, ds.num_classes, 16, 2, 1)  # noqa: E731
            sub_kw = dict(random_subgraph_num=1, subgraph_edge_type_num=2)
            model = make()
            task, seconds, counts, fixups, _ = count_launches(lambda: HeteroNodeClassification(
                ds, "paper", model, device=dev, verbose=False, **sub_kw, **LOADER_TRAIN))
            host = make()
            host.preprocess(ds, "paper", device="cpu", **sub_kw)
            check(host.subgraph_keys == model.subgraph_keys, f"[13] {name}: subsets differ")
        else:
            model = SGC(2, ds.num_features, ds.num_classes)
            task, seconds, counts, fixups, _ = count_launches(lambda: NodeClassification(
                ds, model, device=dev, verbose=False, **LOADER_TRAIN))
            host = SGC(2, ds.num_features, ds.num_classes)
            host.preprocess(ds.graph, ds.x, device="cpu")
        n = ds.data.num_node["paper"] if name == "Custom_Hetero" else ds.num_node
        on_card(model.processed_feature, f"{name} features")
        err = same_weights_logits(model, host, n, dev, name)
        check(err <= TOL["f32"], f"[13] {name}: logits card vs CPU {err:.3e}")
        check(counts["f32"] >= 2, f"[13] {name}: K1 launches {counts}, expected >= 2 (two hops)")
        check(0.0 <= task.test_acc <= 1.0, f"[13] {name}: test accuracy {task.test_acc}")
        out[name] = dict(nodes=n, launches=counts["f32"], fixups=fixups["f32"], err=err, seconds=seconds,
                         acc=task.test_acc)
        what = "Fast NARS(2), one subset of both relations," if name == "Custom_Hetero" else "SGC(2)"
        log(f"[13] {name}({', '.join(f'{k}={v!r}' for k, v in kw.items())}): {n} nodes; {what} on the card "
            f"{seconds:.3f} s, K1 launches {counts['f32']} + fix-ups {fixups['f32']}, logits vs the CPU path "
            f"{err:.3e} (limit {TOL['f32']:.0e}), test acc {task.test_acc:.4f}")
    return out


def blocked_plain(adj, blocks: int):
    """The plain version of ``spmm_csr(adj, ·)`` one block of rows at a
    time (each block's rows with their own split plan, as the whole
    graph's plan cuts them): returns ``fn(x) -> y``."""
    from sgl_tpu_torch.kernels.spmm_csr import _make_plan, _split_sum_f32

    n = adj.num_nodes
    cuts = np.linspace(0, n, blocks + 1).astype(np.int64)
    parts = []
    for r0, r1 in zip(cuts[:-1], cuts[1:]):
        e0, e1 = int(adj.rowptr[r0]), int(adj.rowptr[r1])
        rowptr = (adj.rowptr[r0:r1 + 1] - e0).contiguous()
        parts.append((int(r0), int(r1), rowptr, adj.col[e0:e1], adj.val[e0:e1], _make_plan(rowptr)))

    def fn(x):
        y = torch.empty_like(x)
        for r0, r1, rowptr, col, val, plan in parts:
            y[r0:r1] = _split_sum_f32(rowptr, col, val, r1 - r0, plan, x).to(x.dtype)
        return y
    return fn


def f64_rows(adj, x, rows) -> torch.Tensor:
    """Rows ``rows`` of ``adj @ x`` summed in float64."""
    r = torch.as_tensor(rows, device=x.device)
    beg, end = adj.rowptr.long()[r], adj.rowptr.long()[r + 1]
    counts = end - beg
    owner = torch.repeat_interleave(torch.arange(r.shape[0], device=x.device), counts)
    edge = beg[owner] + torch.arange(owner.shape[0], device=x.device) - (counts.cumsum(0) - counts)[owner]
    y = torch.zeros((r.shape[0], x.shape[1]), dtype=torch.float64, device=x.device)
    return y.index_add_(0, owner, x.index_select(0, adj.col.long()[edge]).double() * adj.val.double()[edge, None])


def k1_at_shape(adj, x, where: str, plain) -> dict:
    """K1 on ``adj`` and ``x``: against the plain version (all rows), timed
    (CUDA events, 20 calls back to back) beside the plain version, its
    bound and ``torch.sparse.mm``."""
    from sgl_tpu_torch.kernels import spmm_csr

    y = spmm_csr(adj, x)
    panel = spmm_csr.panels["f32"]  # the column panel width the launch took
    want = plain(x)
    on_card(y, f"K1 at {where}")
    abs_err, rel = rel_err(y, want)
    check(rel <= TOL["f32"], f"[13] K1 at {where} vs the plain version {rel:.3e}")
    del want
    n, d = x.shape
    ms = time_ms(lambda: spmm_csr(adj, x))
    plain_ms = time_ms(lambda: plain(x), warmup=1, iters=3)
    library_ms, note = library_time(adj, x, y)
    b = csr_bound(n, adj.nnz, d, 4)
    ratio = None if library_ms is None else ms / library_ms
    log(f"[13] K1 at {where} (N {n}, nnz {adj.nnz} with self-loops, D {d}, {describe_plan(adj.plan, d)}): "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.sparse.mm {note}; kernel / torch.sparse.mm "
        f"{'not measured' if ratio is None else f'{ratio:.4f}'}; bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}, {b['nbytes'] / 1e9:.4f} GB), {b['bound_ms'] / ms:.4f} of it; vs the plain version "
        f"max abs {abs_err:.3e}, rel {rel:.3e}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                nbytes=b["nbytes"], max_abs_err=abs_err, max_rel_err=rel, nnz=adj.nnz, n=n, d=d, panel=panel,
                library_ratio=ratio)


def flickr_run(dev, root: str) -> dict:
    """Flickr's files at its published shape through ``Flickr(root)``:
    SGC(2) on the card, its hops against the CPU path at full size, K1
    timed at D = 500."""
    from sgl_tpu_torch.datasets import Flickr
    from sgl_tpu_torch.kernels import spmm_csr_reference
    from sgl_tpu_torch.models import SGC
    from sgl_tpu_torch.tasks import NodeClassification

    s = FLICKR_SHAPE
    t = time.perf_counter()
    written = raw_files.write_graphsaint(os.path.join(root, "flickr", "flickr", "raw"), **s, device=dev)
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    ds = Flickr(root + "/")
    load_s = time.perf_counter() - t
    check((ds.num_node, ds.num_features, ds.num_classes, ds.graph.num_edges) ==
          (s["num_nodes"], s["num_features"], s["num_classes"], s["nnz"]), f"[13] Flickr shape {ds.num_node}")
    check([len(ds.train_idx), len(ds.val_idx), len(ds.test_idx)] == list(s["split"]), "[13] Flickr role.json")
    model = SGC(2, ds.num_features, ds.num_classes)
    task, seconds, counts, fixups, peak = count_launches(lambda: NodeClassification(
        ds, model, device=dev, verbose=False, **SHAPE_TRAIN))
    host = SGC(2, ds.num_features, ds.num_classes)
    host.preprocess(ds.graph, ds.x, device="cpu")
    on_card(model.processed_feature, "Flickr hops")
    err = rel_err(model.processed_feature.cpu(), host.processed_feature)[1]
    check(err <= TOL["f32"], f"[13] Flickr hops card vs CPU {err:.3e}")
    check(counts["f32"] == 2, f"[13] Flickr: K1 launches {counts}, expected 2")
    check(0.0 <= task.test_acc <= 1.0, f"[13] Flickr test accuracy {task.test_acc}")
    log(f"[13] Flickr at its published shape ({written['nnz']} stored nonzeros written in {write_s:.2f} s, "
        f"Flickr(root) {load_s:.2f} s): {ds.num_node} nodes, {ds.graph.num_edges} edges, {ds.num_features} "
        f"features, {ds.num_classes} classes, split {len(ds.train_idx)}/{len(ds.val_idx)}/{len(ds.test_idx)}; "
        f"SGC(2) on the card: K1 launches {counts['f32']} + fix-ups {fixups['f32']}, preprocess "
        f"{task.preprocess_seconds:.4f} s, median epoch ms {statistics.median(task.epoch_seconds) * 1e3:.3f}, "
        f"test acc {task.test_acc:.4f}, peak device memory {peak / 2**30:.3f} GiB; hops vs the CPU path at "
        f"full size {err:.3e} (limit {TOL['f32']:.0e})")
    adj = model.pre_graph_op._adj_cache[2]
    x = torch.as_tensor(np.asarray(ds.x), device=dev)
    times = k1_at_shape(adj, x, "Flickr (D = 500)", lambda v: spmm_csr_reference(adj, v))
    return dict(times, launches=counts["f32"], fixups=fixups["f32"], write_s=write_s, load_s=load_s,
                hop_err=err, graph=ds.graph, x=x)


def reddit_run(dev, root: str) -> dict:
    """Reddit's files at its published shape through ``Reddit(root)``:
    write, parse, SGC(2) and GAMLP on the card, K1 at D = 602."""
    from sgl_tpu_torch import models
    from sgl_tpu_torch.datasets import Reddit
    from sgl_tpu_torch.graph import Graph
    from sgl_tpu_torch.kernels import spmm_csr
    from sgl_tpu_torch.tasks import NodeClassification

    s = REDDIT_SHAPE
    nnz = int(s["nnz"] * REDDIT_EDGE_SHARE) // 2 * 2
    if nnz != s["nnz"]:
        log(f"[13] Reddit's edges cut to {nnz} of {s['nnz']} (REDDIT_EDGE_SHARE {REDDIT_EDGE_SHARE})")
    t = time.perf_counter()
    written = raw_files.write_reddit(os.path.join(root, "reddit", "reddit", "raw"), **dict(s, nnz=nnz), device=dev)
    write_s = time.perf_counter() - t
    parse = {}
    real = Graph.from_coo

    def timed(*a, **k):
        t = time.perf_counter()
        g = real(*a, **k)
        parse["from_coo_s"] = time.perf_counter() - t
        return g

    Graph.from_coo = staticmethod(timed)
    try:
        t = time.perf_counter()
        ds = Reddit(root + "/")
        load_s = time.perf_counter() - t
    finally:
        Graph.from_coo = staticmethod(real)
    check((ds.num_node, ds.num_features, ds.num_classes) == (s["num_nodes"], s["num_features"], s["num_classes"]),
          f"[13] Reddit shape {ds.num_node}, {ds.num_features}, {ds.num_classes}")
    check(ds.graph.num_edges == written["nnz"] == nnz, f"[13] Reddit stored {ds.graph.num_edges} of {nnz}")
    check([len(ds.train_idx), len(ds.val_idx), len(ds.test_idx)] == list(s["split"]), "[13] Reddit node_types")
    log(f"[13] Reddit at its published shape: {ds.num_node} nodes, {ds.num_features} features, {ds.num_classes} "
        f"classes, stored nonzeros {ds.graph.num_edges} (published {s['nnz']}), split {len(ds.train_idx)}/"
        f"{len(ds.val_idx)}/{len(ds.test_idx)}; files written in {write_s:.2f} s, Reddit(root) {load_s:.2f} s "
        f"(Graph.from_coo {parse['from_coo_s']:.2f} s; the rest reading the npz files and writing the "
        f"processed cache)")
    runs = {}
    for name, kw in REDDIT_MODELS.items():
        model = getattr(models, name)(feat_dim=ds.num_features, output_dim=ds.num_classes, **kw)
        task, seconds, counts, fixups, peak = count_launches(lambda: NodeClassification(
            ds, model, device=dev, verbose=False, **SHAPE_TRAIN))
        hops = model.pre_graph_op.prop_steps
        on_card(model.processed_feature, f"Reddit {name} features")
        check(torch.isfinite(model.processed_feature).all().item(), f"[13] Reddit {name}: non-finite features")
        check(counts["f32"] == hops, f"[13] Reddit {name}: K1 launches {counts}, expected {hops}")
        check(0.0 <= task.test_acc <= 1.0, f"[13] Reddit {name}: test accuracy {task.test_acc}")
        epoch_ms = statistics.median(task.epoch_seconds) * 1e3
        runs[name] = dict(launches=counts["f32"], fixups=fixups["f32"], preprocess_s=task.preprocess_seconds,
                          epoch_ms=epoch_ms, peak_bytes=peak, test_acc=task.test_acc, seconds=seconds)
        log(f"[13] Reddit {name} ({SHAPE_TRAIN}) on the card: {seconds:.2f} s, K1 launches {counts['f32']} + "
            f"fix-ups {fixups['f32']}, preprocess {task.preprocess_seconds:.4f} s, median epoch ms {epoch_ms:.3f}, "
            f"test acc {task.test_acc:.4f}, peak device memory {peak / 2**30:.3f} GiB")
        adj = model.pre_graph_op._adj_cache[2]
        del task, model
        torch.cuda.empty_cache()
    x = torch.as_tensor(np.asarray(ds.x), device=dev)
    y = spmm_csr(adj, x)
    lengths = torch.diff(adj.rowptr.long())
    rng = np.random.default_rng(0)
    rows = np.unique(np.append(rng.choice(ds.num_node, REDDIT_F64_ROWS, replace=False), int(lengths.argmax())))
    f64_err = rel_err(y[torch.as_tensor(rows, device=dev)], f64_rows(adj, x, rows))[1]
    check(f64_err <= F64_TOL, f"[13] Reddit first hop vs float64 on {rows.size} rows {f64_err:.3e}")
    log(f"[13] Reddit first hop on {rows.size} rows (the longest, {int(lengths.max())} nonzeros, among them) "
        f"against a float64 sum: max rel err {f64_err:.3e} (limit {F64_TOL:.0e})")
    del y
    times = k1_at_shape(adj, x, "Reddit (D = 602)", blocked_plain(adj, REDDIT_PLAIN_BLOCKS))
    return dict(times, runs=runs, launches=sum(r["launches"] for r in runs.values()), write_s=write_s,
                load_s=load_s, from_coo_s=parse["from_coo_s"], stored_nnz=ds.graph.num_edges, f64_err=f64_err)


def backend_check(dev, graph, x) -> dict:
    """``set_default_backend`` on the card: one hop of ``graph`` under each
    backend, K1's launches counted; ``"segment"`` launches nothing and
    gives the same hop.  The default is restored."""
    from sgl_tpu_torch.kernels import get_default_backend, set_default_backend
    from sgl_tpu_torch.ops import LaplacianGraphOp

    before = get_default_backend()
    hops, out = {}, {}
    try:
        for name in ("auto", "segment", "pallas"):
            set_default_backend(name)
            op = LaplacianGraphOp(1)
            try:
                hop, _, counts, _, _ = count_launches(lambda: op.propagate(graph, x, device=dev)[1])
            except ValueError as exc:  # "pallas" needs a CUDA tensor
                check(False, f"[13] backend {name}: not on the card ({exc})")
                continue
            on_card(hop, f"backend {name} hop")
            hops[name], out[name] = hop, counts["f32"]
    finally:
        set_default_backend(before)
    check(out.get("segment") == 0, f"[13] backend 'segment': K1 launches {out.get('segment')}, expected 0")
    check(out.get("auto") == 1 and out.get("pallas", 1) == 1, f"[13] backends auto/pallas: K1 launches {out}")
    errs = {k: rel_err(hops[k], hops["auto"])[1] for k in hops}
    check(max(errs.values()) <= TOL["f32"], f"[13] backends disagree with 'auto': {errs}")
    check(get_default_backend() == before, "[13] the default backend was not restored")
    log(f"[13] set_default_backend on Flickr's hop: K1 launches {out}; max rel err against 'auto' {errs} "
        f"(limit {TOL['f32']:.0e}); the default ({before!r}) restored")
    return dict(launches=out, errs=errs)


def example_runs(dev, root: str) -> dict:
    """The six examples' ``main`` on the card with short runs (sgc_pubmed on
    Planetoid files at pubmed's shape, the rest on their fallbacks, the
    network stubbed out), and the papers100M pipeline's ``--data`` on OGB
    files; each one's device, metric and launches."""
    import urllib.request

    from sgl_tpu_torch.datasets.planetoid import write_raw_files
    from sgl_tpu_torch.examples import (
        gamlp_products,
        graph_classification,
        hetero_nars,
        nafs_link_predict,
        nafs_node_cluster,
        papers100m_pipeline,
        sgc_pubmed,
    )

    write_raw_files(os.path.join(root, "Planetoid", "pubmed", "raw"), "pubmed", seed=0, **EXAMPLE_PUBMED)
    write_ogb_raw(os.path.join(root, "papers"), PAPERS_DATA, name="papers100M")
    empty = os.path.join(root, "empty")
    epochs = ["--epochs", str(EXAMPLE_EPOCHS)]
    runs = (
        ("sgc_pubmed", lambda: sgc_pubmed.main(["--root", root, *epochs]), "test_acc"),
        ("gamlp_products", lambda: gamlp_products.main(["--root", empty, *epochs]), "test_acc"),
        ("hetero_nars", lambda: hetero_nars.main(["--root", empty, *epochs]), "test_acc"),
        ("graph_classification", lambda: graph_classification.main(epochs), "test_acc"),
        ("nafs_link_predict", lambda: nafs_link_predict.main(["--root", empty]), "test_roc_auc"),
        ("nafs_node_cluster", lambda: nafs_node_cluster.main(["--root", empty]), "acc"),
        ("papers100m_pipeline --data", lambda: papers100m_pipeline.main(
            ["--data", os.path.join(root, "papers"), "--store", os.path.join(root, "store"), *PAPERS_ARGS]),
         "test_acc"),
    )
    asked = []
    real = urllib.request.urlopen
    urllib.request.urlopen = offline_urlopen(asked)
    out = {}
    try:
        for name, run, metric in runs:
            res, seconds, counts, fixups, peak = count_launches(run)
            key = "acc_f32" if name.startswith("papers") else "f32"
            device = res["task"]._device  # where the task ran
            check(device.type == "cuda", f"[13] {name}: ran on {device}, not on the card")
            value = float(res[metric])
            check(np.isfinite(value) and 0.0 <= value <= 1.0, f"[13] {name}: {metric} {value}")
            check(counts[key] >= 1, f"[13] {name}: launches {counts}")
            out[name] = dict(metric=metric, value=value, launches=counts[key], fixups=fixups[key], seconds=seconds,
                             kernel=key)
            log(f"[13] example {name} on {device}: {metric} {value:.4f}, {seconds:.2f} s, launches of "
                f"{'K3' if key == 'acc_f32' else 'K1'} {counts[key]} + fix-ups {fixups[key]}")
            del res
            torch.cuda.empty_cache()
    finally:
        urllib.request.urlopen = real
    log(f"[13] the examples' fallbacks asked for {len(set(asked))} URLs, each refused by the stub: "
        f"{sorted(set(asked))[:4]}")
    return out


def loaders_phase(dev) -> dict:
    """The loaders and the examples on the card (section 13 of the module
    docstring); returns each part's numbers."""
    with tempfile.TemporaryDirectory() as root:
        small = loader_runs(dev, os.path.join(root, "small"))
        flickr = flickr_run(dev, os.path.join(root, "flickr"))
        backend = backend_check(dev, flickr.pop("graph"), flickr.pop("x"))
        torch.cuda.empty_cache()
        examples = example_runs(dev, os.path.join(root, "examples"))
        reddit = reddit_run(dev, os.path.join(root, "reddit"))
    torch.cuda.empty_cache()
    launches = sum(r["launches"] for r in small.values()) + flickr["launches"] + reddit["launches"] + sum(
        r["launches"] for r in examples.values() if r["kernel"] == "f32")
    return dict(small=small, flickr=flickr, reddit=reddit, backend=backend, examples=examples, launches=launches)


# -- phase 14: the clustering plots ----------------------------------------------------

# Planetoid files at pubmed's shape (``write_raw_files``' defaults: 19,717
# nodes, 500 features, 3 classes, 44,324 undirected edges), NAFS's "simple"
# smoothing at a few hops, then ``plotClusters`` on the card
PLOT_PUBMED = {}
PLOT_HOPS = 3
# rows held against float64 on the CPU, and the trustworthiness sample (k = 10)
PLOT_CHECK_ROWS = 1024
PLOT_TRUST_ROWS = 2000
PLOT_TRUST_K = 10
# the conditional P (absolute) and the gradient (relative: see plot_phase)
# against float64
PLOT_P_TOL = 1e-6
PLOT_GRAD_TOL = 1e-4
PLOT_BUDGET_S = 60.0
PAIR_OPERATIONS = 13


def conditional_p_rows_f64(x: np.ndarray, rows: np.ndarray, k: int, perplexity: float):
    """The plain version of the kNN and the binary search for ``rows``:
    float64 distances to every point in numpy (``|x|² + |y|² - 2 x·y``),
    the k nearest other points,
    cast to float32 as scikit-learn does, then ``_binary_search_perplexity``
    one row at a time.  Returns ``(neighbour ids, P)``, each row by id."""
    x64 = x.astype(np.float64)
    sq = (x64 * x64).sum(1)
    every = np.maximum(sq[rows, None] + sq[None, :] - 2.0 * (x64[rows] @ x64.T), 0.0)
    desired = np.log(np.float64(np.float32(perplexity)))
    tol, tiny = np.float64(np.float32(1e-5)), np.float64(np.float32(1e-8))
    ids_out, p_out = [], []
    for i, d in zip(rows, every):
        d[i] = np.inf
        ids = np.argsort(d, kind="stable")[:k]
        dist = d[ids].astype(np.float32).astype(np.float64)
        beta, lo, hi = 1.0, -np.inf, np.inf
        for _ in range(100):
            p = np.exp(-dist * beta)
            total = p.sum() or tiny
            p /= total
            diff = np.log(total) + beta * (dist * p).sum() - desired
            if abs(diff) <= tol:
                break
            if diff > 0:
                lo, beta = beta, beta * 2.0 if hi == np.inf else (beta + hi) / 2.0
            else:
                hi, beta = beta, beta / 2.0 if lo == -np.inf else (beta + lo) / 2.0
        order = np.argsort(ids)
        ids_out.append(ids[order])
        p_out.append(p[order])
    return np.stack(ids_out), np.stack(p_out)


def kl_grad_rows_f64(y: torch.Tensor, P, rows: np.ndarray, block: int = 2048) -> tuple:
    """The plain version of the t-SNE gradient (one degree of freedom) at
    ``rows``, on the CPU in float64: ``4 (Σ_j p_ij w_ij (y_i - y_j) - Σ_j
    w_ij² (y_i - y_j) / Z)``, ``w = 1 / (1 + d²)``, Z summed over all pairs.
    Returns the gradient and the largest of its two terms' entries."""
    y = y.detach().double().cpu()
    n = y.shape[0]
    z = torch.zeros((), dtype=torch.float64)
    for a in range(0, n, block):
        w = 1.0 / (1.0 + torch.cdist(y[a:a + block], y, compute_mode="donot_use_mm_for_euclid_dist") ** 2)
        w[torch.arange(w.shape[0]), torch.arange(a, a + w.shape[0])] = 0.0
        z += w.sum()
    rowptr, col, val = P.rowptr.cpu(), P.col.cpu(), P.val.cpu()
    attract = torch.empty((len(rows), 2), dtype=torch.float64)
    repel = torch.empty_like(attract)
    for r, i in enumerate(rows):
        js, p = col[rowptr[i]:rowptr[i + 1]], val[rowptr[i]:rowptr[i + 1]]
        near = y[i] - y[js]
        attract[r] = 4.0 * ((p / (1.0 + (near ** 2).sum(1)))[:, None] * near).sum(0)
        every = y[i] - y
        w = 1.0 / (1.0 + (every ** 2).sum(1))
        w[i] = 0.0
        repel[r] = 4.0 * ((w * w)[:, None] * every).sum(0) / z
    return attract - repel, max(attract.abs().max().item(), repel.abs().max().item())


def inked_colours(picture: np.ndarray, colours) -> dict:
    """Pixels of each colour (exactly its RGB) in an RGBA picture."""
    from sgl_tpu_torch.utils.figure import to_rgba

    rgb = picture[..., :3]
    return {c: int((rgb == np.rint(np.asarray(to_rgba(c)[:3]) * 255).astype(np.uint8)).all(-1).sum())
            for c in colours}


def plot_phase(dev) -> dict:
    """The clustering plots on the card (section 14 of the module
    docstring); returns the phase's numbers."""
    from sgl_tpu_torch.datasets import Planetoid
    from sgl_tpu_torch.datasets.planetoid import write_raw_files
    from sgl_tpu_torch.tasks import nafs_smooth_sweep
    from sgl_tpu_torch.tasks import tsne as T
    from sgl_tpu_torch.tasks.clustering_metrics import PLOT_COLORS, clustering_metrics
    from sgl_tpu_torch.utils.figure import read_png

    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        t = time.perf_counter()
        write_raw_files(os.path.join(root, "Planetoid", "pubmed", "raw"), "pubmed", seed=0, **PLOT_PUBMED)
        ds = Planetoid("pubmed", root + "/", "official")
        load_s = time.perf_counter() - t
        feats, nafs_s, counts, fixups, _ = count_launches(lambda: [h for _, h in nafs_smooth_sweep(
            ds.graph, ds.x, [PLOT_HOPS], [0.5], "simple", device=dev)][-1])
        on_card(feats, "NAFS features", "14")
        check(counts["f32"] == PLOT_HOPS and sum(counts.values()) == PLOT_HOPS,
              f"[14] NAFS simple: K1 launches {counts}, expected {PLOT_HOPS} of f32")
        labels = np.asarray(ds.y)
        metrics = clustering_metrics(labels, labels)
        path = os.path.join(root, "plot.png")
        out, plot_s, plot_counts, _, peak = count_launches(
            lambda: metrics.plotClusters(feats, labels, path=path, device=dev))
        check(out == path and sum(plot_counts.values()) == 0, f"[14] plotClusters: {out}, K1 launches {plot_counts}")
        picture = read_png(path)
    tsne = metrics.tsne_
    n = feats.shape[0]
    y = tsne.embedding_
    on_card(y, "the t-SNE embedding", "14")
    check(tuple(y.shape) == (n, 2) and torch.isfinite(y).all().item(), f"[14] embedding {tuple(y.shape)}")
    check(picture.shape == (576, 768, 4), f"[14] the PNG is {picture.shape}, expected (576, 768, 4)")
    classes = int(labels.max()) + 1
    inked = inked_colours(picture, PLOT_COLORS[:classes])
    check(all(v > 0 for v in inked.values()), f"[14] the PNG's class colours {inked}")
    check(tsne.kl_divergence_ < tsne.kl_after_exploration_,
          f"[14] final KL {tsne.kl_divergence_} not below the KL after exploration {tsne.kl_after_exploration_}")

    # the parts on the card against float64 on the CPU, at sampled rows
    rng = np.random.default_rng(0)
    rows = np.sort(rng.choice(n, min(PLOT_CHECK_ROWS, n), replace=False))
    x = feats.float()
    k = min(n - 1, int(3.0 * tsne.perplexity + 1))
    dist, idx = T.knn_sq_distances(x, k)
    cond = T.conditional_p(dist, tsne.perplexity)
    P = T.joint_p(cond, idx)
    want_ids, want_p = conditional_p_rows_f64(x.cpu().numpy(), rows, k, tsne.perplexity)
    got_ids, got_p = idx[rows].cpu().numpy(), cond[rows].cpu().numpy()
    order = np.argsort(got_ids, axis=1)
    got_ids, got_p = np.take_along_axis(got_ids, order, 1), np.take_along_axis(got_p, order, 1)
    same = (got_ids == want_ids).all(1)
    check(same.mean() >= 0.99, f"[14] kNN: {int((~same).sum())} of {rows.size} rows have other neighbours")
    p_err = float(np.abs(got_p[same] - want_p[same]).max())
    check(p_err <= PLOT_P_TOL, f"[14] conditional P vs float64 on the CPU {p_err:.3e}")
    # the error over the gradient's largest entry at the init; at the final y,
    # where the attraction and the repulsion nearly cancel (the net gradient
    # is many times smaller than either), over the terms' largest entry:
    # float32 resolves each term, not their small difference
    grad_errs = {}
    for name, at in (("init", T.pca_init(x)), ("final", y)):
        got = T.kl_grad(at, P)[1][torch.as_tensor(rows, device=dev)].cpu()
        want, terms = kl_grad_rows_f64(at, P, rows)
        abs_err, net_err = rel_err(got, want)
        grad_errs[name] = dict(net=net_err, terms=abs_err / terms, net_over_terms=want.abs().max().item() / terms)
        held = grad_errs[name]["net" if name == "init" else "terms"]
        check(held <= PLOT_GRAD_TOL, f"[14] gradient at the {name} y vs float64: {grad_errs[name]}")
    # one gradient at the final y alone, beside the least time of its exact
    # repulsion: N² pairs of 13 f32 operations (two differences, the squared
    # distance 3, 1 / (1 + d²) 2, Z 1, w² 1, the two force terms 4)
    kl_ms = time_ms(lambda: T.kl_grad(y, P, compute_error=False), device=dev)
    kl_bound_ms = n * n * PAIR_OPERATIONS / F32_FLOPS * 1e3
    rows_t = torch.as_tensor(rng.choice(n, min(PLOT_TRUST_ROWS, n), replace=False), device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    trust = T.trustworthiness(x, y, PLOT_TRUST_K, rows=rows_t)
    trust_s = time.perf_counter() - t
    check(0.0 <= trust <= 1.0, f"[14] trustworthiness {trust}")
    iterations = tsne.n_iter_ + 1
    timings = dict(tsne.timings_)
    tsne_s = sum(timings.values())
    phase_s = time.perf_counter() - start
    log(f"[14] pubmed-shaped Planetoid ({n} nodes, {ds.graph.num_edges} stored edges, {ds.num_features} features, "
        f"{classes} classes) written and parsed in {load_s:.2f} s; NAFS simple at {PLOT_HOPS} hops on the card "
        f"{nafs_s:.4f} s, K1 launches {counts['f32']} + fix-ups {fixups['f32']}")
    log(f"[14] plotClusters on the card: {plot_s:.2f} s in all (t-SNE {tsne_s:.2f} s: kNN (k = {k}) "
        f"{timings['knn']:.4f} s, P {timings['p']:.4f} s ({P.val.numel()} nonzeros), PCA {timings['pca']:.4f} s, "
        f"descent {timings['descent']:.3f} s for {iterations} iterations, {timings['descent'] / iterations * 1e3:.3f} "
        f"ms an iteration); peak device memory {peak / 2**30:.3f} GiB; KL after exploration "
        f"{tsne.kl_after_exploration_:.4f}, final {tsne.kl_divergence_:.4f}; the PNG 768 x 576, class colours' "
        f"pixels {inked}; one gradient at the final y {kl_ms:.3f} ms (CUDA events), the exact repulsion's bound "
        f"{kl_bound_ms:.4f} ms ({n}² pairs x {PAIR_OPERATIONS} f32 operations at {F32_FLOPS / 1e12:.0f} TFLOP/s)")
    log(f"[14] on {rows.size} rows against float64 on the CPU: conditional P max abs err {p_err:.3e} (limit "
        f"{PLOT_P_TOL:.0e}, {int(same.sum())} rows with the same neighbours); gradient max abs err over its max "
        f"entry at the PCA init {grad_errs['init']['net']:.3e} (limit {PLOT_GRAD_TOL:.0e}), at the final y "
        f"{grad_errs['final']['net']:.3e} over its max entry and {grad_errs['final']['terms']:.3e} over its terms' "
        f"(limit {PLOT_GRAD_TOL:.0e}; the net is {grad_errs['final']['net_over_terms']:.3e} of the terms); "
        f"trustworthiness (k = {PLOT_TRUST_K}) over {rows_t.numel()} rows {trust:.6f} in {trust_s:.3f} s")
    log(f"[14] {smi_line()}: the phase took {phase_s:.2f} s (budget {PLOT_BUDGET_S:.0f} s)")
    check(phase_s <= PLOT_BUDGET_S, f"[14] the phase took {phase_s:.2f} s, over its {PLOT_BUDGET_S:.0f} s budget")
    return dict(launches=counts["f32"], fixup_launches=fixups["f32"], nafs_s=nafs_s, plot_s=plot_s, tsne_s=tsne_s,
                timings=timings, iterations=iterations, ms_per_iteration=timings["descent"] / iterations * 1e3,
                peak_bytes=peak, kl=tsne.kl_divergence_, kl_after_exploration=tsne.kl_after_exploration_,
                p_err=p_err, grad_errs=grad_errs, trustworthiness=trust, phase_s=phase_s, inked=inked, kl_ms=kl_ms,
                kl_bound_ms=kl_bound_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's smoke run needs one GPU", file=sys.stderr)
        return 1
    from sgl_tpu_torch.kernels import _build

    log(smi_line())
    dev = torch.device("cuda")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        report = [
            subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", f"{tmp}/{name}.so",
                 str(_build.CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for name in _build.SOURCES
        ]
        try:
            libs = _build.build()
            log(f"[1] built {[p.name for p in libs]} in {time.perf_counter() - t:.2f} s")
            for proc in report:
                out, _ = proc.communicate()
                check(proc.returncode == 0, f"nvcc -Xptxas -v failed:\n{out}")
                summary = ptxas_summary(out)
                check(summary, f"ptxas reported no kernel entry:\n{out}")
                for line in summary:
                    log(f"[1] ptxas {line}")
        finally:  # leave no compiler running behind a failure
            for proc in report:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()

    phases = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phases[name] = time.perf_counter() - t
        log(f"[{name}] phase done in {phases[name]:.2f} s")
        return out

    bench = phase("2", kernel_phase, dev)
    launches, main_errs = phase("3", main_path_phase, dev)
    phase("3 small graph", reference_check_phase, dev)
    stream_bench = phase("4", streaming_bench_phase, dev, bench)
    products, products_graph, products_refs = phase("5", products_phase, dev)
    dev_launches, dev_results = phase("6", dev_phase, dev)
    zoo_launches = phase("7", zoo_phase, dev, products_graph)
    label = phase("8", label_phase, dev)
    hetero = phase("9", hetero_phase, dev)
    ooc = phase("10", ooc_phase, dev, products_graph, products_refs)
    nas = phase("11", nas_phase, dev)
    dist = phase("12", dist_phase, dev, products_graph)
    del products_graph, products_refs
    loaders = phase("13", loaders_phase, dev)
    plot = phase("14", plot_phase, dev)
    print(json.dumps(kernels_line(bench, launches, main_errs, stream_bench, products, dev_launches, dev_results,
                                  zoo_launches, label, hetero, ooc, nas, dist, loaders, plot)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def kernels_line(bench, launches, main_errs, stream_bench, products, dev_launches, dev_results,
                 zoo_launches, label, hetero, ooc, nas, dist, loaders, plot) -> dict:
    kernels = []
    for key in ("f32", "bf16"):
        r = bench[key]
        kernels.append({
            "name": f"spmm_csr_{key}", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": launches[key], "fixup_launches": launches.get("fixup_" + key),
            # phase 7, the model zoo, counted apart from the main path
            "zoo_launches": zoo_launches[key], "zoo_fixup_launches": zoo_launches["fixup_" + key],
            # the larger error of the two shapes checked (bench and main path)
            "max_abs_err": max(r["abs_err"], main_errs[key][0]),
            "max_rel_err": max(r["rel_err"], main_errs[key][1]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "shape": "bench",
        })
    # phase 8, the label and NAFS tasks (f32 only), apart from the main path:
    # their launches, K1 at the label widths and K1's gradient at the main
    # path's shape, each with its own times and bound
    k1 = kernels[0]
    k1.update(label_launches=label["launches"], label_fixup_launches=label["fixup_launches"],
              label_widths={str(d): r for d, r in label["widths"].items()},
              gradient=label["gradient"], nafs_product=label["multi"])
    # phase 11, NAS (the search and successive halving), apart from the main path
    k1.update(nas_launches=nas["launches"], nas_fixup_launches=nas["fixup_launches"])
    # phase 13, the loaders and the examples, apart from the main path: their
    # launches, and K1 at Reddit's and Flickr's shapes with its own times
    k1.update(loader_launches=loaders["launches"],
              shapes={name: {k: loaders[name][k] for k in SHAPE_KEYS} for name in ("reddit", "flickr")})
    k1["max_abs_err"] = max(k1["max_abs_err"], *(loaders[n]["max_abs_err"] for n in ("reddit", "flickr")))
    k1["max_rel_err"] = max(k1["max_rel_err"], *(loaders[n]["max_rel_err"] for n in ("reddit", "flickr")))
    # phase 14, the clustering plots, apart from the main path: NAFS's hops
    k1.update(plot_launches=plot["launches"], plot_fixup_launches=plot["fixup_launches"])
    # phase 9, the NARS path and graph classification, apart from the main
    # path: their launches, and K1/K2 at the NARS and graph-level batches
    for key, k in zip(("f32", "bf16"), kernels[:2]):
        k.update(hetero_launches=hetero["launches"][key], hetero_fixup_launches=hetero["launches"]["fixup_" + key],
                 nars_batch=hetero["times"]["nars"][key], graph_batch=hetero["times"]["graph"][key])
    for key in ("f32", "bf16"):
        p, sb = products[key], stream_bench[key]
        # phase 10, the out-of-core call sites, apart from the main path: each
        # form's launches a hop (held), its launches held against the plain
        # twin, and its hop times, one products hop
        forms = {name: r for name, r in ooc["products"].items() if r["key"] == key}
        kernels.append({
            "name": f"spmm_csr_acc_{key}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES_ACC, "launches": p["launches"], "fixup_launches": p.get("fixup_launches"),
            # the largest error of the shapes checked (bench, products and
            # each out-of-core form's parts or cells)
            "max_abs_err": max(p["abs_err"], sb["abs_err"], *(r["max_abs_err"] for r in forms.values())),
            "max_rel_err": max(p["rel_err"], sb["rel_err"], *(r["max_rel_err"] for r in forms.values())),
            # one hop at products scale: every part's launch, summed
            "ms": p["ms"], "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
            "bound_by": p["bound_by"], "library_ms": p["library_ms"], "shape": "products",
        })
        kernels[-1]["ooc_launches"] = {name: [r["launches"], r["fixup_launches"]] for name, r in forms.items()}
        kernels[-1]["ooc"] = forms
        if key == "f32":
            kernels[-1]["ooc_launches"]["papers100m pipeline"] = [ooc["papers"]["launches"],
                                                                  ooc["papers"]["fixup_launches"]]
            kernels[-1]["papers100m"] = ooc["papers"]
        # phase 12, the distributed ring, apart from the main path: each run's
        # launches a rank (spmm_dist.py:777) and ring_bucket_work_time's
        # launches and times on the products graph (spmm_dist.py:132)
        kernels[-1]["ring_replaces"] = [DIST_REPLACES["ring"], DIST_REPLACES["work"]]
        kernels[-1]["ring_launches"] = dist["ring_launches"][key]
        kernels[-1]["ring_work"] = dist["work"][key]
        kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"], dist["work"][key]["max_abs_err"])
        kernels[-1]["max_rel_err"] = max(kernels[-1]["max_rel_err"], dist["work"][key]["max_rel_err"])
    for key, r in dev_results.items():
        gather = key == "gather_sum"
        kernels.append({
            "name": key if gather else f"segment_reduce_{key}", "route": "cuda",
            "source": "sgl_tpu_torch/kernels/csrc/gather_sum.cu" if gather else SEGMENT_SOURCE,
            "replaces": DEV_REPLACES[key], "launches": dev_launches[key],
            "fixup_launches": dev_launches.get("fixup_" + key),
            "max_abs_err": r["abs_err"], "max_rel_err": r["rel_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": "gather probe, E = 2^20" if gather else "bench",
        })
    return {"kernels": kernels}


if __name__ == "__main__":
    sys.exit(main())
