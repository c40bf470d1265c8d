#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sgl_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. print the card's name and power limit (``nvidia-smi``); build every CUDA
   kernel of the package from source with ``nvcc`` and print the seconds;
   beside it, a second compile with ``-Xptxas -v`` prints each kernel
   instantiation's registers and spills;
2. hold the one-shot kernels against their plain PyTorch twin at the SpMM
   bench shape (``random_power_law_graph(200_000, 25, 128, seed=0)``: ~5.2M
   nonzeros with self-loops) and time kernel, twin and the library call
   (``torch.sparse.mm`` on a CSR tensor, used nowhere in the port) with
   CUDA events;
3. run the main path at full width through the user-facing entry points on
   the default device: ``NodeClassification`` with GAMLP (f32 precompute)
   and with SGC (bf16 precompute) on a 100k-node power-law dataset, with
   the launch counters set to 0 just before each run and read just after;
   then hold each kernel against its twin again at the main path's shape,
   and check the outputs against the port's CPU path on a small graph;
4. streaming SpMM at the bench shape, in parts of ``1 << 20`` nonzeros:
   the accumulating kernels against their twin and against the one-shot
   product, the accumulate contract on one part (rows outside it kept bit
   for bit), and their times;
5. the products-scale pipeline (``sgl_tpu_torch.examples.
   products_scale_demo.main``: 2.4M nodes, ~62.4M nonzeros, d = 100, parts
   of ``6 << 20``) on the default device, f32 with GAMLP training and bf16
   precompute only, counters set to 0 just before each run and read just
   after; one hop of each held against the streaming twin and, within a
   limit for two f32 orders over hub rows, against the one-shot kernel,
   which is timed beside it; first the same pipeline at a small size
   against the port's CPU path;
6. the ports of the ``dev/`` harnesses (TPU kernels D1–D6,
   ``sgl_tpu_torch.dev``) at the bench shape: with the launch counters set
   to 0 just before and read just after, ``exp_spmm.check`` (every SpMM
   variant against ``spmm_csr_reference``), D2's accumulate probe and D1's
   gather probe (2^20 rows of 128 f32, 2^18 and 2^20 edges, its bound from
   the distinct rows the ids name, ``embedding_bag`` as its library call);
   then each of
   the six segment-reduce instantiations against its twin on its
   variant's messages (D2 into a random accumulator at a row offset,
   storage kept, untouched rows bit-exact), timed beside its bound, one
   message array at a time;
7. print one JSON line ``{"kernels": [...]}`` with each kernel's launches,
   errors and times beside its bound;
8. print ``{"ok": true, "device": {...}}`` as the last line.

It needs a CUDA device and the repository's ``sgl_tpu_torch`` package next
to it, and exits non-zero without printing a result when either is missing.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# CUDA-event medians, (max abs, max rel) errors and the H100 SXM's published
# HBM3 bandwidth: the helpers the ported dev/ harnesses time and compare with
from sgl_tpu_torch.dev import HBM_BYTES_PER_S, rel_err, time_ms

# H100 SXM published f32 peak outside the tensor cores (NVIDIA data sheet;
# the kernels sum in f32 for both dtypes)
F32_FLOPS = 67e12
REPLACES = "sgl_tpu/kernels/pallas_spmm.py:466"
REPLACES_ACC = "sgl_tpu/kernels/pallas_spmm.py:544"
SOURCE = "sgl_tpu_torch/kernels/csrc/spmm_csr.cu"
# f32: the twin adds each row's messages in the kernel's order, so the two
# differ only by the kernel's fused multiply-add; bf16: one output rounding
# (2^-8).  The f32 accumulator itself is held to the f32 limit for both.
TOL = {"f32": 1e-5, "bf16": 1e-2}
# streaming against one-shot at products scale (``split_order_check``)
ORDER_TOL = {"f32": 1e-4, "bf16": 1e-2}
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


def check(ok, msg) -> None:
    if not ok:
        raise RuntimeError(str(msg))


def f64_sum(adj, x):
    """The same product summed in float64: what the f32 sums lose over long
    rows, reported beside the check and not held to a limit."""
    rows = torch.repeat_interleave(
        torch.arange(adj.num_nodes, device=x.device), torch.diff(adj.rowptr.long())
    )
    msgs = x.double().index_select(0, adj.col.long()) * adj.val.double()[:, None]
    return torch.zeros(x.shape, dtype=torch.float64, device=x.device).index_add_(0, rows, msgs)


def compare(adj, x, key: str, where: str) -> tuple:
    """The kernel against its plain twin on the same inputs; raises past
    ``TOL``.  Returns (max abs err, max rel err, max rel err against the
    float64 sum)."""
    from sgl_tpu_torch.kernels import spmm_csr, spmm_csr_reference

    y_k = spmm_csr(adj, x)
    y_ref = spmm_csr_reference(adj, x)
    torch.cuda.synchronize()
    check(y_k.dtype == x.dtype and y_k.shape == x.shape, f"{key}: {y_k.dtype} {tuple(y_k.shape)}")
    check(torch.isfinite(y_k.float()).all().item(), f"{key}: non-finite kernel output")
    abs_err, rel = rel_err(y_k, y_ref)
    check(rel <= TOL[key], f"spmm_csr {key} disagrees with its plain twin at {where}: {rel:.3e}")
    return abs_err, rel, rel_err(y_k, f64_sum(adj, x))[1]


def kernel_phase(dev):
    from sgl_tpu_torch.datasets import random_power_law_graph
    from sgl_tpu_torch.graph import symmetric_normalized_weights
    from sgl_tpu_torch.kernels import prepare_csr, spmm_csr, spmm_csr_reference

    t = time.perf_counter()
    g = random_power_law_graph(**BENCH_GRAPH)
    adj = prepare_csr(symmetric_normalized_weights(g, device=dev))
    n, e, d = adj.num_nodes, adj.nnz, g.num_features
    log(f"[2] bench graph: {n} nodes, {e} nonzeros (with self-loops), d={d} "
        f"({time.perf_counter() - t:.2f} s to build)")
    x32 = torch.as_tensor(g.x, device=dev)
    results = {}
    for key, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = x32.to(dtype)
        abs_err, rel, rel64 = compare(adj, x, key, "the bench shape")
        ms = time_ms(lambda: spmm_csr(adj, x))
        plain_ms = time_ms(lambda: spmm_csr_reference(adj, x))
        library_ms, lib_note = library_time(adj, x, spmm_csr_reference(adj, x))
        nbytes = 4 * (n + 1) + 8 * e + 2 * n * d * x.element_size()
        results[key] = dict(abs_err=abs_err, rel_err=rel, ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms, **bound(nbytes, e, d))
        log(f"[2] spmm_csr {key}: max abs err {abs_err:.3e}, max rel err {rel:.3e} "
            f"(limit {TOL[key]:.0e}; vs an f64 sum {rel64:.3e}); kernel {ms:.4f} ms/hop = {e / ms / 1e6:.3f} G edges/s; "
            f"plain twin {plain_ms:.4f} ms; bound {results[key]['bound_ms']:.4f} ms "
            f"({nbytes / 1e6:.1f} MB at 3.35 TB/s; ops {2 * e * d / F32_FLOPS * 1e3:.4f} ms); "
            f"library {lib_note}")
    skew_probe(dev, adj, x32)
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


def skew_probe(dev, adj, x):
    """Where the f32 kernel's time goes on the power-law graph: its longest
    row alone (every other row empty), and a degree-uniform graph with the
    same node count and average degree (``alpha=0``)."""
    from sgl_tpu_torch.datasets import random_power_law_graph
    from sgl_tpu_torch.graph import symmetric_normalized_weights
    from sgl_tpu_torch.kernels import CsrAdj, prepare_csr, spmm_csr

    lengths = torch.diff(adj.rowptr.long())
    top = int(lengths.argmax())
    beg, end = int(adj.rowptr[top]), int(adj.rowptr[top + 1])
    rowptr = torch.zeros_like(adj.rowptr)
    rowptr[top + 1:] = end - beg
    hub = CsrAdj(rowptr, adj.col[beg:end].contiguous(), adj.val[beg:end].contiguous(), adj.num_nodes)
    hub_ms = time_ms(lambda: spmm_csr(hub, x))
    g = random_power_law_graph(adj.num_nodes, 25, x.shape[1], seed=0, alpha=0.0)
    uni = prepare_csr(symmetric_normalized_weights(g, device=dev))
    xu = torch.as_tensor(g.x, device=dev)
    uni_ms = time_ms(lambda: spmm_csr(uni, xu))
    log(f"[2] skew probe f32: longest row {top} holds {end - beg} of {adj.nnz} nonzeros "
        f"(mean row {adj.nnz / adj.num_nodes:.1f}); that row alone {hub_ms:.4f} ms; "
        f"degree-uniform graph ({uni.nnz} nonzeros, longest row {int(torch.diff(uni.rowptr.long()).max())}) "
        f"{uni_ms:.4f} ms")


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
    launches = {"f32": 0, "bf16": 0}
    for name, key, pdtype, make in runs:
        model = make()
        reset_launches()
        task = NodeClassification(
            ds, model, lr=0.1, weight_decay=5e-5, epochs=5, verbose=False,
            precompute_dtype=pdtype,
        )
        counts = dict(spmm_csr.launches)
        for k in launches:
            launches[k] += counts[k]
        pf = model.processed_feature
        check(pf.is_cuda and torch.isfinite(pf.float()).all().item(), f"{name}: bad features")
        check(counts[key] >= 3, f"{name}: the {key} kernel ran {counts[key]} times, expected >= 3")
        check(0.0 <= task.test_acc <= 1.0, f"{name}: test accuracy {task.test_acc}")
        epochs_ms = [s * 1e3 for s in task.epoch_seconds]
        log(f"[3] {name}: launches {counts}; features {tuple(pf.shape)} {pf.dtype}; "
            f"preprocess {task.preprocess_seconds:.4f} s; train epoch ms {[round(m, 3) for m in epochs_ms]} "
            f"(median {statistics.median(epochs_ms):.3f}); best-val test acc {task.test_acc:.4f}")

    # each kernel against its twin at the shape the main path gave it (the
    # adjacency its LaplacianGraphOp(r=0.5) built), after the counts were read
    adj =prepare_csr(symmetric_normalized_weights(ds.graph, device=dev))
    x32 = torch.as_tensor(ds.x, device=dev)
    errs = {}
    for key, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = x32.to(dtype)
        errs[key] = compare(adj, x, key, "the main-path shape")
        ms = time_ms(lambda: spmm_csr(adj, x))
        log(f"[3] spmm_csr {key} at the main-path shape ({adj.num_nodes} nodes, {adj.nnz} nonzeros, "
            f"d={x.shape[1]}, longest row {int(torch.diff(adj.rowptr.long()).max())}): "
            f"max abs err {errs[key][0]:.3e}, max rel err {errs[key][1]:.3e} "
            f"(vs an f64 sum {errs[key][2]:.3e}); kernel {ms:.4f} ms/hop")
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
    """One line per kernel entry of ``ptxas -v``'s log: its template
    arguments (the mangled name's: ``13__nv_bfloat16fLi4ELb1E`` is bf16
    in, f32 out, VEC 4, accumulate; ``S1_`` repeats the first type),
    registers and spill bytes."""
    lines, name, spill = [], None, ""
    for line in log_text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            args = re.search(r"kernelI(\w+?)EEv", entry.group(1))
            name = args.group(1) if args else entry.group(1)
        elif name and "spill stores" in line:
            spill = re.sub(r".*?(\d+) bytes spill stores, (\d+) bytes spill loads.*",
                           r"spill \1 B stored / \2 B loaded", line.strip())
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            lines.append(f"{name}: {regs} registers, {spill}")
            name, spill = None, ""
    return lines


def reset_launches() -> None:
    from sgl_tpu_torch.kernels import spmm_csr

    for k in spmm_csr.launches:
        spmm_csr.launches[k] = 0


def stream_bytes(parts, x) -> int:
    """Compulsory bytes of one streaming product: every part's row pointer,
    col and val, x read once, the f32 accumulator read and written once."""
    n, d = x.shape
    return 4 * (n + len(parts)) + 8 * parts.nnz + n * d * x.element_size() + 2 * n * d * 4


def describe_parts(parts) -> str:
    """Each part's nonzeros, rows and longest row, and how many rows are
    cut between consecutive parts."""
    pairs = zip(parts.parts[:-1], parts.parts[1:])
    cut = sum(a.row_offset + a.num_rows - 1 == b.row_offset for a, b in pairs)
    return (f"nonzeros {[p.nnz for p in parts]}, rows "
            f"{[(p.row_offset, p.row_offset + p.num_rows) for p in parts]}, longest rows "
            f"{[int(torch.diff(p.rowptr.long()).max()) for p in parts]}, "
            f"{cut} of {len(parts) - 1} boundaries inside a row")


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
            f"vs one-shot spmm_csr max rel err {rel_o:.3e} (limit {TOL[key]:.0e}); "
            f"acc_{key} launches {sum(per_part):.4f} ms (per part {[round(t, 4) for t in per_part]}); "
            f"spmm_csr_streaming call {call_ms:.4f} ms; plain twin {plain_ms:.4f} ms; "
            f"bound {b['bound_ms']:.4f} ms ({stream_bytes(parts, x) / 1e6:.1f} MB at 3.35 TB/s, "
            f"ops {2 * parts.nnz * x.shape[1] / F32_FLOPS * 1e3:.4f} ms); "
            f"library (torch.sparse.mm, phase 2) {bench[key]['library_ms']}")
    return results



def split_order_check(adj, streamed, one_shot, x, where: str) -> str:
    """Streaming against one-shot where rows of millions of nonzeros are cut
    between parts: a cut row sums its shares apart, and over such rows two
    f32 orders drift apart by about what one long f32 sum loses (the main
    path's 196,747-nonzero hub row is 5.9e-5 of max|y| from a float64 sum),
    so they are held to ``ORDER_TOL``, which a wrong part still breaks by
    orders of magnitude.  The worst row is summed in float64 to show how far
    each is from exact.  Returns a note for the log."""
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

    results = {}
    for key, dtype, train in (("f32", None, True), ("bf16", torch.bfloat16, False)):
        reset_launches()
        t = time.perf_counter()
        out = products_scale_demo.main(**PRODUCTS, dtype=dtype, train=train)
        wall = time.perf_counter() - t
        counts = dict(spmm_csr.launches)
        parts, stack = out["parts"], out["hops"]
        want_counts = {k: 0 for k in counts}
        want_counts["acc_" + key] = PRODUCTS["hops"] * len(parts)
        check(counts == want_counts, f"products {key}: launches {counts}, expected {want_counts}")
        check(stack.shape == (PRODUCTS["hops"] + 1, PRODUCTS["n"], PRODUCTS["d"]), tuple(stack.shape))
        check(torch.isfinite(stack.float()).all().item(), f"products {key}: non-finite hops")
        hop_s = out["hop_seconds"]
        steady = min(hop_s[1:])
        log(f"[5] products {key}: launches {counts} (hops x parts = {PRODUCTS['hops']} x {len(parts)}); "
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
        del one_shot
        one_shot_ms = time_ms(lambda: spmm_csr(out["csr"], x), warmup=1, iters=3)
        library_ms, lib_note = library_time(out["csr"], x, stack[1], 1, 5)
        b = bound(stream_bytes(parts, x), parts.nnz, x.shape[1])
        log(f"[5] products {key}: hop 1 vs streaming twin max abs err {abs_err:.3e}, max rel err {rel:.3e} "
            f"(limit {TOL[key]:.0e}); {order_note}; acc_{key} launches alone {sum(per_part):.4f} ms "
            f"(per part {[round(t, 4) for t in per_part]}); one-shot spmm_csr {key} {one_shot_ms:.4f} ms; "
            f"plain twin {plain_ms:.4f} ms; "
            f"bound {b['bound_ms']:.4f} ms ({stream_bytes(parts, x) / 1e9:.4f} GB at 3.35 TB/s, "
            f"ops {2 * parts.nnz * x.shape[1] / F32_FLOPS * 1e3:.4f} ms); library {lib_note}")
        results[key] = dict(
            launches=counts["acc_" + key], abs_err=max(abs_err, acc_abs), rel_err=max(rel, acc_rel),
            ms=sum(per_part), plain_ms=plain_ms, library_ms=library_ms, **b,
        )
        del out, stack, x, parts
        torch.cuda.empty_cache()
    return results


def reset_dev_launches() -> None:
    from sgl_tpu_torch.kernels import gather_sum, segment_reduce

    for counts in (segment_reduce.launches, gather_sum.launches):
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


def dev_library_time(m, rowptr, want) -> tuple:
    """``torch.segment_reduce`` (sum over offsets) on the same f32 messages,
    the yardstick only: (median ms or None, a note with its error)."""
    offsets = rowptr.long()
    try:
        lib_rel = rel_err(torch.segment_reduce(m, "sum", offsets=offsets, axis=0), want)[1]
        ms = time_ms(lambda: torch.segment_reduce(m, "sum", offsets=offsets, axis=0), warmup=1, iters=5)
        return ms, f"torch.segment_reduce {ms:.4f} ms (max rel err {lib_rel:.2e})"
    except (RuntimeError, NotImplementedError) as exc:  # the yardstick only
        return None, f"torch.segment_reduce failed: {type(exc).__name__}: {exc}"


def dev_phase(dev):
    """The ports of the ``dev/`` harnesses (TPU kernels D1–D6) at the bench
    shape: their paths with the counters set to 0 just before and read just
    after, then each instantiation against its twin on the harness's own
    messages, timed beside its bound."""
    from sgl_tpu_torch.dev import exp_acc_alias, exp_gather_dma, exp_spmm
    from sgl_tpu_torch.kernels import gather_sum, segment_reduce, segment_reduce_reference
    from sgl_tpu_torch.kernels.segment_reduce import INSTANTIATIONS

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
    check(all(v > 0 for v in launches.values()), f"[6] a kernel was not launched: {launches}")
    errs = ", ".join(f"{k} {v:.3e}" for k, v in harness_errs.items())
    log(f"[6] harness paths: launches {launches}; exp_spmm --check errors: {errs}; acc_alias {alias}")

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
            got, want = got[touched], want[touched]
            got_out = acc
            run = lambda: segment_reduce(csr.rowptr, m, out=acc, **kw)  # noqa: E731
            twin = lambda: segment_reduce_reference(csr.rowptr, m, out=acc, **kw)  # noqa: E731
        else:
            got = segment_reduce(csr.rowptr, m, **kw)
            want = segment_reduce_reference(csr.rowptr, m, **kw)
            torch.cuda.synchronize()
            check(got.shape == (n, d) and got.dtype == torch.float32, f"[6] {key}: {tuple(got.shape)}")
            note, got_out = "", None
            run = lambda: segment_reduce(csr.rowptr, m, **kw)  # noqa: E731
            twin = lambda: segment_reduce_reference(csr.rowptr, m, **kw)  # noqa: E731
        check(torch.isfinite(got).all().item(), f"[6] {key}: non-finite output")
        abs_err, rel = rel_err(got, want)
        check(rel <= DEV_TOL, f"[6] segment_reduce {key} disagrees with its twin: {rel:.3e}")
        ms = time_ms(run, warmup=2, iters=10)
        plain_ms = time_ms(twin, warmup=1, iters=3)
        hub_kw = {k: (v[beg:end] if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
        hub_ms = time_ms(lambda: segment_reduce(hub_rowptr, m[beg:end], out=got_out, **hub_kw),
                         warmup=1, iters=5)
        library_ms, lib_note = None, "no one PyTorch call computes this form"
        if key == "f32":
            library_ms, lib_note = dev_library_time(m, csr.rowptr, want)
        b = segment_bound(m, kw, n, d, accumulate)
        results[key] = dict(abs_err=abs_err, rel_err=rel, ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"])
        log(f"[6] segment_reduce {key} ({INSTANTIATIONS[key][4]}; {variant} messages "
            f"{tuple(m.shape)} {m.dtype}): {note}max abs err {abs_err:.3e}, max rel err {rel:.3e} "
            f"(limit {DEV_TOL:.0e}); kernel {ms:.4f} ms (the hub row alone {hub_ms:.4f} ms, "
            f"{hub_ms * 1e6 / (end - beg):.1f} ns a message row); plain twin {plain_ms:.4f} ms; bound "
            f"{b['bound_ms']:.4f} ms ({b['nbytes'] / 1e9:.4f} GB at 3.35 TB/s, {b['bound_by']}); "
            f"library: {lib_note}")
        del m, got, want, run, twin
        torch.cuda.empty_cache()

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



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's smoke run needs one GPU", file=sys.stderr)
        return 1
    from sgl_tpu_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
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
    products = phase("5", products_phase, dev)
    dev_launches, dev_results = phase("6", dev_phase, dev)
    print(json.dumps(kernels_line(bench, launches, main_errs, stream_bench, products,
                                  dev_launches, dev_results)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def kernels_line(bench, launches, main_errs, stream_bench, products, dev_launches, dev_results) -> dict:
    kernels = []
    for key in ("f32", "bf16"):
        r = bench[key]
        kernels.append({
            "name": f"spmm_csr_{key}", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": launches[key],
            # the larger error of the two shapes checked (bench and main path)
            "max_abs_err": max(r["abs_err"], main_errs[key][0]),
            "max_rel_err": max(r["rel_err"], main_errs[key][1]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "shape": "bench",
        })
    for key in ("f32", "bf16"):
        p, sb = products[key], stream_bench[key]
        kernels.append({
            "name": f"spmm_csr_acc_{key}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES_ACC, "launches": p["launches"],
            # the larger error of the two shapes checked (bench and products)
            "max_abs_err": max(p["abs_err"], sb["abs_err"]),
            "max_rel_err": max(p["rel_err"], sb["rel_err"]),
            # one hop at products scale: every part's launch, summed
            "ms": p["ms"], "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
            "bound_by": p["bound_by"], "library_ms": p["library_ms"], "shape": "products",
        })
    for key, r in dev_results.items():
        gather = key == "gather_sum"
        kernels.append({
            "name": key if gather else f"segment_reduce_{key}", "route": "cuda",
            "source": "sgl_tpu_torch/kernels/csrc/gather_sum.cu" if gather else SEGMENT_SOURCE,
            "replaces": DEV_REPLACES[key], "launches": dev_launches[key],
            "max_abs_err": r["abs_err"], "max_rel_err": r["rel_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": "gather probe, E = 2^20" if gather else "bench",
        })
    return {"kernels": kernels}


if __name__ == "__main__":
    sys.exit(main())
