#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sgl_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. print the card's name and power limit (``nvidia-smi``); build every CUDA
   kernel of the package from source with ``nvcc`` and print the seconds;
2. hold each kernel against its plain PyTorch twin at the SpMM bench shape
   (``random_power_law_graph(200_000, 25, 128, seed=0)``: ~5.2M nonzeros
   with self-loops) and time kernel, twin and the library call
   (``torch.sparse.mm`` on a CSR tensor, used nowhere in the port) with
   CUDA events;
3. run the main path at full width through the user-facing entry points on
   the default device: ``NodeClassification`` with GAMLP (f32 precompute)
   and with SGC (bf16 precompute) on a 100k-node power-law dataset, with
   the launch counters set to 0 just before each run and read just after;
   then hold each kernel against its twin again at the main path's shape,
   and check the outputs against the port's CPU path on a small graph;
4. print one JSON line ``{"kernels": [...]}`` with each kernel's launches,
   errors and times beside its bound;
5. print ``{"ok": true, "device": {...}}`` as the last line.

It needs a CUDA device and the repository's ``sgl_tpu_torch`` package next
to it, and exits non-zero without printing a result when either is missing.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and f32
# arithmetic outside the tensor cores (the kernel sums in f32 for both dtypes)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
REPLACES = "sgl_tpu/kernels/pallas_spmm.py:466"
SOURCE = "sgl_tpu_torch/kernels/csrc/spmm_csr.cu"
# f32: the twin adds each row's messages in the kernel's order, so the two
# differ only by the kernel's fused multiply-add; bf16: one output rounding (2^-8)
TOL = {"f32": 1e-5, "bf16": 1e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg) -> None:
    if not ok:
        raise RuntimeError(str(msg))


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median milliseconds of ``fn`` over ``iters`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got, want) -> tuple:
    diff = (got.double() - want.double()).abs().max().item()
    return diff, diff / max(want.double().abs().max().item(), 1e-30)


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
    g = random_power_law_graph(200_000, 25, 128, seed=0)
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
        try:
            # columns are not sorted within a row (each self-loop comes last),
            # which the invariant check would refuse and cuSPARSE accepts
            a = torch.sparse_csr_tensor(
                adj.rowptr, adj.col, adj.val.to(dtype), size=(n, n), check_invariants=False
            )
            lib_rel = rel_err(torch.sparse.mm(a, x), spmm_csr_reference(adj, x))[1]
            library_ms = time_ms(lambda: torch.sparse.mm(a, x))
            lib_note = f"{library_ms:.4f} ms (max rel err vs twin {lib_rel:.2e})"
        except (RuntimeError, NotImplementedError) as exc:  # the yardstick only
            library_ms, lib_note = None, f"not supported for {key}: {type(exc).__name__}: {exc}"
        s = x.element_size()
        nbytes = 4 * (n + 1) + 8 * e + 2 * n * d * s
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * e * d / F32_FLOPS * 1e3
        results[key] = dict(
            abs_err=abs_err, rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        )
        log(f"[2] spmm_csr {key}: max abs err {abs_err:.3e}, max rel err {rel:.3e} "
            f"(limit {TOL[key]:.0e}; vs an f64 sum {rel64:.3e}); kernel {ms:.4f} ms/hop = {e / ms / 1e6:.3f} G edges/s; "
            f"plain twin {plain_ms:.4f} ms; bound {max(bytes_ms, ops_ms):.4f} ms "
            f"({nbytes / 1e6:.1f} MB at 3.35 TB/s; ops {ops_ms:.4f} ms); library {lib_note}")
    skew_probe(dev, adj, x32)
    return results


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
        for k in spmm_csr.launches:
            spmm_csr.launches[k] = 0
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
    libs = _build.build()
    log(f"[1] built {[p.name for p in libs]} in {time.perf_counter() - t:.2f} s")

    bench = kernel_phase(dev)
    launches, main_errs = main_path_phase(dev)
    reference_check_phase(dev)

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
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
