"""One rank of a distributed run of the port, and the launcher of its ranks.

    python -m sgl_tpu_torch.dev.dist_worker --init file:///tmp/rdv --rank 0 \\
        --world-size 4 --mesh 1,4 --device cpu --spec spec.json --out outdir

Each rank joins the process group (``--init`` is a ``file://`` path or
``tcp://localhost:<port>``; collectives time out after 60 s), builds the
``(data, graph)`` mesh, runs the checks the spec lists and writes
``rank<r>.json`` (numbers) and ``rank<r>.npz`` (arrays) under ``--out``,
then prints ``DIST_WORKER_OK rank <r>``.  Every rank runs on the GPU
(cuda:0 for all of them) unless ``--device cpu`` asks for the CPU, as the
port's other entry points do.  :func:`launch` starts every rank
as a process of its own, kills them all when one fails or the run outlasts
its limit, and returns each rank's results; it raises unless every rank
exited 0 with its OK line.  :func:`run_here` runs a world of one in the
calling process and returns the same results.

The checks (``spec["checks"]``, run in order; their inputs are in
``spec`` and in the ``.npz`` that ``spec["inputs"]`` names):

* ``ring``: ``k_hop_propagate_dist`` with both layouts, f32 and bf16,
  replicated and sharded (``rows`` at ``ids``, ``gather_full``), on the
  normalized adjacency and features given;
* ``dp``: one data-parallel step of ``spec["dp"]["model"]`` from the
  parameters in ``spec["dp"]["state"]`` on the batch given, with the
  dropout bits given (``bits_0`` ...) replayed, and again with a seeded
  generator beside the single-device step on the whole batch;
* ``task``: ``NodeClassificationDist`` sharded and replicated;
* ``nas``: ``SearchManagerDist``'s inner loop;
* ``workload``: ``NodeClassificationDist`` at a full-width configuration
  on the rank's card, its K3/K4 launches counted, its hop stack held
  against the single-device ``spmm_csr`` hops and a float64 propagation,
  the first data-parallel step's loss, gradients and parameters (before
  and after it) kept.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from sgl_tpu_torch.device import resolve_device

OK = "DIST_WORKER_OK"


class ReplayBits:
    """A dropout bit source (``FastDropout``'s ``generator``) that hands out
    recorded uint8 arrays in order, each checked against the shape asked."""

    def __init__(self, arrays):
        self.arrays = list(arrays)
        self.calls = 0

    def bits(self, shape, device):
        a = self.arrays[self.calls]
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"dropout call {self.calls}: recorded {a.shape}, asked {tuple(shape)}")
        self.calls += 1
        return torch.as_tensor(a, dtype=torch.uint8, device=device)


def _adjacency(inputs, device):
    from sgl_tpu_torch.kernels.sparse import SparseAdj

    def t(name, dtype):
        return torch.as_tensor(inputs[name], dtype=dtype, device=device)

    return SparseAdj(t("src", torch.int32), t("dst", torch.int32), t("w", torch.float32),
                     int(inputs["num_nodes"]))


def _model(cfg: dict):
    from sgl_tpu_torch import models

    return getattr(models, cfg["name"])(*cfg.get("args", ()), **cfg.get("kwargs", {}))


def _dataset(cfg: dict):
    from sgl_tpu_torch import datasets

    return getattr(datasets, cfg["name"])(**cfg.get("kwargs", {}))


def check_ring(ctx) -> None:
    from sgl_tpu_torch.parallel import k_hop_propagate_dist, partition_adj, partition_adj_chunked
    from sgl_tpu_torch.parallel.mesh import axis_size

    inputs, mesh, device = ctx["inputs"], ctx["mesh"], ctx["device"]
    adj = _adjacency(inputs, "cpu")
    parts = axis_size(mesh, "graph")
    x = torch.as_tensor(inputs["x"], dtype=torch.float32)
    k = int(inputs["prop_steps"])
    ids = torch.as_tensor(inputs["ids"]).long()
    for layout, partition in (("segment", partition_adj), ("chunked", partition_adj_chunked)):
        dadj = partition(adj, parts)
        for key, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            stats = {}
            full = k_hop_propagate_dist(mesh, dadj, x.to(dtype), k, device=device, stats=stats)
            sh = k_hop_propagate_dist(mesh, dadj, x.to(dtype), k, device=device, keep_sharded=True)
            name = f"{layout}_{key}"
            ctx["arrays"][f"{name}_full"] = full.float().cpu().numpy()
            ctx["arrays"][f"{name}_rows"] = sh.rows(ids).float().cpu().numpy()
            ctx["arrays"][f"{name}_gather"] = sh.gather_full().float().cpu().numpy()
            ctx["numbers"][f"{name}_dtype"] = str(sh.data.dtype)
            ctx["numbers"][f"{name}_shard_shape"] = list(sh.data.shape)
            ctx["numbers"][f"{name}_route"] = stats.get("route")


def _dp_step(ctx, generator, whole: bool):
    """One step of the spec's model from its saved state: data-parallel on
    this rank's rows, or (``whole``) the single-device step on the batch."""
    from sgl_tpu_torch.parallel import make_parallel_train_step, replicate_state
    from sgl_tpu_torch.tasks.utils import adam_l2, make_train_step

    cfg, inputs, device = ctx["spec"]["dp"], ctx["inputs"], ctx["device"]
    net = _model(cfg["model"]).net
    net.load_state_dict(torch.load(cfg["state"], map_location="cpu"))
    net.to(device)
    optimizer = adam_l2(net.parameters(), cfg["lr"], cfg["weight_decay"])
    feats = torch.as_tensor(inputs["feats"], device=device)
    labels = torch.as_tensor(inputs["labels"], device=device).long()
    w = torch.as_tensor(inputs["w"], device=device)
    if whole:
        loss, acc = make_train_step(net, optimizer)(feats, labels, w, generator)
    else:
        replicate_state(net, ctx["mesh"])
        step, shard_batch = make_parallel_train_step(net, optimizer, ctx["mesh"])
        loss, acc = step(*shard_batch(feats, labels, w), generator)
    return float(loss), float(acc), {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()}


def check_dp(ctx) -> None:
    inputs, device = ctx["inputs"], ctx["device"]
    recorded = [inputs[f"bits_{i}"] for i in range(int(inputs["num_bits"]))]
    replay = ReplayBits(recorded)
    loss, acc, params = _dp_step(ctx, replay, whole=False)
    if replay.calls != len(recorded):
        raise RuntimeError(f"the step drew {replay.calls} dropout masks, {len(recorded)} recorded")
    ctx["numbers"].update(dp_loss=loss, dp_acc=acc)
    ctx["arrays"].update({f"dp_param.{k}": v for k, v in params.items()})
    # the seeded generator: the data-parallel step against the single-device
    # step on the whole batch, in this process
    seed = int(ctx["spec"]["dp"].get("seed", 0))
    runs = [_dp_step(ctx, torch.Generator(device=device).manual_seed(seed), whole=w) for w in (False, True)]
    (loss_p, acc_p, par_p), (loss_1, acc_1, par_1) = runs
    ctx["numbers"].update(gen_loss=[loss_p, loss_1], gen_acc=[acc_p, acc_1])
    ctx["numbers"]["gen_param_max_abs_diff"] = max(
        float(np.abs(par_p[k] - par_1[k]).max()) for k in par_1
    )


def check_task(ctx) -> None:
    from sgl_tpu_torch.tasks import NodeClassificationDist

    cfg = ctx["spec"]["task"]
    ds = _dataset(cfg["dataset"])
    for sharded in (True, False):
        task = NodeClassificationDist(ds, _model(cfg["model"]), mesh_shape=ctx["mesh_shape"], verbose=False,
                                      sharded_hops=sharded, device=ctx["device"], **cfg["train"])
        ctx["numbers"][f"task_acc_{'sharded' if sharded else 'replicated'}"] = task.test_acc


def check_nas(ctx) -> None:
    from sgl_tpu_torch.search import SearchManagerDist, SearchModelDist

    cfg = ctx["spec"]["nas"]
    ds = _dataset(cfg["dataset"])
    model = SearchModelDist(cfg["arch"], ds.num_features, int(ds.num_classes), cfg["hidden"])
    acc, elapsed = SearchManagerDist(ds, model, mesh_shape=ctx["mesh_shape"], device=ctx["device"],
                                     **cfg["train"])._execute()
    ctx["numbers"].update(nas_acc=acc, nas_seconds=elapsed)


def _f64_hops(adj, x: torch.Tensor, steps: int) -> torch.Tensor:
    """The hop stack summed in float64."""
    from sgl_tpu_torch.kernels.sparse import segment_sum_f32

    h, out = x.double(), [x.double()]
    for _ in range(steps):
        h = segment_sum_f32(adj, h)
        out.append(h)
    return torch.stack(out)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _ring_launches(dadj, p: int, steps: int) -> Dict[str, int]:
    """K3/K4 launches and fix-ups of ``steps`` hops on rank ``p``: one per
    bucket a hop, a fix-up for each bucket with a long row."""
    buckets = dadj.buckets[p]
    return {"launches": steps * len(buckets),
            "fixup_launches": steps * sum(part.plan.num_long > 0 for part in buckets)}


def _reset_launches() -> None:
    from sgl_tpu_torch.kernels import spmm_csr

    for counts in (spmm_csr.launches, spmm_csr.fixup_launches):
        for k in counts:
            counts[k] = 0


class _References:
    """The single-device ``spmm_csr`` hops of ``ds`` and its float64
    propagation, each made once (by dtype and hop count)."""

    def __init__(self, ds, device):
        from sgl_tpu_torch.graph import symmetric_normalized_weights

        self.adj = symmetric_normalized_weights(ds.graph, device=device)
        self.x = torch.as_tensor(np.asarray(ds.x), device=device)
        self.single, self.f64 = {}, {}

    def held(self, got: torch.Tensor, dtype, steps: int) -> dict:
        """``got`` (the gathered hop stack, or its last hop) against both."""
        from sgl_tpu_torch.kernels import prepare_csr
        from sgl_tpu_torch.ops.graph_ops import k_hop_propagate

        if (dtype, steps) not in self.single:
            self.single[dtype, steps] = k_hop_propagate(prepare_csr(self.adj), self.x.to(dtype), steps)
        if steps not in self.f64:
            self.f64[steps] = _f64_hops(self.adj, self.x, steps)
        single, f64 = self.single[dtype, steps], self.f64[steps]
        if got.dim() == 2:  # an aggregate that keeps the last hop
            single, f64 = single[-1], f64[-1]
        return dict(err_vs_single=_rel(got, single), err_vs_f64=_rel(got, f64), single_vs_f64=_rel(single, f64))


def check_workload(ctx) -> None:
    """``spec["workload"]["runs"]`` on the rank's card: each either
    ``NodeClassificationDist`` with a model (its first step kept) or, with
    ``"hops_only"``, the ring's hop stack alone on a mesh of its own."""
    from sgl_tpu_torch.graph import symmetric_normalized_weights
    from sgl_tpu_torch.kernels import spmm_csr
    from sgl_tpu_torch.parallel import DistChunkedAdj, k_hop_propagate_dist, make_mesh, partition_adj_chunked
    from sgl_tpu_torch.tasks import NodeClassificationDist

    cfg, device = ctx["spec"]["workload"], ctx["device"]
    t = time.perf_counter()
    ds = _dataset(cfg["dataset"])
    ctx["numbers"]["dataset_s"] = time.perf_counter() - t
    refs = _References(ds, device)
    for run in cfg["runs"]:
        name = run["name"]
        dtype = getattr(torch, run.get("precompute_dtype", "float32"))
        mesh_shape = tuple(run.get("mesh", ctx["mesh_shape"]))
        t = time.perf_counter()
        _reset_launches()
        if run.get("hops_only"):
            mesh = make_mesh(mesh_shape)
            steps = int(run["prop_steps"])
            dadj = partition_adj_chunked(symmetric_normalized_weights(ds.graph, device=device), mesh_shape[1])
            stats = {}
            hops = k_hop_propagate_dist(mesh, dadj, torch.as_tensor(np.asarray(ds.x)).to(dtype), steps,
                                        keep_sharded=True, device=device, stats=stats)
            task = None
        else:
            model = _model(run["model"])
            steps = model.pre_graph_op.prop_steps
            task = NodeClassificationDist(
                ds, model, mesh_shape=mesh_shape, verbose=False, device=device,
                precompute_dtype=dtype if dtype != torch.float32 else None, **run["train"],
            )
            hops, stats, dadj = model.processed_feature, task.ring_stats, task.dadj
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
        counts, fixups = dict(spmm_csr.launches), dict(spmm_csr.fixup_launches)
        key = "acc_bf16" if dtype == torch.bfloat16 else "acc_f32"
        p = hops.mesh.get_local_rank("graph")
        # the CPU path (a rehearsal) runs the segment layout and counts nothing
        want = (_ring_launches(dadj, p, steps) if isinstance(dadj, DistChunkedAdj)
                else {"launches": 0, "fixup_launches": 0})
        out = dict(
            mesh=list(mesh_shape), graph_rank=p,
            launches={key: counts[key], "fixup_" + key: fixups[key]},
            other_launches={k: v for k, v in counts.items() if k != key and v},
            want_launches={key: want["launches"], "fixup_" + key: want["fixup_launches"]},
            kernel_ms=stats.get("kernel_ms"), transfer_ms=stats.get("transfer_ms"), route=stats.get("route"),
            wall_s=wall,
        )
        t = time.perf_counter()
        out.update(refs.held(hops.gather_full(), dtype, steps), reference_s=time.perf_counter() - t)
        if task is not None:
            first = task.first_step
            out.update(step_ms=[s * 1e3 for s in task.step_seconds], epoch_s=task.epoch_seconds,
                       preprocess_s=task.preprocess_seconds,
                       test_acc=task.test_acc, first_loss=first["loss"])
            for what in ("params_before", "grads", "params"):
                for k, v in first[what].items():
                    ctx["arrays"][f"{name}.first_{what}.{k}"] = v.numpy()
            model.processed_feature = None
        ctx["numbers"][name] = out
        del task, hops
        if device.type == "cuda":
            torch.cuda.empty_cache()


CHECKS = {"ring": check_ring, "dp": check_dp, "task": check_task, "nas": check_nas,
          "workload": check_workload}


def _np(v):
    return v.item() if isinstance(v, np.generic) else v


def _run(spec: dict, mesh_shape, device: torch.device, rank: int, seconds: dict):
    """The checks of ``spec`` on this rank, its process group joined:
    ``(numbers, arrays)``."""
    from sgl_tpu_torch.parallel import make_mesh

    t = time.perf_counter()
    mesh = make_mesh(mesh_shape)
    seconds["mesh"] = time.perf_counter() - t
    if device.type == "cuda":  # the card's first use, timed apart
        t = time.perf_counter()
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
        seconds["cuda_init"] = time.perf_counter() - t
    inputs = dict(np.load(spec["inputs"])) if spec.get("inputs") else {}
    ctx = {"spec": spec, "inputs": inputs, "mesh": mesh, "mesh_shape": mesh_shape, "device": device,
           "numbers": {"rank": rank, "backend": torch.distributed.get_backend()}, "arrays": {}}
    for name in spec["checks"]:
        t = time.perf_counter()
        CHECKS[name](ctx)
        seconds[name] = time.perf_counter() - t
    ctx["numbers"]["seconds"] = seconds
    return ctx["numbers"], ctx["arrays"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--init", required=True, help="file:///path or tcp://localhost:<port>")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--mesh", required=True, help="data,graph")
    ap.add_argument("--device", default=None, help="default: the GPU (every rank on cuda:0); or cpu")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--spec", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--launched", type=float, default=None, help="the launcher's clock (time.time()) at spawn")
    args = ap.parse_args(argv)
    seconds = {"to_main": None if args.launched is None else time.time() - args.launched}

    from sgl_tpu_torch.parallel import init_distributed

    with open(args.spec) as f:
        spec = json.load(f)
    device = resolve_device(args.device)
    t = time.perf_counter()
    init_distributed(args.init, args.world_size, args.rank, backend=args.backend, device_type=device.type)
    seconds["process_group"] = time.perf_counter() - t
    numbers, arrays = _run(spec, tuple(int(v) for v in args.mesh.split(",")), device, args.rank, seconds)
    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **arrays)
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump(numbers, f, default=_np)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"{OK} rank {args.rank}", flush=True)
    return 0


def run_here(mesh_shape, spec: dict, out_dir: str, device: Optional[str] = None,
             backend: Optional[str] = None) -> List[dict]:
    """One rank of :func:`main` in this process, for a world of one: the
    results :func:`launch` returns, with no process to start.  The process
    group (``backend``, a ``file://`` rendezvous in ``out_dir``) is
    destroyed on return; a process that already has one raises."""
    from sgl_tpu_torch.parallel import init_distributed

    if torch.distributed.is_initialized():
        raise RuntimeError("run_here starts a process group of its own; this process has one")
    os.makedirs(out_dir, exist_ok=True)
    rendezvous = os.path.join(out_dir, "rendezvous")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    device = resolve_device(device)
    t = time.perf_counter()
    init_distributed(f"file://{rendezvous}", 1, 0, backend=backend, device_type=device.type)
    try:
        seconds = {"to_main": 0.0, "process_group": time.perf_counter() - t}
        numbers, arrays = _run(spec, tuple(mesh_shape), device, 0, seconds)
    finally:
        torch.distributed.destroy_process_group()
    numbers.update(arrays=arrays, log="")
    return [numbers]


def launch(world_size: int, mesh_shape, spec: dict, out_dir: str, device: Optional[str] = None,
           backend: Optional[str] = None, limit_s: float = 300.0, threads: Optional[int] = None) -> List[dict]:
    """Run ``world_size`` ranks of :func:`main` on ``spec`` (written to
    ``out_dir``) over a ``file://`` rendezvous in ``out_dir``; returns each
    rank's numbers with its arrays under ``"arrays"``.  Raises, with every
    rank's output, when a rank fails, lacks its OK line or the ranks outlast
    ``limit_s`` (then all are killed).  ``threads`` caps each rank's CPU
    threads."""
    device = str(resolve_device(device))
    os.makedirs(out_dir, exist_ok=True)
    spec_path = os.path.join(out_dir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    rendezvous = os.path.join(out_dir, "rendezvous")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    procs = []
    with contextlib.ExitStack() as stack:
        logs = [stack.enter_context(open(os.path.join(out_dir, f"rank{r}.log"), "w+")) for r in range(world_size)]
        try:
            for r, log in enumerate(logs):
                cmd = [sys.executable, "-m", "sgl_tpu_torch.dev.dist_worker", "--init", f"file://{rendezvous}",
                       "--rank", str(r), "--world-size", str(world_size),
                       "--mesh", ",".join(map(str, mesh_shape)), "--device", device, "--spec", spec_path,
                       "--out", out_dir, "--launched", repr(time.time())]
                if backend:
                    cmd += ["--backend", backend]
                procs.append(subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
                                              start_new_session=True))
            deadline = time.monotonic() + limit_s
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline or any(p.returncode not in (None, 0) for p in procs):
                    break
                time.sleep(0.05)
            timed_out = time.monotonic() > deadline
        finally:  # no rank outlives the launch
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
        outputs = []
        for log in logs:
            log.seek(0)
            outputs.append(log.read())
    report = "\n".join(f"--- rank {r} (rc {p.returncode}) ---\n{out[-6000:]}"
                       for r, (p, out) in enumerate(zip(procs, outputs)))
    if any(p.returncode != 0 for p in procs) or any(f"{OK} rank {r}" not in out for r, out in enumerate(outputs)):
        raise RuntimeError(f"distributed run {mesh_shape} {'timed out' if timed_out else 'failed'}:\n{report}")
    results = []
    for r in range(world_size):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            numbers = json.load(f)
        numbers["arrays"] = dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
        numbers["log"] = outputs[r]
        results.append(numbers)
    return results


if __name__ == "__main__":
    sys.exit(main())
