"""One run of one cell: inputs from the seed, set-up, the measured window,
an optional traced sub-window, the comparison that decides ``correct``
and the metrics.  Everything a cell needs is found by name from
``BENCHMARK.json``:

* the configuration's ``file`` (``configs/<config>.json``) and the plain
  reference beside it (``configs/<config>.py``);
* ``traffic/<traffic>.json``: the parameters of the one runner of its
  ``kind`` (``preprocess``: calls of ``SGAPModel.preprocess``; ``train``:
  ``NodeClassification`` jobs);
* ``metrics/<metric>.py``: a reader ``read(run) -> float | None``;
* ``limits/<workload>.json``: the limit of each number compared;

the data files under the first of ``paths``, the code beside this file.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "sgl_tpu"}
SEED_SPACE = 2**32 - 1  # numpy's legacy seeding, which the task calls, takes < 2**32


class ForbiddenModules(RuntimeError):
    pass


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def load_json(path: Path):
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Manifest:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = load_json(self.root / "BENCHMARK.json")

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def metrics(self, workload: str, group: str) -> list:
        """The ``end_to_end`` or ``per_layer`` metrics that ``workload``
        reports."""
        return [m for m in self.data[group] if workload in m.get("workloads", [workload])]

    def data_dir(self) -> Path:
        """Where the cells' data files (traffic, limits, metric readers)
        live: the first of ``paths``."""
        return self.root / self.data["paths"][0]


def job_seed(seed: int, j: int) -> int:
    return (seed + j) % SEED_SPACE


class JobRecorder:
    """Records, while armed, what the judge reads of one
    ``NodeClassification`` job: the parameters at its start, its first
    three losses, Adam's first gradient (from its state after one step),
    the parameters after three steps and at its first eval, that eval's
    counts, and the sampled rows of the logits of its last forward over
    every node with the parameters it ran with.  It wraps the task's step
    factories from the benchmark's side."""

    def __init__(self, n_eval_batches: int, num_nodes: int, sample_idx):
        self.n_eval, self.num_nodes, self.sample_idx = n_eval_batches, num_nodes, sample_idx
        self.armed = False
        self.record = None

    @contextlib.contextmanager
    def installed(self):
        from unittest import mock

        from sgl_tpu_torch.tasks import node_classification as nc

        make_train, make_eval, make_logits = nc.make_train_step, nc.make_eval_step, nc.make_logits_fn
        rec = self

        def params_of(net):
            return {n: p.detach().clone() for n, p in net.named_parameters()}

        def train_factory(net, optimizer, *args, **kwargs):
            step = make_train(net, optimizer, *args, **kwargs)
            if not rec.armed:
                return step
            r = rec.record
            r["params0"] = params_of(net)
            beta1 = optimizer.param_groups[0]["betas"][0]
            count = [0]

            def recorded(*a, **k):
                out = step(*a, **k)
                count[0] += 1
                if count[0] <= 3:
                    r["losses"].append(out[0])
                if count[0] == 1:
                    # a step that left no state moved nothing: its gradient reads 0
                    r["first_grad"] = {n: optimizer.state[p].get("exp_avg", torch.zeros_like(p)).detach()
                                       / (1 - beta1) for n, p in net.named_parameters()}
                if count[0] == 3:
                    r["params3"] = params_of(net)
                return out
            return recorded

        def eval_factory(net, *args, **kwargs):
            step = make_eval(net, *args, **kwargs)
            if not rec.armed:
                return step
            r = rec.record

            def recorded(*a, **k):
                out = step(*a, **k)
                if len(r["eval_counts"]) < rec.n_eval:
                    if not r["eval_counts"]:
                        r["params_eval"] = params_of(net)
                    r["eval_counts"].append(out)
                return out
            return recorded

        def logits_factory(net, *args, **kwargs):
            fn = make_logits(net, *args, **kwargs)
            if not rec.armed:
                return fn
            r = rec.record

            def recorded(feats):
                out = fn(feats)
                if "logits_rows" not in r and out.shape[0] == rec.num_nodes:
                    r["logits_params"] = params_of(net)
                    r["logits_rows"] = out[rec.sample_idx].cpu()
                return out
            return recorded

        with mock.patch.object(nc, "make_train_step", train_factory), \
                mock.patch.object(nc, "make_eval_step", eval_factory), \
                mock.patch.object(nc, "make_logits_fn", logits_factory):
            yield self

    def arm(self, seed: int) -> None:
        self.armed = True
        self.record = dict(seed=seed, losses=[], eval_counts=[])

    def result(self) -> dict:
        r = dict(self.record)
        r["losses"] = [float(x) for x in r["losses"]]
        r["eval_counts"] = [(float(c), float(t)) for c, t in r["eval_counts"]]
        return r


class Runner:
    """What every traffic kind shares: the model factory, the rows kept of
    every unit, and the window."""

    def __init__(self, cfg, traffic, ds, inputs, model_ref, sample_idx, device, seed):
        self.cfg, self.traffic, self.ds, self.inputs = cfg, traffic, ds, inputs
        self.model_ref, self.device, self.seed = model_ref, device, seed
        self.sample_idx = torch.as_tensor(sample_idx, device=device)
        self.samples = []
        self.unit_seconds = []
        self.patches = contextlib.ExitStack()  # what the runner wraps in the program, undone by close()

    def close(self) -> None:
        self.patches.close()

    def make_model(self):
        from sgl_tpu_torch import models

        return getattr(models, self.cfg["model_class"])(**self.cfg["model_args"])

    def keep_rows(self, model) -> None:
        self.samples.append(self.model_ref.rows(model.processed_feature, self.sample_idx).cpu())

    def window(self, seconds: float) -> float:
        """Units back to back until ``seconds`` have passed, the last one
        finished; returns the window's seconds."""
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            self.unit()
            self.unit_seconds.append(time.perf_counter() - t)
            if time.perf_counter() - t0 >= seconds:
                return time.perf_counter() - t0


class PreprocessRunner(Runner):
    """Calls of ``model.preprocess(graph, x)``, each ended by a
    synchronize.  ``adjacency``: ``cold`` builds a fresh model a call (the
    normalization, the sort and the CSR each time), ``held`` keeps one
    model, whose layout set-up builds.  ``features``: ``host`` passes the
    dataset's numpy ``x`` as the task does, ``card`` a CUDA tensor made in
    set-up."""

    def setup(self) -> None:
        t = self.traffic
        self.feats = self.ds.x if t["features"] == "host" else torch.as_tensor(self.ds.x, device=self.device)
        self.model = self.make_model() if t["adjacency"] == "held" else None
        self.unit()
        self.samples.clear()

    def unit(self) -> None:
        if self.traffic["adjacency"] == "cold":
            self.model = None  # the last call's model and its output go first
            self.model = self.make_model()
        self.model.preprocess(self.ds.graph, self.feats, device=self.device)
        sync(self.device)
        self.keep_rows(self.model)

    def stats(self) -> dict:
        return dict(units=len(self.unit_seconds), unit_seconds=list(self.unit_seconds))

    def host_bytes(self) -> int:
        """Bytes a call hands the program on the host: ``x`` from the host,
        and a cold call's edges (``src``, ``dst``, ``val``)."""
        g = self.ds.graph
        edges = g.src.nbytes + g.dst.nbytes + g.val.nbytes if self.traffic["adjacency"] == "cold" else 0
        return edges + (self.ds.x.nbytes if self.traffic["features"] == "host" else 0)

    def candidate(self) -> dict:
        return dict(full=self.model.processed_feature, samples=self.samples, train=None)


class TrainRunner(Runner):
    """Back-to-back ``NodeClassification`` jobs at the configuration's
    training settings on one held model (its adjacency layout kept), job
    ``j`` seeded ``seed + j``; set-up runs a one-epoch job, which warms
    every shape a job uses."""

    def setup(self) -> None:
        val = sum(1 for _ in _batches(self.inputs.val_idx, self.cfg["eval_batch_size"]))
        test = sum(1 for _ in _batches(self.inputs.test_idx, self.cfg["eval_batch_size"]))
        self.recorder = self.patches.enter_context(
            JobRecorder(val + test, self.inputs.num_nodes, self.sample_idx).installed())
        self.model = self.make_model()
        self.jobs, self.epoch_seconds = 0, []
        self.job(epochs=1, seed=job_seed(self.seed, 999_983))
        self.samples.clear()
        self.epoch_seconds.clear()

    def job(self, epochs: int, seed: int):
        from sgl_tpu_torch.tasks import NodeClassification

        c = self.cfg
        task = NodeClassification(self.ds, self.model, lr=c["lr"], weight_decay=c["weight_decay"], epochs=epochs,
                                  device=self.device, seed=seed, train_batch_size=c["train_batch_size"],
                                  eval_batch_size=c["eval_batch_size"], verbose=False)
        sync(self.device)
        self.epoch_seconds.extend(task.epoch_seconds)
        self.keep_rows(self.model)

    def unit(self) -> None:
        seed = job_seed(self.seed, self.jobs)
        if self.jobs == 0:
            self.recorder.arm(seed)
        try:
            self.job(self.cfg["epochs"], seed)
        finally:
            self.recorder.armed = False
        self.jobs += 1

    def stats(self) -> dict:
        return dict(units=len(self.unit_seconds), unit_seconds=list(self.unit_seconds),
                    epochs=len(self.epoch_seconds), epoch_seconds=list(self.epoch_seconds))

    def host_bytes(self) -> int:
        """Bytes a job hands the program on the host: ``x``, which its
        precompute uploads."""
        return self.ds.x.nbytes

    def candidate(self) -> dict:
        return dict(full=self.model.processed_feature, samples=self.samples, train=self.recorder.result())


def _batches(idx, batch_size):
    import reference

    return reference.batch_order(idx, batch_size, False, None)


RUNNERS = {"preprocess": PreprocessRunner, "train": TrainRunner}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             chips: int = 1) -> dict:
    """One run of ``workload``: returns the result line's object, with
    the numbers compared (``checks``) last."""
    if str(BENCH_DIR) not in sys.path:
        sys.path.insert(0, str(BENCH_DIR))
    import inputs as bench_inputs
    import judge
    import reference
    import roofline

    man = Manifest(root)
    wl = man.workload(workload)
    cfg_entry = man.config(wl["config"])
    cfg_path = root / cfg_entry["file"]
    cfg = load_json(cfg_path)
    files = man.data_dir()
    traffic = load_json(files / "traffic" / f"{wl['traffic']}.json")
    limits = load_json(files / "limits" / f"{workload}.json")
    model_ref = reference.ModelRef(load_module(cfg_path.with_suffix(".py"), f"cfg_{wl['config']}"), cfg)

    inputs = bench_inputs.make_inputs(cfg, seed, device)
    ds = bench_inputs.bench_dataset(inputs)
    sample_idx = judge.sample_rows(inputs, seed)
    runner = RUNNERS[traffic["kind"]](cfg, traffic, ds, inputs, model_ref, sample_idx, device, seed)
    try:
        runner.setup()
        sync(device)
        setup_s = time.perf_counter() - t_start
        cuda = device.type == "cuda"
        setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        window_s = runner.window(seconds)
        window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        stats = runner.stats()
        summary = None
        if trace:
            import tracing

            summary = tracing.profile_units(runner.unit, int(traffic["trace_units"]), device,
                                            runner.host_bytes())
        cand = runner.candidate()
    finally:
        runner.close()
    del runner, ds
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    u = sorted(stats["unit_seconds"])
    print(f"setup {setup_s:.3f} s; window {window_s:.3f} s, {len(u)} units: min {u[0]:.4f} median "
          f"{u[len(u) // 2]:.4f} max {u[-1]:.4f} s" + (f"; traced {summary['units']} units in "
          f"{summary['window_s']:.4f} s, trace {summary['tries']} of up to 3" if summary and summary.get("units")
          else ""), file=sys.stderr)
    t_judge = time.perf_counter()
    numbers, unit_errs = judge.judge(cand, model_ref, cfg, inputs, sample_idx, device)
    print(f"judged in {time.perf_counter() - t_judge:.3f} s", file=sys.stderr)
    correct, checks = judge.verdict(numbers, limits)
    print("readings: " + json.dumps({k: v for k, v in numbers.items() if k not in limits}), file=sys.stderr)
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"modules of JAX or the JAX package loaded: {', '.join(found)}")

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    run = SimpleNamespace(
        kind=traffic["kind"], setup_s=setup_s, window_s=window_s, peak_window_bytes=window_peak,
        trace=summary, peaks=roofline.peaks_for(kind),
        spmm=dict(n=inputs.num_nodes, nnz=len(inputs.src) + inputs.num_nodes, d=cfg["num_features"],
                  hops=cfg["model_args"]["prop_steps"]),
        flops=(roofline.job_flops(model_ref.flops_per_row(), cfg, inputs) * stats["units"]
               if traffic["kind"] == "train" else None),
        **stats,
    )
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in man.metrics(workload, group):
        value = load_module(files / "metrics" / f"{m['name']}.py", f"metric_{m['name']}").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    hop_limit = limits.get("hop_err", math.inf)
    failed = sum(e > hop_limit for e in unit_errs)
    if not correct:
        failed = max(failed, 1)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind, "count": chips,
           "memory_peak_bytes": int(max(setup_peak, window_peak))}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    out = {"correct": bool(correct), "attempted": stats["units"], "failed": int(failed), "metrics": metrics,
           "device": dev}
    if trace and summary and summary.get("units"):
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    out["checks"] = checks
    return out

