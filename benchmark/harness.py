"""One run of one cell: inputs from the seed, set-up, the measured window,
an optional traced sub-window, the comparison that decides ``correct``
and the metrics.  Everything a cell needs is found by name from
``BENCHMARK.json`` (:class:`Cell`):

* the configuration's ``file`` (``configs/<config>.json``) and the plain
  reference beside it (``configs/<config>.py``), which may bring the
  inputs, the reference's cached features and the rows compared
  (``reference.ModelRef.hook``);
* ``entries/<config>.py``, where present: how the configuration enters the
  program, ``dataset(cfg, inputs)`` (the program's dataset over the
  inputs) and ``task_args(cfg, dataset)`` (task arguments derived from
  it, once in set-up);
* the configuration's ``task`` group, where present: the task class of
  ``sgl_tpu_torch.tasks`` that a train job constructs (``class``) and its
  further keyword arguments (``args``); without it ``NodeClassification``;
* ``traffic/<traffic>.json``: the parameters of the one runner of its
  ``kind`` (``preprocess``: calls of ``SGAPModel.preprocess`` on one
  graph; ``train``: jobs of the configuration's task);
* ``metrics/<metric>.py``: a reader ``read(run) -> float | None``, handed
  the run's namespace, the cell's configuration in it as ``run.cfg``;
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
    """The module of the file ``path`` as ``name``, entered in
    ``sys.modules`` (which a dataclass of the module's looks up)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
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


def _on_path() -> None:
    if str(BENCH_DIR) not in sys.path:
        sys.path.insert(0, str(BENCH_DIR))


class Cell:
    """One workload as its files give it: the manifest's entries, the
    configuration, its traffic, limits and plain reference (``model_ref``)
    and its entry into the program (``entry``, or None), with the hooks
    each may bring and the defaults that stand in for them."""

    def __init__(self, root: Path, workload: str):
        _on_path()
        import reference

        self.root, self.name = Path(root), workload
        self.man = Manifest(self.root)
        self.workload = self.man.workload(workload)
        config = self.workload["config"]
        path = self.root / self.man.config(config)["file"]
        self.cfg = load_json(path)
        self.files = self.man.data_dir()
        self.traffic = load_json(self.files / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(self.files / "limits" / f"{workload}.json")
        self.model_ref = reference.ModelRef(load_module(path.with_suffix(".py"), f"cfg_{config}"), self.cfg)
        entry = self.files / "entries" / f"{config}.py"
        self.entry = load_module(entry, f"entry_{config}") if entry.is_file() else None

    def make_inputs(self, seed: int, device):
        import inputs as bench_inputs

        make = self.model_ref.hook("make_inputs")
        return make(seed, device) if make else bench_inputs.make_inputs(self.cfg, seed, device)

    def dataset(self, inputs):
        import inputs as bench_inputs

        build = getattr(self.entry, "dataset", None)
        return build(self.cfg, inputs) if build else bench_inputs.bench_dataset(inputs)

    def task(self, ds):
        """The train job's task class and its keyword arguments beyond the
        training settings every task takes."""
        from sgl_tpu_torch import tasks

        spec = self.cfg.get("task", {})
        derive = getattr(self.entry, "task_args", None)
        args = dict(spec.get("args", {}), **(derive(self.cfg, ds) if derive else {}))
        return getattr(tasks, spec.get("class", "NodeClassification")), args


def job_seed(seed: int, j: int) -> int:
    return (seed + j) % SEED_SPACE


class JobRecorder:
    """Records, while armed, what the judge reads of one job of a node task
    (``NodeClassification`` or any that reaches the same step factories
    through ``NodeTaskLoop._net_and_steps``): the parameters at its start,
    its first three losses, Adam's first gradient (from its state after
    one step), the parameters after three steps and at its first eval,
    that eval's counts, and the sampled rows of the logits of its last
    forward over every row with the parameters it ran with, where the task
    runs one.  Armed or not, it counts the rows each kind of step runs
    (``rows``: ``train``, ``eval``, ``forward`` over every row), from
    which the window's model FLOPs are counted.  It wraps the task's step
    factories from the benchmark's side."""

    def __init__(self, n_eval_batches: int, num_rows: int, sample_idx):
        self.n_eval, self.num_rows, self.sample_idx = n_eval_batches, num_rows, sample_idx
        self.armed = False
        self.record = None
        self.rows = dict.fromkeys(("train", "eval", "forward"), 0)

    @contextlib.contextmanager
    def installed(self):
        from unittest import mock

        from sgl_tpu_torch.tasks import node_classification as nc

        make_train, make_eval, make_logits = nc.make_train_step, nc.make_eval_step, nc.make_logits_fn
        rec = self

        def params_of(net):
            return {n: p.detach().clone() for n, p in net.named_parameters()}

        def counted(kind, step):
            def run(feats, labels, *a, **k):
                rec.rows[kind] += labels.shape[0]
                return step(feats, labels, *a, **k)
            return run

        def train_factory(net, optimizer, *args, **kwargs):
            step = counted("train", make_train(net, optimizer, *args, **kwargs))
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
            step = counted("eval", make_eval(net, *args, **kwargs))
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

            def recorded(feats):
                out = fn(feats)
                rec.rows["forward"] += out.shape[0]
                if not rec.armed:
                    return out
                r = rec.record
                if "logits_rows" not in r and out.shape[0] == rec.num_rows:
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

    def __init__(self, cell: Cell, ds, inputs, sample_idx, device, seed):
        self.cell, self.cfg, self.traffic, self.model_ref = cell, cell.cfg, cell.traffic, cell.model_ref
        self.ds, self.inputs, self.device, self.seed = ds, inputs, device, seed
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
    """Calls of ``model.preprocess(graph, x)`` on the dataset's one graph,
    each ended by a synchronize (in the window, with ``ahead_s``, sent
    ahead: :meth:`window`).  ``adjacency``: ``cold`` builds a fresh model a call (the
    normalization, the sort and the CSR each time), ``held`` keeps one
    model, whose layout set-up builds.  ``features``: ``host`` passes the
    dataset's numpy ``x`` as the task does, ``card`` a CUDA tensor made in
    set-up."""

    def setup(self) -> None:
        t = self.traffic
        self.feats = self.ds.x if t["features"] == "host" else torch.as_tensor(self.ds.x, device=self.device)
        self.model = self.make_model() if t["adjacency"] == "held" else None
        self.unit()
        self.depth = 0  # calls sent ahead in the window; 0: each waited for
        if t.get("ahead_s") and self.device.type == "cuda":
            s = time.perf_counter()
            self.unit()
            self.depth = max(1, math.ceil(float(t["ahead_s"]) / (time.perf_counter() - s)))
        self.samples.clear()

    def unit(self) -> None:
        if self.traffic["adjacency"] == "cold":
            self.model = None  # the last call's model and its output go first
            self.model = self.make_model()
        self.model.preprocess(self.ds.graph, self.feats, device=self.device)
        sync(self.device)
        self.keep_rows(self.model)

    def window(self, seconds: float) -> float:
        """With the traffic's ``ahead_s`` (on a card): calls dispatched
        without a wait each, the host waiting only for the call sent
        ``depth`` calls before (``ahead_s`` seconds of calls, timed in
        set-up), so that a stall of the host leaves the card fed; each
        call's sampled rows go to pinned host memory without a wait.  When
        the time is up nothing more is sent, all that was sent is waited
        for and the clock is read after that wait.  ``unit_seconds`` are
        then the card's, between the calls' ends."""
        if not self.depth:
            return super().window(seconds)
        ends = [torch.cuda.Event(enable_timing=True)]
        ends[0].record()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.model.preprocess(self.ds.graph, self.feats, device=self.device)
            rows = self.model_ref.rows(self.model.processed_feature, self.sample_idx)
            host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
            self.samples.append(host.copy_(rows, non_blocking=True))
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
            if len(ends) > self.depth + 1:
                ends[-1 - self.depth].synchronize()
        sync(self.device)
        window_s = time.perf_counter() - t0
        self.unit_seconds = [a.elapsed_time(b) / 1e3 for a, b in zip(ends, ends[1:])]
        return window_s

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
    """Back-to-back jobs of the configuration's task (``Cell.task``;
    ``NodeClassification`` by default) at its training settings on one
    held model (its adjacency layout kept, where the task keeps one), job
    ``j`` seeded ``seed + j``; set-up derives the task's arguments and
    runs a one-epoch job, which warms every shape a job uses."""

    def setup(self) -> None:
        val = sum(1 for _ in _batches(self.inputs.val_idx, self.cfg["eval_batch_size"]))
        test = sum(1 for _ in _batches(self.inputs.test_idx, self.cfg["eval_batch_size"]))
        self.recorder = self.patches.enter_context(
            JobRecorder(val + test, self.inputs.num_rows, self.sample_idx).installed())
        self.task_class, self.task_args = self.cell.task(self.ds)
        self.model = self.make_model()
        self.jobs, self.epoch_seconds = 0, []
        self.job(epochs=1, seed=job_seed(self.seed, 999_983))
        self.samples.clear()
        self.epoch_seconds.clear()
        self.recorder.rows = dict.fromkeys(self.recorder.rows, 0)

    def job(self, epochs: int, seed: int):
        c = self.cfg
        task = self.task_class(self.ds, model=self.model, lr=c["lr"], weight_decay=c["weight_decay"],
                               epochs=epochs, device=self.device, seed=seed,
                               train_batch_size=c["train_batch_size"], eval_batch_size=c["eval_batch_size"],
                               verbose=False, **self.task_args)
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
                    epochs=len(self.epoch_seconds), epoch_seconds=list(self.epoch_seconds),
                    rows=dict(self.recorder.rows))

    def host_bytes(self) -> int:
        """Bytes a job hands the program on the host (the inputs' own
        count)."""
        return self.inputs.host_bytes

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
    cell = Cell(root, workload)
    import inputs as bench_inputs
    import judge
    import roofline

    cfg, traffic, limits, model_ref = cell.cfg, cell.traffic, cell.limits, cell.model_ref
    inputs = cell.make_inputs(seed, device)
    ds = cell.dataset(inputs)
    sample_idx = judge.sample_rows(model_ref, inputs, seed)
    runner = RUNNERS[traffic["kind"]](cell, ds, inputs, sample_idx, device, seed)
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
        kind=traffic["kind"], cfg=cfg, setup_s=setup_s, window_s=window_s, peak_window_bytes=window_peak,
        trace=summary, peaks=roofline.peaks_for(kind),
        # the SpMM of a precompute over the default inputs' one graph
        spmm=(dict(n=inputs.num_nodes, nnz=len(inputs.src) + inputs.num_nodes, d=cfg["num_features"],
                   hops=cfg["model_args"]["prop_steps"]) if isinstance(inputs, bench_inputs.Inputs) else None),
        flops=(roofline.job_flops(model_ref.flops_per_row(), stats["rows"]) if traffic["kind"] == "train"
               else None),
        **stats,
    )
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.man.metrics(workload, group):
        value = load_module(cell.files / "metrics" / f"{m['name']}.py", f"metric_{m['name']}").read(run)
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

