"""Each cell end to end at a tiny shape through ``sgl_tpu_torch`` on the
CPU, judged against the plain reference; what the five cells read, held
bit for bit to a record; the traced mode; the run's exits where no card is
present and in a directory that holds only the benchmark."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_tiny import REPO, make_tiny_root, run_tiny

MAN = json.loads((REPO / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in MAN["workloads"]]
# each cell's ``correct``, ``checks`` (values and limits), the judge's other
# readings and the names of the metrics reported, on two seeds, as the
# harness read them before a configuration could bring its own inputs, task
# and reference features; at two torch threads, since the CPU's float sums
# follow the thread count
TINY_READINGS = json.loads((REPO / "benchmark/tests/tiny_readings.json").read_text())


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_correct_at_a_tiny_shape(tiny_root, workload):
    out = run_tiny(tiny_root, workload, seed=2**31 + 11)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    # every end-to-end metric of the cell but the card's memory, which the CPU has not
    want = {m["name"] for m in MAN["end_to_end"] if workload in m.get("workloads", [workload])}
    assert set(out["metrics"]) == want - {"peak_mem_gib"} and "setup_s" in want and len(want) >= 2
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("workload,seed", [(w, s) for w in sorted(TINY_READINGS) for s in sorted(TINY_READINGS[w])])
def test_cell_reads_bit_for_bit_what_it_read_before_the_hooks(tiny_root, workload, seed, capsys):
    """A cell that brings no hooks runs the defaults, which draw the same
    inputs and judge them as before: every number equal, not merely close."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = run_tiny(tiny_root, workload, seed=int(seed))
    finally:
        torch.set_num_threads(threads)
    line = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("readings: ")][-1]
    got = {"correct": out["correct"], "checks": out["checks"], "readings": json.loads(line[len("readings: "):]),
           "metrics": sorted(out["metrics"])}
    assert got == TINY_READINGS[workload][seed]


@pytest.mark.parametrize("workload", ["sgc_reddit.preprocess", "gamlp_products.train"])
def test_traced_run_keeps_correct_and_reads_no_device_number_off_the_card(tiny_root, workload):
    out = run_tiny(tiny_root, workload, seed=5, trace=True)
    assert out["correct"], out["checks"]
    # off the card no reader may give a device number or a share of a peak
    assert set(out["metrics"]) <= {"train_steps_ms"}
    assert ("train_steps_ms" in out["metrics"]) == workload.endswith("train")
    assert len(out["breakdown"]["idle_gaps"]) <= 10 and len(out["breakdown"]["device_ops"]) <= 10


def test_traced_full_batch_cell_reads_its_epoch_time_per_layer(tiny_root):
    out = run_tiny(tiny_root, "sgc_reddit.train", seed=7, trace=True)
    assert out["correct"], out["checks"]
    # its epoch time is a layer's number there; no device number or share off the card
    assert set(out["metrics"]) == {"epoch_ms.full_batch"}
    assert out["metrics"]["epoch_ms.full_batch"]["value"] > 0


def test_same_seed_gives_the_same_inputs():
    import torch

    import inputs as bench_inputs

    cfg = json.loads((REPO / "benchmark/configs/sgc_reddit.json").read_text())
    cfg.update(num_nodes=500, stored_nonzeros=4000, split=[200, 100, 200], num_features=8, num_classes=3)
    a, b = (bench_inputs.make_inputs(cfg, 2**31 + 3, torch.device("cpu")) for _ in range(2))
    for field in ("src", "dst", "x", "y", "train_idx", "val_idx", "test_idx"):
        assert (getattr(a, field) == getattr(b, field)).all()
    assert len(a.src) == cfg["stored_nonzeros"] and (a.src != a.dst).all()


def test_run_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", WORKLOADS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True, env=env,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", WORKLOADS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, env=env,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no sgl_tpu_torch" in p.stderr
