"""A checkout of the benchmark's data files at tiny shapes, for the CPU
tests: the manifest and every configuration's entry into the program,
traffic mix, limit and metric reader as committed, each configuration cut
to a few thousand nodes with its published widths replaced by small ones.  Each configuration brings its
tiny shape as data, ``<config>.tiny.json`` beside its ``<config>.json``,
so one added as files and entries alone is shrunk too."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"
DATA_DIRS = ("configs", "entries", "traffic", "limits", "metrics")  # what a cell's entries name
for p in (str(REPO), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def make_tiny_root(tmp: Path, source: Path = REPO) -> Path:
    """``tmp`` laid out as a checkout: ``BENCHMARK.json`` and the data files
    of ``benchmark/`` as ``source`` holds them, every configuration of the
    manifest updated from its tiny shape (their plain references copied
    beside them).  A configuration without a tiny shape raises: the CPU
    tests never run one at its full size."""
    data = tmp / "benchmark"
    for sub in DATA_DIRS:
        if (source / "benchmark" / sub).is_dir():
            shutil.copytree(source / "benchmark" / sub, data / sub)
    shutil.copy(source / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for entry in json.loads((tmp / "BENCHMARK.json").read_text())["configs"]:
        path = tmp / entry["file"]
        shape = path.with_suffix(".tiny.json")
        if not shape.is_file():
            raise FileNotFoundError(f"configuration {entry['name']!r} has no tiny shape: "
                                    f"{shape.relative_to(tmp)} is missing")
        cfg = json.loads(path.read_text())
        cfg.update(json.loads(shape.read_text()))
        path.write_text(json.dumps(cfg))
    return tmp


def run_tiny(root: Path, workload: str, seed: int = 12345, trace: bool = False) -> dict:
    """One run of ``workload`` on the CPU, past the look for a card."""
    import harness

    return harness.run_cell(root, workload, seed, 0.01, trace, torch.device("cpu"), time.perf_counter())


def job_rows(root: Path, workload: str, seed: int = 5) -> list:
    """The rows a train cell's steps ran (``harness.JobRecorder.rows``)
    after its set-up and after each of two window jobs, on the CPU."""
    import harness
    import judge

    cell = harness.Cell(root, workload)
    cpu = torch.device("cpu")
    inputs = cell.make_inputs(seed, cpu)
    runner = harness.TrainRunner(cell, cell.dataset(inputs), inputs, judge.sample_rows(cell.model_ref, inputs, seed),
                                 cpu, seed)
    try:
        runner.setup()
        out = [runner.stats()["rows"]]
        for _ in range(2):
            runner.unit()
            out.append(runner.stats()["rows"])
        return out
    finally:
        runner.close()
