"""A checkout of the benchmark's data files at tiny shapes, for the CPU
tests: the manifest and every traffic mix, limit and metric reader as
committed, each configuration cut to a few thousand nodes with its
published widths replaced by small ones."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"
for p in (str(REPO), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "sgc_reddit": dict(num_nodes=3000, stored_nonzeros=40000, split=[1500, 500, 1000], epochs=4,
                       num_features=24, num_classes=5, model_args=dict(prop_steps=2, feat_dim=24, output_dim=5)),
    "gamlp_products": dict(num_nodes=4000, stored_nonzeros=50000, split=[1800, 700, 1500], epochs=3,
                           train_batch_size=500, eval_batch_size=600, num_features=16, num_classes=6,
                           model_args=dict(prop_steps=3, feat_dim=16, output_dim=6, hidden_dim=32,
                                           num_layers=3, dropout=0.5)),
}


def make_tiny_root(tmp: Path) -> Path:
    """``tmp`` laid out as a checkout: ``BENCHMARK.json`` and the data files
    of ``benchmark/``, the configurations at tiny shapes (their plain
    references copied beside them)."""
    data = tmp / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(BENCH / sub, data / sub)
    for name, shape in TINY.items():
        path = data / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(shape)
        path.write_text(json.dumps(cfg))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return tmp


def run_tiny(root: Path, workload: str, seed: int = 12345, trace: bool = False) -> dict:
    """One run of ``workload`` on the CPU, past the look for a card."""
    import harness

    return harness.run_cell(root, workload, seed, 0.01, trace, torch.device("cpu"), time.perf_counter())
