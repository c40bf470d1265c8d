"""On the card: every cell at a tiny shape through the port's kernels,
judged against the plain reference, plain and traced.  Skips without a
card; run on the card with ``python -m pytest benchmark/tests -m cuda``."""

from __future__ import annotations

import json
import time

import pytest
import torch

from bench_tiny import REPO, make_tiny_root

WORKLOADS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_on_the_card_at_a_tiny_shape(tmp_path, workload, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import harness

    root = make_tiny_root(tmp_path)
    out = harness.run_cell(root, workload, 2**31 + 9, 0.2, trace, torch.device("cuda", 0), time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["memory_peak_bytes"] > 0
    if trace:
        assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] >= out["device"]["busy_s"]
