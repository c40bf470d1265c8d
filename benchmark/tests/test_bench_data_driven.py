"""A configuration, a traffic mix, a metric and a cell added as files and
entries alone are found by name: no file of the benchmark is edited."""

from __future__ import annotations

import hashlib
import json
import shutil

from bench_tiny import BENCH, REPO, make_tiny_root, run_tiny


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(BENCH.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(BENCH)).encode() + p.read_bytes())
    return h.hexdigest()


def test_new_config_traffic_metric_and_cell_are_found_by_name(tmp_path):
    before = _digest()
    root = make_tiny_root(tmp_path)
    data = root / "benchmark"
    cfg = json.loads((data / "configs/sgc_reddit.json").read_text())
    cfg.update(num_nodes=2000, stored_nonzeros=30000, split=[1000, 400, 600])
    (data / "configs/sgc_other.json").write_text(json.dumps(cfg))
    shutil.copy(data / "configs/sgc_reddit.py", data / "configs/sgc_other.py")
    (data / "traffic/propagate_host.json").write_text(json.dumps(
        {"kind": "preprocess", "adjacency": "held", "features": "host", "trace_units": 1}))
    (data / "metrics/calls_per_s.py").write_text(
        "def read(run):\n    return run.units / run.window_s if run.kind == 'preprocess' else None\n")
    (data / "limits/sgc_other.propagate_host.json").write_text(json.dumps({"hop_err": 1e-5}))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "sgc_other", "source": "https://arxiv.org/abs/1902.07153",
                           "file": "benchmark/configs/sgc_other.json", "reduced": [], "why": "test"})
    man["workloads"].append({"name": "sgc_other.propagate_host", "config": "sgc_other",
                             "traffic": "propagate_host", "chips": 1, "why": "test"})
    man["end_to_end"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher", "bound": 0.05,
                              "source": "host_clock", "workloads": ["sgc_other.propagate_host"]})
    for m in man["end_to_end"]:
        if m["name"] == "preprocess_ms":
            m["workloads"].append("sgc_other.propagate_host")
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    out = run_tiny(root, "sgc_other.propagate_host", seed=77)
    assert out["correct"], out["checks"]
    assert {"calls_per_s", "preprocess_ms", "setup_s"} <= set(out["metrics"])
    assert out["metrics"]["calls_per_s"]["unit"] == "1/s"
    assert _digest() == before
    assert (REPO / "BENCHMARK.json").read_text() != (root / "BENCHMARK.json").read_text()
