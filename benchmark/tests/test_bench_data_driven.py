"""A configuration, a traffic mix, a metric and a cell added as files and
entries alone are found by name, and a configuration added at its full
size is shrunk by the tiny shape it brings: no file of the benchmark is
edited."""

from __future__ import annotations

import hashlib
import json
import shutil

import pytest

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


# a shape of its own, apart from sgc_reddit's, so the run shows whose was taken
OTHER_TINY = dict(num_nodes=2500, stored_nonzeros=30000, split=[1200, 400, 900], epochs=3, num_features=20,
                  num_classes=4, model_args=dict(prop_steps=2, feat_dim=20, output_dim=4))


def _full_checkout_with_a_config(tmp, name: str, traffic: str, tiny: dict | None):
    """A checkout at full size, as committed, plus the configuration
    ``name`` added as files and entries alone: its ``.json`` copied from
    ``sgc_reddit.json``, its plain reference, its tiny shape unless
    ``tiny`` is None, one cell under ``traffic`` and that cell's limits."""
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(BENCH / sub, tmp / "benchmark" / sub)
    configs = tmp / "benchmark/configs"
    shutil.copy(configs / "sgc_reddit.json", configs / f"{name}.json")
    shutil.copy(configs / "sgc_reddit.py", configs / f"{name}.py")
    if tiny is not None:
        (configs / f"{name}.tiny.json").write_text(json.dumps(tiny))
    shutil.copy(tmp / f"benchmark/limits/sgc_reddit.{traffic}.json", tmp / f"benchmark/limits/{name}.{traffic}.json")
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    man["configs"].append({"name": name, "source": "https://arxiv.org/abs/1902.07153",
                           "file": f"benchmark/configs/{name}.json", "reduced": [], "why": "test"})
    cell = f"{name}.{traffic}"
    man["workloads"].append({"name": cell, "config": name, "traffic": traffic, "chips": 1, "why": "test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if f"sgc_reddit.{traffic}" in m.get("workloads", []):
            m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp


@pytest.mark.parametrize("traffic", ["preprocess", "train"])
def test_a_config_added_at_full_size_runs_at_its_own_tiny_shape(tmp_path, traffic):
    before = _digest()
    full = _full_checkout_with_a_config(tmp_path / "full", "sgc_other", traffic, OTHER_TINY)
    assert json.loads((full / "benchmark/configs/sgc_other.json").read_text())["num_nodes"] > 20_000
    root = make_tiny_root(tmp_path / "tiny", source=full)
    cfg = json.loads((root / "benchmark/configs/sgc_other.json").read_text())
    assert {k: cfg[k] for k in OTHER_TINY} == OTHER_TINY

    out = run_tiny(root, f"sgc_other.{traffic}", seed=2**31 + 19)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert _digest() == before


def test_a_config_without_a_tiny_shape_is_refused(tmp_path):
    full = _full_checkout_with_a_config(tmp_path / "full", "sgc_bare", "preprocess", None)
    with pytest.raises(FileNotFoundError, match="'sgc_bare'"):
        make_tiny_root(tmp_path / "tiny", source=full)
