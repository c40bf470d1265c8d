"""A configuration, a traffic mix, a metric and a cell added as files and
entries alone are found by name, and a configuration added at its full
size is shrunk by the tiny shape it brings: no file of the benchmark is
edited.  So is a configuration that brings its own inputs, dataset, task
and reference features: NARS_SIGN on a heterogeneous graph
(``nars_fixture/``, laid out as the files it adds under ``benchmark/``)."""

from __future__ import annotations

import hashlib
import json
import shutil

import pytest
import torch

from bench_tiny import BENCH, DATA_DIRS, REPO, job_rows, make_tiny_root, run_tiny


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


HETERO = BENCH / "tests/nars_fixture"


def _checkout_with_the_hetero_config(tmp):
    """A tiny checkout: the committed data files plus ``nars_fixture/``'s
    configuration, plain reference, tiny shape, entry into the program and
    limits, its one cell and the cell in the train metrics' lists."""
    full = tmp / "full"
    for sub in DATA_DIRS:
        if (BENCH / sub).is_dir():
            shutil.copytree(BENCH / sub, full / "benchmark" / sub)
    shutil.copytree(HETERO, full / "benchmark", dirs_exist_ok=True)
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "nars_fixture", "source": "https://arxiv.org/abs/2011.09679",
                           "file": "benchmark/configs/nars_fixture.json", "reduced": [], "why": "test"})
    man["workloads"].append({"name": "nars_fixture.train", "config": "nars_fixture", "traffic": "train", "chips": 1,
                             "why": "test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if m["name"] in ("epoch_ms", "train_steps_ms"):
            m["workloads"].append("nars_fixture.train")
    (full / "BENCHMARK.json").write_text(json.dumps(man))
    return make_tiny_root(tmp / "tiny", source=full)


def test_a_heterogeneous_config_joins_as_files_and_entries_alone(tmp_path):
    """NARS_SIGN over three node types and three relations, features on
    papers alone, three fixed relation subsets: the run builds its own
    inputs, a ``HeteroNodeDataset`` and a ``HeteroNodeClassification`` job,
    records it as the homogeneous jobs, and is judged against the
    reference's ``(K+1, S, N_pred, D)`` stack and steps; the task runs no
    forward over every row, so no ``logits_gap`` is read or limited.  The
    controls: the f32 reference in the program's place is correct, TF32's
    and the half batch's are not."""
    import control

    before = _digest()
    root = _checkout_with_the_hetero_config(tmp_path)
    cfg = json.loads((root / "benchmark/configs/nars_fixture.json").read_text())
    assert cfg["node_types"]["paper"] == 1500 and cfg["model_class"] == "NARS_SIGN"

    out = run_tiny(root, "nars_fixture.train", seed=2**31 + 29)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["checks"]) == {"hop_err", "init_gap", "loss_gap", "grad_gap", "change_gap"}
    assert set(out["metrics"]) == {"epoch_ms", "setup_s"}
    # the FLOPs counted are of the rows the task ran: 2 epochs of 3 train
    # batches of 256 (700 rows) and 1 + 2 eval batches of 400 (300 and 500
    # rows), and no forward over every row
    want = {"train": 2 * 768, "eval": 2 * 1100, "forward": 0}
    assert job_rows(root, "nars_fixture.train") == [dict.fromkeys(want, 0), want, {k: 2 * v for k, v in want.items()}]
    for variant, correct in (("f32", True), ("tf32", False), ("half_batch", False)):
        for seed in (4, 2**31 + 31):
            r = control.control_run(root, "nars_fixture.train", seed, variant, torch.device("cpu"))
            assert r["correct"] is correct, (variant, seed, r["numbers"])
    assert _digest() == before
    assert "nars_fixture" not in (REPO / "BENCHMARK.json").read_text()
