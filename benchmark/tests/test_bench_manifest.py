"""``BENCHMARK.json`` against the contract's shape: names, units, lengths,
the files each entry names, each per-layer metric's ``moves``, and the
run length's budget."""

from __future__ import annotations

import json
import re

import pytest

from bench_tiny import REPO

MAN = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = REPO / MAN["paths"][0]


def _reports(workload: str, metric: dict) -> bool:
    return workload in metric.get("workloads", [workload])


def test_top_level_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MAN)) <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) for p in MAN["paths"])
    assert len(MAN["command"]) <= 32 and all(1 <= len(w) <= 200 for w in MAN["command"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    # a full check of 24 cells fits 43,200 s
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_one_line_texts():
    entries = MAN["configs"] + MAN["workloads"] + MAN["end_to_end"] + MAN["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names)), group
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [e["why"] for e in MAN["configs"] + MAN["workloads"]] + [m["layer"] for m in MAN["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_just_the_contract_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_file_a_name_finds_exists():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        path = REPO / c["file"]
        assert path.is_file() and path.with_suffix(".py").is_file()
        assert str(path.relative_to(REPO)).startswith(MAN["paths"][0] + "/")
        cfg = json.loads(path.read_text())
        assert set(c["reduced"]) <= set(cfg), "every reduced key is in the file"
    for w in MAN["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_every_config_brings_a_tiny_shape_for_the_cpu_tests(config):
    """``<config>.tiny.json`` beside the configuration: a few of its keys,
    ``model_args`` whole, at most 20,000 nodes and 200,000 nonzeros."""
    path = REPO / next(c["file"] for c in MAN["configs"] if c["name"] == config)
    cfg = json.loads(path.read_text())
    tiny = json.loads(path.with_suffix(".tiny.json").read_text())
    assert set(tiny) <= set(cfg)
    assert set(tiny["model_args"]) == set(cfg["model_args"])
    assert tiny["num_nodes"] <= 20_000 and tiny["stored_nonzeros"] <= 200_000


def test_each_cell_reports_setup_another_end_to_end_metric_and_a_layer_metric():
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in MAN["end_to_end"])
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in MAN["end_to_end"] if _reports(w["name"], m)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(_reports(w["name"], m) for m in MAN["per_layer"]), w["name"]


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_moves_names_an_end_to_end_metric_every_cell_of_it_reports(metric):
    m = next(x for x in MAN["per_layer"] if x["name"] == metric)
    target = next(x for x in MAN["end_to_end"] if x["name"] == m["moves"])
    cells = m.get("workloads", [w["name"] for w in MAN["workloads"]])
    assert cells and all(_reports(c, target) for c in cells)
    assert all(c in {w["name"] for w in MAN["workloads"]} for c in cells)


def test_layer_names_agree_and_shares_are_percent():
    by_layer = {}
    for m in MAN["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in by_layer.values())
    # every roofline has a whole step's share of the peak beside it, moving the same metric
    for m in MAN["per_layer"]:
        if "_roofline" in m["name"]:
            assert any("mfu" in x["name"] and x["moves"] == m["moves"] for x in MAN["per_layer"])


def test_four_chip_cells_stay_within_a_quarter():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)
