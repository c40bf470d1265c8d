"""The yardstick's arithmetic against hand counts, the trace reduction on
a made-up trace, and the plain reference's independence from the program
and from JAX."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from bench_tiny import BENCH, REPO

import reference
import roofline
import tracing

PEAKS = {"f32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}


def test_spmm_least_time_against_hand_counts():
    # Reddit: 114,615,892 + 232,965 self loops, D = 602: bound by operations
    n, e, d = 232_965, 114_848_857, 602
    assert roofline.spmm_least_seconds(PEAKS, n, e, d) == pytest.approx(2 * e * d / 67e12)
    assert roofline.spmm_least_seconds(PEAKS, n, e, d) * 1e3 == pytest.approx(2.0639, abs=1e-4)
    # ogbn-products at D = 100: bound by bytes (rowptr, col and weight, x and y)
    n, e, d = 2_449_029, 123_718_280 + 2_449_029, 100
    want = (4 * (n + 1) + 8 * e + 2 * n * d * 4) / 3.35e12
    assert roofline.spmm_least_seconds(PEAKS, n, e, d) == pytest.approx(want)
    # a tiny shape by hand: 3 rows, 4 nonzeros, 2 columns
    assert roofline.spmm_least_seconds(PEAKS, 3, 4, 2) == pytest.approx((16 + 32 + 48) / 3.35e12)
    # a call's hops, none off the card or for inputs of no one graph (a configuration's own)
    run = SimpleNamespace(peaks=PEAKS, spmm=dict(n=3, nnz=4, d=2, hops=2))
    assert roofline.hops_least_seconds(run) == 2 * roofline.spmm_least_seconds(PEAKS, 3, 4, 2)
    assert roofline.hops_least_seconds(SimpleNamespace(peaks=None, spmm=run.spmm)) is None
    assert roofline.hops_least_seconds(SimpleNamespace(peaks=PEAKS, spmm=None)) is None


def test_model_flops_against_hand_counts():
    sgc = json.loads((BENCH / "configs/sgc_reddit.json").read_text())
    gamlp = json.loads((BENCH / "configs/gamlp_products.json").read_text())
    import harness

    sgc_ref = reference.ModelRef(harness.load_module(BENCH / "configs/sgc_reddit.py", "t_sgc"), sgc)
    gamlp_ref = reference.ModelRef(harness.load_module(BENCH / "configs/gamlp_products.py", "t_gamlp"), gamlp)
    assert sgc_ref.flops_per_row() == 2 * 602 * 41
    # gate: the reference and each hop read once (2·4·100 each), the weighted
    # sum 2·4·100; MLP 100→512→512→47
    assert gamlp_ref.flops_per_row() == 3 * 800 + 2 * (100 * 512 + 512 * 512 + 512 * 47)

    # a job at the published split: 4 train batches of 50,000 (196,615 rows,
    # the tail padded), val in one batch, test in 23 of 100,000, 20 epochs,
    # then the postprocess forward over every node
    rows = 20 * (3 * 4 * 50_000 + 39_323 + 23 * 100_000) + 2_449_029
    job = {"train": 20 * 4 * 50_000, "eval": 20 * (39_323 + 23 * 100_000), "forward": 2_449_029}
    assert roofline.job_flops(7, job) == rows * 7


@pytest.mark.parametrize("workload,want", [
    # GAMLP's tiny shape: 3 epochs of 4 train batches of 500 (1,800 rows)
    # and 2 + 3 eval batches of 600 (700 and 1,500 rows), 4,000 nodes
    ("gamlp_products.train", {"train": 3 * 2000, "eval": 3 * 3000, "forward": 4000}),
    # SGC's: 4 full-batch epochs over 1,500 / 500 / 1,000 rows, 3,000 nodes
    ("sgc_reddit.train", {"train": 4 * 1500, "eval": 4 * 1500, "forward": 3000}),
    # NAGphormer's: GAMLP's batches over 2 epochs, the postprocess over
    # 4,000 nodes in pieces of 600
    ("nagphormer_products.train", {"train": 2 * 2000, "eval": 2 * 3000, "forward": 4000}),
])
def test_a_jobs_rows_are_counted_as_its_steps_ran_them(tmp_path, workload, want):
    """The rows whose FLOPs a window counts are those the job's steps ran:
    none of the set-up job's, each of a window job's, padding included;
    the same rows as the count from the configuration's split."""
    from bench_tiny import job_rows, make_tiny_root

    assert job_rows(make_tiny_root(tmp_path), workload) == [dict.fromkeys(want, 0), want,
                                                            {k: 2 * v for k, v in want.items()}]


def test_trace_reduction_on_a_made_up_trace():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": tracing.UNIT_SPAN, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "gpu_user_annotation", "name": tracing.UNIT_SPAN, "ts": 10, "dur": 90},
        {"ph": "X", "cat": "user_annotation", "name": "preprocess", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 40, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "spmm_csr_kernel<float>", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "DeviceRadixSortOnesweepKernel", "ts": 25, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 80, "dur": 30},
    ]
    s = tracing.summarize(ev, 1)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(45e-6)  # 10-35 and 80-100, clipped to the window
    assert tracing.device_seconds_per_unit(s, "kernel", "spmm_csr") == pytest.approx(20e-6)
    assert tracing.device_seconds_per_unit(s, "gpu_memcpy", "HtoD") == pytest.approx(20e-6)
    assert tracing.device_seconds_per_unit(s, "kernel", "(?i)sort|scan") == pytest.approx(10e-6)
    assert s["idle_gaps"][0] == ["preprocess > aten::item", pytest.approx(45e-6)]
    assert [g[1] for g in s["idle_gaps"]] == sorted((g[1] for g in s["idle_gaps"]), reverse=True)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-12, -(1.0 + 2**-10 + 2**-12), 3.0e-5])
    r = reference.tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10 and r[2] == 1.0
    assert r[3] == -(1.0 + 2**-10)
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()


PLAIN = ["reference.py", "judge.py", "roofline.py"] + sorted(  # the test fixtures' configurations too
    p.relative_to(BENCH).as_posix() for pattern in ("configs/*.py", "tests/*/configs/*.py") for p in BENCH.glob(pattern))


@pytest.mark.parametrize("name", PLAIN)
def test_plain_reference_imports_nothing_of_the_program_or_jax(name):
    tree = ast.parse((BENCH / name).read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module.split(".")[0])
    assert not imported & {"sgl_tpu_torch", "sgl_tpu", "jax", "jaxlib", "flax"}, imported


def test_no_module_the_harness_loads_is_jax_or_the_jax_package(tmp_path):
    """A whole tiny run in a fresh process, then its ``sys.modules``."""
    from bench_tiny import make_tiny_root

    root = make_tiny_root(tmp_path)
    code = (
        "import sys, time, torch; sys.path[:0] = [%r, %r]\n"
        "import harness\n"
        "harness.run_cell(__import__('pathlib').Path(%r), 'gamlp_products.train', 3, 0.01, True,"
        " torch.device('cpu'), time.perf_counter())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (str(REPO), str(BENCH), str(root))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(ast.literal_eval(p.stdout.strip().splitlines()[-1]))
    assert "sgl_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "sgl_tpu"}


def test_the_harness_refuses_a_run_that_loaded_jax(monkeypatch):
    import harness

    monkeypatch.setitem(sys.modules, "sgl_tpu", type(sys)("sgl_tpu"))
    assert harness.forbidden_modules() == ["sgl_tpu"]
    monkeypatch.delitem(sys.modules, "sgl_tpu")
    monkeypatch.setitem(sys.modules, "sgl_tpu_torchx", type(sys)("sgl_tpu_torchx"))
    assert harness.forbidden_modules() == []
