"""The out-of-core hop probe (``sgl_tpu_torch/dev/ooc_probe.py``) on the CPU:
the completeness rule of a trace, the host's split of a hop, and the probe
end to end at a small size (the trace itself needs the card)."""

import json

import numpy as np
import pytest
import torch

import sgl_tpu_torch.kernels.spmm_ooc as ooc
from sgl_tpu_torch.datasets import random_power_law_graph
from sgl_tpu_torch.dev import ooc_probe
from sgl_tpu_torch.graph import native, symmetric_normalized_weights_host
from sgl_tpu_torch.kernels import prepare_out_of_core_2d, spmm_out_of_core_2d

# a hop of 100 + 60 bytes whose plain copies take 1.0 ms: copies of 0.5 and
# 0.45 ms, a kernel of 0.2 ms under the first copy and one of 0.3 ms alone
EVENTS = [
    ("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 0.0, 500.0, 100),
    ("kernel", "spmm_csr_acc", 300.0, 200.0, 0),
    ("kernel", "spmm_csr_acc", 500.0, 300.0, 0),
    ("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 800.0, 450.0, 60),
]


def test_summarize_a_complete_trace():
    s = ooc_probe.summarize(EVENTS, (100, 60), 1.0, 2.5)
    assert s["complete"] and s["copies"] == 2 and (s["h2d_bytes"], s["d2h_bytes"]) == (100, 60)
    assert s["copy_ms"] == pytest.approx(0.95) and s["compute_ms"] == pytest.approx(0.5)
    assert s["busy_ms"] == pytest.approx(1.25)
    # 0.2 ms of the 0.5 ms of kernels ran under a copy
    assert s["overlap_share"] == pytest.approx(0.4)
    assert s["idle_share"] == pytest.approx(0.5)


@pytest.mark.parametrize("want, plain_ms", [((101, 60), 1.0), ((100, 61), 1.0), ((100, 60), 1.06)],
                         ids=["h2d_bytes_short", "d2h_bytes_short", "copy_time_short"])
def test_summarize_an_incomplete_trace_measures_no_overlap(want, plain_ms):
    """Fewer bytes than the hop moves each way, or copies faster than 0.9
    of the plain ones allow, mean events are missing: no overlap share."""
    s = ooc_probe.summarize(EVENTS, want, plain_ms, 2.5)
    assert not s["complete"] and s["overlap_share"] is None and s["idle_share"] is None


def _layout():
    g = random_power_law_graph(3_000, 8, 16, seed=0)
    adj = symmetric_normalized_weights_host(g)
    return g, prepare_out_of_core_2d(adj, max_edges_per_part=4096, src_blocks=2, feat_dim=16)


def test_host_split_times_each_step_and_restores_them():
    g, oc = _layout()
    x = np.asarray(g.x, np.float32)
    before = (ooc._new_out, ooc._Pipeline.stage, ooc.PinnedRing.wait, native.gather_rows, ooc.spmm_csr_acc)
    split = ooc_probe.host_split(spmm_out_of_core_2d, oc, x, torch.device("cpu"))
    assert before == (ooc._new_out, ooc._Pipeline.stage, ooc.PinnedRing.wait, native.gather_rows,
                      ooc.spmm_csr_acc)
    steps = split["steps_s"]
    assert {"allocate the output", "stage a workspace", "launch the kernels", "copy a result into the output",
            "the self-loop term"} <= set(steps)
    assert all(v >= 0 for v in steps.values())
    top = sum(v for k, v in steps.items() if not k.startswith(" "))
    assert top <= split["hop_s"] and split["rest_s"] == pytest.approx(split["hop_s"] - top)
    assert split["pretouched_s"] > 0


def test_probe_runs_every_form_on_the_cpu(tmp_path):
    out = tmp_path / "probe.json"
    results = ooc_probe.main(["--device", "cpu", "--n", "4000", "--avg-deg", "8", "--d", "16",
                              "--part-edges", "8192", "--out", str(out)])
    assert [r["form"] for r in results] == [f[0] for f in ooc_probe.FORMS]
    saved = json.loads(out.read_text())
    assert saved["device"] == "host clock, cpu" and len(saved["forms"]) == 4
    for r in results:
        assert "trace" not in r and r["hop_s"] > 0 and r["h2d_bytes"] > 0 and r["d2h_bytes"] > 0
