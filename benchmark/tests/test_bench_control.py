"""The comparison that decides ``correct`` fails what it must: the control
(the plain reference in TF32 in the program's place) and each fault a cell
can have, planted in the program underneath a whole run.  At a tiny shape
on the CPU, against the committed limits; ``control.py`` reads the same at
the cells' own sizes on the card."""

from __future__ import annotations

import json

import pytest
import torch

from bench_tiny import REPO, make_tiny_root, run_tiny

MAN = json.loads((REPO / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in MAN["workloads"]]
TRAIN = [w for w in WORKLOADS if w.endswith(".train")]
PRECOMPUTE = [w for w in WORKLOADS if w not in TRAIN]


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("variant,workload", [("tf32", w) for w in WORKLOADS] + [("half_batch", w) for w in TRAIN])
def test_control_and_planted_reference_faults_are_not_correct(tiny_root, variant, workload):
    import control

    for seed in (1, 2**31 + 5):
        r = control.control_run(tiny_root, workload, seed, variant, torch.device("cpu"))
        assert not r["correct"], r["numbers"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_sound_f32_reference_in_the_programs_place_is_correct(tiny_root, workload):
    import control

    r = control.control_run(tiny_root, workload, 3, "f32", torch.device("cpu"))
    assert r["correct"], r["numbers"]


def _unchanged_propagation(monkeypatch):
    from sgl_tpu_torch.ops import graph_ops

    monkeypatch.setattr(graph_ops, "spmm", lambda adj, h: h.clone())


def _altered_answer(monkeypatch):
    """One element of every hop's output moved by a thousandth of its
    largest magnitude."""
    from sgl_tpu_torch.ops import graph_ops

    spmm = graph_ops.spmm

    def altered(adj, h):
        y = spmm(adj, h)
        y.view(-1)[y.numel() // 2] += 1e-3 * float(y.abs().max())
        return y
    monkeypatch.setattr(graph_ops, "spmm", altered)


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from sgl_tpu_torch.tasks import node_classification as nc

    make = nc.make_train_step

    def halved(net, optimizer, loss_fn):
        def loss(logits, labels, w):
            w = w.clone()
            w[w.shape[0] // 2:] = 0.0
            return loss_fn(logits, labels, w)
        return make(net, optimizer, loss)
    monkeypatch.setattr(nc, "make_train_step", halved)


FAULTS = ([(w, f) for w in PRECOMPUTE for f in (_unchanged_propagation, _altered_answer)]
          + [(w, f) for w in TRAIN for f in (_state_unchanged, _half_batch, _altered_answer)])


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_a_fault_planted_in_the_program_is_not_correct(tiny_root, monkeypatch, workload, fault):
    fault(monkeypatch)
    out = run_tiny(tiny_root, workload, seed=2**31 + 7)
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1
