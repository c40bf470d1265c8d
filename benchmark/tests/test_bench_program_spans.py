"""The readers of the program's spans and counters (``program_spans.py``
and the eight metrics on it), each on a hand-built span store and a fake
run, and on a tiny traced job on the CPU."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from bench_tiny import BENCH, make_tiny_root, run_tiny

import harness
from sgl_tpu_torch.utils import profiling

TRAIN_METRICS = ("eval_ms", "batch_prep_ms", "host_syncs.epoch", "job_fixed_ms")
PREPROCESS_METRICS = ("adj_build_ms", "feature_upload_ms", "hops_ms.cold", "hops_ms")


def reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py", f"metric_{name}").read


class Store:
    """Records as ``profiling.spans()`` gives them: times in ms, kept when
    a span closes."""

    def __init__(self):
        self.records, self.ids = [], 0

    def add(self, name, parent, start_ms, end_ms, stream_ms=None, counts=None, **attrs):
        self.ids += 1
        r = dict(id=self.ids, name=name, parent=parent and parent["id"], start_ns=int(start_ms * 1e6),
                 end_ns=int(end_ms * 1e6), attrs=attrs, counts=counts or {}, stream_ms=stream_ms)
        self.records.append(r)
        return r

    def job(self, t0, epochs, eval_ms, batch_ms, fixed_ms):
        """A job of ``epochs`` epochs of 10 ms each (two train batches and
        one eval batch of ``batch_ms``, an eval of ``eval_ms``), then
        ``fixed_ms`` outside them."""
        job = self.add("sgl.task.job", None, t0, t0 + epochs * 10 + fixed_ms)
        self.add("sgl.precompute", job, t0, t0 + fixed_ms / 2, stream_ms=1.0)
        t = t0 + fixed_ms / 2
        for _ in range(epochs):
            e = self.add("sgl.task.epoch", job, t, t + 10)
            tr = self.add("sgl.task.train", e, t, t + 4, counts={"sgl.task.host_sync": 4})
            for k in range(2):
                self.add("sgl.task.batch", tr, t + k, t + k + batch_ms, counts={"sgl.task.host_sync": 2})
            ev = self.add("sgl.task.eval", e, t + 5, t + 5 + eval_ms, counts={"sgl.task.host_sync": 2})
            self.add("sgl.task.batch", ev, t + 5, t + 5 + batch_ms, counts={"sgl.task.host_sync": 2})
            t += 10
        self.add("sgl.task.postprocess", job, t, t + fixed_ms / 2)
        return job

    def call(self, t0, cold, build=5.0, features=3.0, hops=(2.0, 4.0)):
        root = self.add("sgl.precompute", None, t0, t0 + 20, stream_ms=20.0)
        adj = self.add("sgl.graph_op.adjacency", root, t0, t0 + 6, hit=not cold)
        if cold:
            self.add("sgl.graph_op.build", adj, t0, t0 + 6, stream_ms=build)
        self.add("sgl.graph_op.features", root, t0 + 6, t0 + 9, stream_ms=features)
        for k, h in enumerate(hops, 1):
            self.add("sgl.graph_op.hop", root, t0 + 9 + k, t0 + 10 + k, stream_ms=h, k=k)


def fake_run(kind, units, busy=0.5):
    return SimpleNamespace(kind=kind, trace={"units": units, "busy_s": busy, "window_s": 1.0})


@pytest.fixture
def store(monkeypatch):
    s = Store()
    monkeypatch.setattr(profiling, "spans", lambda: list(s.records))
    return s


def test_train_readers_read_the_last_job_only(store):
    store.job(0, epochs=3, eval_ms=2.0, batch_ms=0.5, fixed_ms=40)  # an earlier try
    store.job(1000, epochs=2, eval_ms=3.0, batch_ms=0.25, fixed_ms=100)
    run = fake_run("train", 1)
    assert reader("eval_ms")(run) == pytest.approx(3.0)
    assert reader("batch_prep_ms")(run) == pytest.approx(0.75)
    assert reader("host_syncs.epoch")(run) == 12
    assert reader("job_fixed_ms")(run) == pytest.approx(100)


def test_train_readers_average_over_the_traced_jobs(store):
    store.job(0, epochs=1, eval_ms=1.0, batch_ms=0.5, fixed_ms=40)
    store.job(1000, epochs=3, eval_ms=3.0, batch_ms=0.25, fixed_ms=100)
    run = fake_run("train", 2)
    assert reader("eval_ms")(run) == pytest.approx((1.0 + 3 * 3.0) / 4)
    assert reader("job_fixed_ms")(run) == pytest.approx(70)
    assert reader("host_syncs.epoch")(run) == 12
    assert reader("eval_ms")(fake_run("train", 3)) is None  # fewer jobs than units


def test_preprocess_readers_read_the_last_calls_cold_or_held(store):
    store.call(0, cold=True, build=50.0)  # an earlier try
    store.call(100, cold=True, build=5.0, features=3.0, hops=(2.0, 4.0))
    store.call(200, cold=True, build=7.0, features=1.0, hops=(2.0, 2.0))
    run = fake_run("preprocess", 2)
    assert reader("adj_build_ms")(run) == pytest.approx(6.0)
    assert reader("feature_upload_ms")(run) == pytest.approx(2.0)
    assert reader("hops_ms.cold")(run) == pytest.approx(5.0)
    assert reader("hops_ms")(run) is None  # these calls built their adjacency
    store.call(300, cold=False, hops=(3.0, 5.0, 7.0))
    held = fake_run("preprocess", 1)
    assert reader("hops_ms")(held) == pytest.approx(15.0)
    for name in ("adj_build_ms", "feature_upload_ms", "hops_ms.cold"):
        assert reader(name)(held) is None


@pytest.mark.parametrize("name", TRAIN_METRICS + PREPROCESS_METRICS)
def test_no_number_without_a_card_trace_or_for_the_other_kind(store, name):
    store.job(0, epochs=2, eval_ms=1.0, batch_ms=0.5, fixed_ms=40)
    store.call(500, cold=name != "hops_ms")
    kind = "train" if name in TRAIN_METRICS else "preprocess"
    assert reader(name)(fake_run(kind, 1)) is not None
    assert reader(name)(fake_run(kind, 1, busy=0.0)) is None
    assert reader(name)(SimpleNamespace(kind=kind, trace=None)) is None
    assert reader(name)(fake_run("preprocess" if kind == "train" else "train", 1)) is None


@pytest.mark.parametrize("name", TRAIN_METRICS + PREPROCESS_METRICS)
def test_no_number_from_a_program_without_the_span_api(monkeypatch, name):
    monkeypatch.delattr(profiling, "spans")
    kind = "train" if name in TRAIN_METRICS else "preprocess"
    assert reader(name)(fake_run(kind, 1)) is None


def test_a_traced_tiny_job_on_the_cpu_leaves_its_spans_for_the_readers(tmp_path):
    """The traced sub-window turns recording on through the profiler alone:
    the readers find the job's epochs and count 2 host syncs an epoch, the
    train steps' read and the eval's read, whatever the batches (GAMLP's
    tiny shape has 4 train batches, 1,800 rows of 500, and 2 + 3 eval
    batches, 700 and 1,500 rows of 600): the task loop builds its batches
    on the card and reads their results twice an epoch."""
    profiling.clear_spans()
    root = make_tiny_root(tmp_path)
    out = run_tiny(root, "gamlp_products.train", seed=2**31 + 5, trace=True)
    assert out["correct"], out["checks"]
    run = SimpleNamespace(kind="train", trace={"units": 1, "busy_s": 1.0})
    assert reader("host_syncs.epoch")(run) == 2
    for name in ("eval_ms", "batch_prep_ms", "job_fixed_ms"):
        assert reader(name)(run) > 0
    recs = profiling.spans()
    jobs = [r for r in recs if r["name"] == "sgl.task.job"]
    assert len(jobs) == 1 and jobs[0]["parent"] is None  # the profiler's warm-up unit records nothing
    assert not any(r["name"] == "sgl.graph_op.build" for r in recs)  # the held layout
