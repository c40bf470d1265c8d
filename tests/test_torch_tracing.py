"""The port's spans and counters (``sgl_tpu_torch.utils.profiling``) on the
CPU: nothing recorded, and no clock, range or event touched, while
recording is off; the task loop's and the precompute's span trees under
``recording()``; the host syncs an epoch; the spans in a ``torch.profiler``
trace."""

import collections
import json

import pytest
import torch

from sgl_tpu_torch.datasets.synthetic import PlantedPartition
from sgl_tpu_torch.models import GAMLP, SGC
from sgl_tpu_torch.tasks import NodeClassification
from sgl_tpu_torch.utils import clear_spans, count, profiling, recording, span, spans

TRAIN_BATCH, EVAL_BATCH, EPOCHS = 32, 50, 2


@pytest.fixture(scope="module")
def ds():
    d = PlantedPartition(num_nodes=300, feat_dim=16, p_in=0.08, seed=3)
    # 90 / 60 / 150 rows: 3 train batches, 2 + 3 eval batches an epoch
    assert (len(d.train_idx), len(d.val_idx), len(d.test_idx)) == (90, 60, 150)
    return d


@pytest.fixture(autouse=True)
def empty_store():
    clear_spans()
    yield
    clear_spans()


def _gamlp(ds):
    return GAMLP(prop_steps=3, feat_dim=ds.num_features, output_dim=ds.num_classes, hidden_dim=16, num_layers=2)


def _job(ds, model=None, epochs=EPOCHS):
    return NodeClassification(ds, model or _gamlp(ds), lr=0.01, weight_decay=5e-5, epochs=epochs, device="cpu",
                              seed=7, train_batch_size=TRAIN_BATCH, eval_batch_size=EVAL_BATCH, verbose=False)


def _children(recs):
    out = collections.defaultdict(list)
    for r in recs:
        out[r["parent"]].append(r)
    return out


def _names(recs):
    return [r["name"] for r in recs]


def test_with_recording_off_a_job_keeps_no_span_and_enters_no_range(ds, monkeypatch):
    entered = []

    def counting(name):
        entered.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(profiling, "record_function", counting)
    _job(ds)
    assert spans() == [] and entered == []


def test_span_and_count_touch_no_clock_range_or_event_while_off(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("touched while recording is off")

    monkeypatch.setattr(profiling.time, "perf_counter_ns", refuse)
    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    with span("sgl.off", stream=True, k=1) as rec:
        count("sgl.off.count", 3, kind="read")
    assert rec is None and spans() == []


def test_a_recorded_job_gives_the_task_tree_and_its_host_syncs(ds):
    with recording():
        task = _job(ds)
    recs = spans()
    kids = _children(recs)
    (job,) = kids[None]
    assert job["name"] == "sgl.task.job"
    assert _names(kids[job["id"]]) == ["sgl.precompute"] + ["sgl.task.epoch"] * EPOCHS + ["sgl.task.postprocess"]
    epochs = [r for r in kids[job["id"]] if r["name"] == "sgl.task.epoch"]
    for e, seconds in zip(epochs, task.epoch_seconds):
        train, ev = kids[e["id"]]
        assert (train["name"], ev["name"]) == ("sgl.task.train", "sgl.task.eval")
        assert _names(kids[train["id"]]) == ["sgl.task.batch"] * 3
        assert _names(kids[ev["id"]]) == ["sgl.task.batch"] * (2 + 3)
        # the train span is epoch_seconds' interval, on the same clock reads
        assert (train["end_ns"] - train["start_ns"]) / 1e9 == pytest.approx(seconds, rel=1e-12)
        assert e["start_ns"] <= train["start_ns"] <= train["end_ns"] <= ev["start_ns"] <= ev["end_ns"] <= e["end_ns"]
        under = [train, ev] + kids[train["id"]] + kids[ev["id"]]
        total = collections.Counter()
        for r in under:
            total.update(r["counts"])
        # two reads an epoch, one of the train steps' results and one of
        # the eval sums; the batches are built on the device and wait for
        # nothing
        assert total["sgl.task.host_sync"] == total["sgl.task.host_sync[kind=read]"] == 2
        assert train["counts"] == ev["counts"] == {"sgl.task.host_sync": 1, "sgl.task.host_sync[kind=read]": 1}
        for b in kids[train["id"]] + kids[ev["id"]]:
            assert b["counts"] == {}
    assert all(r["stream_ms"] is None for r in recs)  # no CUDA in use
    assert len({r["id"] for r in recs}) == len(recs)


def test_the_adjacency_is_built_once_and_hit_after(ds):
    model = _gamlp(ds)
    with recording():
        model.preprocess(ds.graph, ds.x, device="cpu")
        first = spans()
        clear_spans()
        model.preprocess(ds.graph, ds.x, device="cpu")
        second = spans()
    for recs, hit in ((first, False), (second, True)):
        kids = _children(recs)
        (root,) = kids[None]
        assert root["name"] == "sgl.precompute"
        adj = [r for r in kids[root["id"]] if r["name"] == "sgl.graph_op.adjacency"]
        assert len(adj) == 1 and adj[0]["attrs"] == {"hit": hit}
        assert _names(kids[adj[0]["id"]]) == ([] if hit else ["sgl.graph_op.build"])
        assert _names(kids[root["id"]]) == ["sgl.graph_op.adjacency", "sgl.graph_op.features"] + ["sgl.graph_op.hop"] * 3


@pytest.mark.parametrize("make, path", [
    (lambda ds: _gamlp(ds), "stacked"),  # learnable: k_hop_propagate
    (lambda ds: SGC(prop_steps=2, feat_dim=ds.num_features, output_dim=ds.num_classes), "aggregated"),
])
def test_one_hop_span_a_hop_on_both_propagation_paths(ds, make, path):
    model = make(ds)
    with recording():
        model.preprocess(ds.graph, ds.x, device="cpu")
    hops = [r for r in spans() if r["name"] == "sgl.graph_op.hop"]
    assert [r["attrs"]["k"] for r in hops] == list(range(1, model.prop_steps + 1))
    assert model.pre_msg_learnable == (path == "stacked")


def test_spans_nest_count_into_the_innermost_and_stay_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "_store", collections.deque(maxlen=3))
    with recording():
        with recording():
            pass
        count("sgl.none")  # no span open: not kept
        with span("sgl.a", tag="x") as a:
            count("sgl.c", 2, kind="read")
            with span("sgl.b"):
                count("sgl.c")
            with span("sgl.b"):
                pass
    with span("sgl.after") as after:
        pass
    assert after is None
    recs = spans()
    assert _names(recs) == ["sgl.b", "sgl.b", "sgl.a"]
    assert recs[0]["parent"] == recs[1]["parent"] == a["id"] and a["parent"] is None
    assert a["attrs"] == {"tag": "x"} and a["counts"] == {"sgl.c": 2, "sgl.c[kind=read]": 2}
    assert recs[0]["counts"] == {"sgl.c": 1}
    with recording():
        for _ in range(5):
            with span("sgl.many"):
                pass
    assert _names(spans()) == ["sgl.many"] * 3


def test_a_profile_turns_recording_on_and_the_trace_shows_the_spans(ds, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    model = _gamlp(ds)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.preprocess(ds.graph, ds.x, device="cpu")
    assert "sgl.precompute" in _names(spans())
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = collections.Counter(e.get("name") for e in events if e.get("cat") == "user_annotation")
    assert names["sgl.precompute"] == 1 and names["sgl.graph_op.hop"] == 3
    assert names["sgl.graph_op.build"] == names["sgl.graph_op.features"] == 1


def test_recording_alone_enters_no_range_and_a_profile_does(monkeypatch):
    from torch.profiler import profile

    entered = []

    def counting(name):
        entered.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(profiling, "record_function", counting)
    with recording():
        with span("sgl.quiet"):
            pass
    assert entered == [] and _names(spans()) == ["sgl.quiet"]
    with profile():
        with span("sgl.loud"):
            pass
    assert entered == ["sgl.loud"]
