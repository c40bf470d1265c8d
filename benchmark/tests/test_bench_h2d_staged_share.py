"""The reader of ``h2d_staged_share`` (the program's ``sgl.h2d_bytes``
counter) on a hand-built span store and a fake run, as the other readers
of the program's spans are tested."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from sgl_tpu_torch.utils import profiling
from test_bench_program_spans import Store, fake_run, reader


@pytest.fixture
def store(monkeypatch):
    s = Store()
    monkeypatch.setattr(profiling, "spans", lambda: list(s.records))
    return s


def cold_call(store, t0, staged, direct):
    """A cold call whose build counts ``staged`` bytes (the edges) and
    ``direct`` ones, and whose feature upload counts ``staged`` more."""
    def bytes_of(s, d):
        return {"sgl.h2d_bytes": s + d, "sgl.h2d_bytes[kind=staged]": s, "sgl.h2d_bytes[kind=direct]": d}

    root = store.add("sgl.precompute", None, t0, t0 + 20, stream_ms=20.0)
    adj = store.add("sgl.graph_op.adjacency", root, t0, t0 + 6, hit=False)
    store.add("sgl.graph_op.build", adj, t0, t0 + 6, stream_ms=5.0, counts=bytes_of(staged, direct))
    store.add("sgl.graph_op.features", root, t0 + 6, t0 + 9, stream_ms=3.0, counts=bytes_of(staged, 0))
    store.add("sgl.graph_op.hop", root, t0 + 10, t0 + 11, stream_ms=2.0, k=1)


def test_the_staged_share_of_the_last_calls_bytes(store):
    cold_call(store, 0, staged=0, direct=100)  # an earlier try
    cold_call(store, 100, staged=300, direct=100)
    cold_call(store, 200, staged=100, direct=300)
    share = reader("h2d_staged_share")
    assert share(fake_run("preprocess", 1)) == pytest.approx(100 * 200 / 500)
    assert share(fake_run("preprocess", 2)) == pytest.approx(100 * 800 / 1200)
    assert share(fake_run("preprocess", 4)) is None  # fewer calls than units


def test_a_count_on_the_root_span_counts_too(store):
    """The no-graph-op precompute uploads ``x`` inside ``sgl.precompute``
    itself."""
    store.add("sgl.precompute", None, 0, 5, stream_ms=5.0,
              counts={"sgl.h2d_bytes": 40, "sgl.h2d_bytes[kind=staged]": 40})
    assert reader("h2d_staged_share")(fake_run("preprocess", 1)) == pytest.approx(100.0)


def test_no_number_without_counted_bytes_a_card_trace_or_a_preprocess_run(store):
    store.call(0, cold=True)  # spans without the counter: a program from before it
    share = reader("h2d_staged_share")
    assert share(fake_run("preprocess", 1)) is None
    cold_call(store, 100, staged=10, direct=0)
    assert share(fake_run("preprocess", 1)) == pytest.approx(100.0)
    assert share(fake_run("preprocess", 1, busy=0.0)) is None
    assert share(SimpleNamespace(kind="preprocess", trace=None)) is None
    assert share(fake_run("train", 1)) is None


def test_no_number_from_a_program_without_the_span_api(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert reader("h2d_staged_share")(fake_run("preprocess", 1)) is None
