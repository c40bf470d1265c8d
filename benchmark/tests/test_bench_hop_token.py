"""The three readers of the hop-token transformer's spans and counter
(``hop_attn_ms``, ``hop_ffn_ms``, ``hop_attn_roofline``) on hand-built span
stores and fake runs: what they read, what they leave out, and that each
gives nothing where the program has no such span or counter, off the card,
or without a configuration of the transformer's shape in ``run.cfg``; and
that a run hands every reader its cell's configuration."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from bench_tiny import BENCH, REPO, make_tiny_root, run_tiny

import harness
from sgl_tpu_torch.utils import profiling

PEAKS = {"f32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}
ARGS = {"prop_steps": 7, "hidden_dim": 512, "num_heads": 8, "num_layers": 1}


def module(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py", f"metric_{name}")


class Store:
    def __init__(self):
        self.records, self.ids = [], 0

    def add(self, name, parent, stream_ms=None, counts=None):
        self.ids += 1
        r = dict(id=self.ids, name=name, parent=parent and parent["id"], start_ns=self.ids, end_ns=self.ids + 1,
                 attrs={}, counts=counts or {}, stream_ms=stream_ms)
        self.records.append(r)
        return r

    def forwards(self, parent, n, tokens, kind, attn, ffn, spans=True):
        parent["counts"]["sgl.hop_tokens"] = parent["counts"].get("sgl.hop_tokens", 0) + n * tokens
        key = f"sgl.hop_tokens[kind={kind}]"
        parent["counts"][key] = parent["counts"].get(key, 0) + n * tokens
        for _ in range(n if spans else 0):
            self.add("sgl.hop_token.attention", parent, attn)
            self.add("sgl.hop_token.ffn", parent, ffn)
            self.add("sgl.hop_token.readout", parent, 0.01)

    def job(self, epochs=2, attn=1.0, ffn=2.0, spans=True):
        """Epochs of 3 train forwards of 8,000 tokens and 2 eval forwards
        of 800,000, then a postprocess of 4 forwards."""
        job = self.add("sgl.task.job", None)
        for _ in range(epochs):
            e = self.add("sgl.task.epoch", job)
            self.forwards(self.add("sgl.task.train", e), 3, 8_000, "train", attn, ffn, spans)
            self.forwards(self.add("sgl.task.eval", e), 2, 800_000, "eval", attn and 50 * attn, ffn and 50 * ffn,
                          spans)
        self.forwards(self.add("sgl.task.postprocess", job), 4, 800_000, "eval", 99.0, 99.0, spans)


@pytest.fixture
def store(monkeypatch):
    s = Store()
    monkeypatch.setattr(profiling, "spans", lambda: list(s.records))
    return s


def fake_run(busy=0.5, peaks=PEAKS, args=ARGS):
    return SimpleNamespace(kind="train", trace={"units": 1, "busy_s": busy, "window_s": 1.0}, peaks=peaks,
                           cfg={"model_args": args})


def test_the_sublayer_times_are_the_epochs_spans_a_mean_epoch(store):
    store.job(epochs=1, attn=9.0, ffn=9.0)  # an earlier job
    store.job(epochs=2, attn=1.0, ffn=2.0)
    # an epoch: 3 train forwards, 2 eval forwards at 50 times the ms; the postprocess is no epoch's
    assert module("hop_attn_ms").read(fake_run()) == pytest.approx(3 * 1.0 + 2 * 50.0)
    assert module("hop_ffn_ms").read(fake_run()) == pytest.approx(3 * 2.0 + 2 * 100.0)


def test_the_roofline_counts_the_work_from_the_tokens_and_the_widths(store):
    store.job(epochs=2, attn=1.0)
    m = module("hop_attn_roofline")
    h, t = 512, 8
    tokens, train_tokens, spans = 2 * (3 * 8_000 + 2 * 800_000), 2 * 3 * 8_000, 2 * 5
    flops = tokens * (8 * h * h + 4 * t * h)
    nbytes = tokens * h * 8 + spans * 16 * h * h + train_tokens * 8 * t
    assert flops / PEAKS["f32_flops_per_s"] > nbytes / PEAKS["hbm_bytes_per_s"]  # compute-bound
    seconds = 2 * (3 * 1.0 + 2 * 50.0) / 1e3
    assert m.read(fake_run()) == pytest.approx(100 * flops / PEAKS["f32_flops_per_s"] / seconds)
    assert m.least_seconds(ARGS, PEAKS, tokens, train_tokens, spans) == pytest.approx(flops / 67e12)
    # two layers: twice the tokens through the sublayer in twice the spans
    two = dict(ARGS, num_layers=2)
    assert m.least_seconds(two, PEAKS, tokens, train_tokens, 2 * spans) == pytest.approx(2 * flops / 67e12)
    # memory-bound where the card's bandwidth is a thousandth
    slow = dict(PEAKS, hbm_bytes_per_s=3.35e9)
    assert m.least_seconds(ARGS, slow, tokens, train_tokens, spans) == pytest.approx(nbytes / 3.35e9)


@pytest.mark.parametrize("name", ["hop_attn_ms", "hop_ffn_ms", "hop_attn_roofline"])
def test_nothing_to_read_gives_nothing(store, name):
    m = module(name)
    store.job(spans=False)  # a program without the spans: the parent's
    assert m.read(fake_run()) is None
    store.records.clear()
    store.job(attn=None, ffn=None)  # no stream times: off the card
    assert m.read(fake_run()) is None
    store.records.clear()
    store.job()
    assert m.read(fake_run()) is not None
    assert m.read(fake_run(busy=0.0)) is None
    assert m.read(SimpleNamespace(kind="preprocess", trace=fake_run().trace, peaks=PEAKS, cfg={})) is None


def test_the_roofline_reads_nothing_without_peaks_or_the_cells_configuration(store):
    store.job()
    m = module("hop_attn_roofline")
    assert m.read(fake_run()) is not None
    assert m.read(fake_run(peaks=None)) is None
    assert m.read(fake_run(args=None)) is None  # no model_args
    assert m.read(fake_run(args={"prop_steps": 3, "feat_dim": 100})) is None  # another model's


def test_the_roofline_reads_the_widths_of_the_runs_configuration(store):
    """The widths are ``run.cfg``'s, whatever the process's command line
    names: the committed NAGphormer configuration's reading is the formula
    at its widths, and another width reads another share."""
    store.job(epochs=2, attn=1.0)
    m = module("hop_attn_roofline")
    cfg = json.loads((REPO / "benchmark/configs/nagphormer_products.json").read_text())
    run = SimpleNamespace(kind="train", trace=fake_run().trace, peaks=PEAKS, cfg=cfg)
    tokens, train_tokens, spans = 2 * (3 * 8_000 + 2 * 800_000), 2 * 3 * 8_000, 2 * 5
    least = m.least_seconds(cfg["model_args"], PEAKS, tokens, train_tokens, spans)
    assert m.read(run) == pytest.approx(100 * least / (2 * (3 * 1.0 + 2 * 50.0) / 1e3))
    assert m.read(run) == m.read(fake_run(args=cfg["model_args"]))
    wider = dict(cfg, model_args=dict(cfg["model_args"], hidden_dim=1024))
    assert m.read(SimpleNamespace(**dict(vars(run), cfg=wider))) > m.read(run)


def test_every_reader_is_handed_the_cells_configuration(tmp_path):
    """A reader added as a file reads ``run.cfg`` in an in-process run: the
    configuration of the cell, at its tiny shape."""
    root = make_tiny_root(tmp_path)
    (root / "benchmark/metrics/cfg_hops.py").write_text(
        "def read(run):\n    return float(run.cfg['model_args']['prop_steps'])\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["per_layer"].append({"name": "cfg_hops", "unit": "count", "better": "lower", "source": "program_span",
                             "layer": "test", "moves": "epoch_ms"})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    for workload in ("nagphormer_products.train", "sgc_reddit.preprocess"):
        cfg = json.loads((root / man["configs"][[c["name"] for c in man["configs"]].index(
            workload.split(".")[0])]["file"]).read_text())
        out = run_tiny(root, workload, seed=2**31 + 3, trace=True)
        assert out["metrics"]["cfg_hops"]["value"] == cfg["model_args"]["prop_steps"]
