"""The traced sub-window: ``torch.profiler`` over a few units of work, with
the benchmark's spans around the calls into the program's layers, reduced
to a summary (device time by kernel and by kind, the card's busy time and
the idle gaps named by what the host was doing).

The device-event reading is a copy of ``sgl_tpu_torch/dev/ooc_probe.py``'s
``device_events`` and ``busy_ms``: the first profiled step is the
profiler's warm-up and its events are dropped, since a trace that starts
with a call misses its first copies on the card.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import tempfile
from unittest import mock

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
UNIT_SPAN = "bench.unit"


def union_us(intervals) -> float:
    """Microseconds covered by the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _spanned(name: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


def _spanned_iter(name: str, fn):
    """A generator function whose every step runs inside a span."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        it = fn(*args, **kwargs)
        while True:
            with torch.profiler.record_function(name):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item
    return wrapper


@contextlib.contextmanager
def layer_spans():
    """Spans around the calls into the program's layers, from the
    benchmark's side (each patch is undone on exit)."""
    from sgl_tpu_torch.datasets.base import NodeDataset
    from sgl_tpu_torch.graph import normalize
    from sgl_tpu_torch.models.base import SGAPModel
    from sgl_tpu_torch.ops import graph_ops
    from sgl_tpu_torch.tasks import node_classification as nc

    def step_factory(name, make):
        @functools.wraps(make)
        def wrapped(*args, **kwargs):
            return _spanned(name, make(*args, **kwargs))
        return wrapped

    targets = [
        (nc.NodeClassification, "__init__", "NodeClassification"),
        (nc.NodeClassification, "_postprocess", "task.postprocess"),
        (SGAPModel, "preprocess", "preprocess"),
        (SGAPModel, "postprocess", "postprocess"),
        (normalize, "_with_self_loops", "normalize.edges_upload_degrees"),
        (normalize, "_sorted_adj", "normalize.sort"),
        (graph_ops, "prepare_csr", "prepare_csr"),
        (graph_ops, "_as_compute_dtype", "features.to_device"),
        (graph_ops, "spmm", "spmm"),
        (NodeDataset, "to_device", "dataset.to_device"),
    ]
    with contextlib.ExitStack() as stack:
        for owner, attr, name in targets:
            stack.enter_context(mock.patch.object(owner, attr, _spanned(name, getattr(owner, attr))))
        for attr, name in (("make_train_step", "train_step"), ("make_eval_step", "eval_step"),
                           ("make_logits_fn", "postprocess.logits")):
            stack.enter_context(mock.patch.object(nc, attr, step_factory(name, getattr(nc, attr))))
        stack.enter_context(mock.patch.object(nc, "batch_iterator", _spanned_iter("batch_iterator",
                                                                                   nc.batch_iterator)))
        yield


def profile_units(run_unit, units: int, device, want_h2d_bytes: int = 0, tries: int = 3) -> dict:
    """:func:`summarize` of a trace of ``units`` units of ``run_unit()``
    (which ends in a synchronize), each inside a ``bench.unit`` span,
    after a warm-up unit.  A trace whose host-to-card copies carry fewer
    than ``want_h2d_bytes`` a unit (the bytes the benchmark hands the
    program on the host) has lost events and is taken again, up to
    ``tries`` times; ``tries`` in the summary says how many were taken."""
    for k in range(1, tries + 1):
        s = _profile_once(run_unit, units, device)
        if device.type != "cuda" or s.get("h2d_bytes", 0) >= want_h2d_bytes * units:
            break
    return dict(s, tries=k)


def _profile_once(run_unit, units: int, device) -> dict:
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with layer_spans(), profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=units, repeat=1)) as prof:
        for _ in range(units + 1):
            with torch.profiler.record_function(UNIT_SPAN):
                run_unit()
            prof.step()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return summarize(events, units)


def _short(name: str) -> str:
    return re.sub(r"\s+", " ", name)[:120]


def _innermost(spans, t):
    """The shortest span ``(start, end, name)`` that holds time ``t``."""
    best = None
    for a, b, name in spans:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else None


def summarize(events, units: int) -> dict:
    """The traced window's device events ``(cat, name, start us, end us)``
    clipped to it, the ten device operations of most time and the ten
    longest idle gaps named ``span > host op``, the busy and window
    seconds, and the bytes its host-to-card copies carried."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e and "ts" in e]
    dev = [(e["cat"], e.get("name", ""), float(e["ts"]), float(e["ts"]) + float(e["dur"]),
            int(e.get("args", {}).get("bytes", 0))) for e in complete if e.get("cat") in DEVICE_CATS]
    # the profiled units: the host's last ``units`` unit spans (a warm-up
    # step's span, where the trace keeps one, comes first; the trace also
    # mirrors each span on the device's timeline, as gpu_user_annotation)
    unit_spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in complete
                        if e.get("name") == UNIT_SPAN and e.get("cat") == "user_annotation")[-units:]
    if not unit_spans:
        return {"units": 0}
    lo, hi = min(a for a, _ in unit_spans), max(b for _, b in unit_spans)
    h2d_bytes = sum(nb for c, n, a, b, nb in dev if c == "gpu_memcpy" and "HtoD" in n and b > lo and a < hi)
    dev = [(c, n, max(a, lo), min(b, hi)) for c, n, a, b, _ in dev if b > lo and a < hi]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "")) for e in complete
             if e.get("cat") == "user_annotation" and e.get("name") != UNIT_SPAN
             and not e.get("name", "").startswith("ProfilerStep")]
    ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "")) for e in complete
           if e.get("cat") == "cpu_op"]
    by_name: dict = {}
    for c, n, a, b in dev:
        key = _short(n) if c == "kernel" else n
        by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e6
    gaps, end = [], lo
    for _, _, a, b in sorted(dev, key=lambda d: d[2]):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    named = []
    for a, b in sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]:
        mid = (a + b) / 2
        label = " > ".join(x for x in (_innermost(spans, mid), _innermost(ops, mid)) if x) or "host (no span)"
        named.append([label, (b - a) / 1e6])

    return {
        "units": units,
        "window_s": (hi - lo) / 1e6,
        "busy_s": union_us([(a, b) for _, _, a, b in dev]) / 1e6,
        "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda p: p[1], reverse=True)[:10],
        "idle_gaps": named,
        "device_events": dev,
        "h2d_bytes": h2d_bytes,
    }


def device_seconds_per_unit(summary: dict, cat: str, pattern: str):
    """Seconds a traced unit spends in device events of kind ``cat``
    (``kernel``, ``gpu_memcpy``, ``gpu_memset``) whose name matches
    ``pattern``; None without a trace that saw the device."""
    if not summary or not summary.get("busy_s"):
        return None
    rx = re.compile(pattern)
    return sum(b - a for c, n, a, b in summary["device_events"] if c == cat and rx.search(n)) / 1e6 / summary["units"]


def idle_share(summary: dict):
    """Percent of the traced window with no kernel, copy or memset on the
    card; None without a trace that saw the device."""
    if not summary or not summary.get("busy_s"):
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
