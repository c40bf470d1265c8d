"""Timing and tracing — counterpart of ``sgl_tpu/utils/profiling.py``.

* :func:`span` and :func:`count`: the program's own spans and counters at
  its layer boundaries (precompute, graph op, task loop), recorded only
  while :func:`recording` is open or a ``torch.profiler`` profile collects;
* :class:`StageTimer`: wall-clock seconds per named stage, the counterpart
  of ``sgl_tpu``'s (nothing in the port reads it);
* :func:`sync`: wait for the device work behind a result;
* :func:`slope_time`: per-iteration time by the two-point slope, CUDA
  events on the card;
* :func:`torch_trace`: a ``torch.profiler`` trace into a directory, the
  counterpart of ``xla_trace``.

An operator sees the spans in two ways.  Inside ``torch_trace(logdir)``
(or any ``torch.profiler`` profile) each span is a ``record_function``
range beside the card's kernels and copies, mirrored onto the device's
timeline, so the trace viewer names idle gaps by the program's spans.
Inside ``with recording():`` (no profiler needed) :func:`spans` returns
the records kept so far::

    with recording():
        NodeClassification(dataset, model, ...)
    for r in spans():
        print(r["name"], r["parent"], (r["end_ns"] - r["start_ns"]) / 1e6, r["counts"])

Each record is a dict: ``id``, ``name``, ``parent`` (the ``id`` of the
span open around it, or None), ``start_ns``/``end_ns`` (host clock,
``time.perf_counter_ns``), ``attrs`` (the span's keyword arguments),
``counts`` (the :func:`count` calls made while it was the innermost open
span, by name and by ``name[key=value]`` for each keyword) and
``stream_ms``: for a span opened with ``stream=True`` while CUDA is in
use, the device time from when the current stream reached its start to
when it reached its end (CUDA events; :func:`spans` resolves them after
one synchronize), else None.  A record is kept when its span closes, so a
child comes before its parent; the store keeps the last ``MAX_SPANS``.

With recording off, :func:`span` and :func:`count` cost one check of two
flags: no clock read, no ``record_function``, no CUDA event, no record.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import statistics
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

#: the most span records kept; the oldest go first
MAX_SPANS = 1 << 16

_recording = 0  # open recording() blocks
_store: collections.deque = collections.deque(maxlen=MAX_SPANS)
_pending: collections.deque = collections.deque(maxlen=MAX_SPANS)  # (record, start event, end event)
_ids = itertools.count()
_local = threading.local()  # .stack: this thread's open span records
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def recording():
    """Record spans and counts inside the block (blocks may nest)."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


class _Span:
    __slots__ = ("name", "stream", "attrs", "record", "_range", "_start")

    def __init__(self, name: str, stream: bool, attrs: dict):
        self.name, self.stream, self.attrs = name, stream, attrs

    def __enter__(self) -> dict:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        # a range only where a profiler collects it: outside one it costs
        # more than the rest of the span and records nothing
        self._range = record_function(self.name) if _autograd_profiler._is_profiler_enabled else None
        if self._range is not None:
            self._range.__enter__()
        self._start = None
        if self.stream and torch.cuda.is_initialized():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self.record = {"id": next(_ids), "name": self.name, "parent": stack[-1]["id"] if stack else None,
                       "start_ns": time.perf_counter_ns(), "end_ns": None, "attrs": self.attrs, "counts": {},
                       "stream_ms": None}
        stack.append(self.record)
        return self.record

    def __exit__(self, *exc) -> None:
        rec = self.record
        rec["end_ns"] = time.perf_counter_ns()
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            _pending.append((rec, self._start, end))
        _local.stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        _store.append(rec)


def span(name: str, stream: bool = False, **attrs):
    """A context manager around one piece of the program's work, recorded
    while recording is on (see the module's docstring) and yielding its
    record, else a no-op yielding None.  While a profiler collects, the
    block is also a ``record_function`` range named ``name``.
    ``stream=True`` also times the current CUDA stream over the block."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, stream, attrs)


def count(name: str, n: int = 1, **attrs) -> None:
    """Add ``n`` to counter ``name`` (and to ``name[key=value]`` for each
    keyword) in the innermost open span's ``counts``, while recording is
    on; a count made with no span open is not kept."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return
    stack = getattr(_local, "stack", None)
    if not stack:
        return
    counts = stack[-1]["counts"]
    counts[name] = counts.get(name, 0) + n
    for k, v in attrs.items():
        key = f"{name}[{k}={v}]"
        counts[key] = counts.get(key, 0) + n


def spans() -> List[dict]:
    """The records kept so far, oldest first, each stream time resolved
    (after one synchronize where any is pending)."""
    if _pending:
        torch.cuda.synchronize()
        while _pending:
            rec, start, end = _pending.popleft()
            rec["stream_ms"] = start.elapsed_time(end)
    return list(_store)


def clear_spans() -> None:
    """Empty the store (and drop the stream times not resolved yet)."""
    _store.clear()
    _pending.clear()


@dataclass
class StageTimer:
    """Accumulates wall-clock seconds per named stage: the counterpart of
    ``sgl_tpu``'s ``StageTimer``, kept for parity; nothing in the port
    reads it (the port's own timing is :func:`span`)."""

    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        return " ".join(f"{k}={v:.4f}s(n={self.counts[k]})" for k, v in self.totals.items())

    def total(self, *names: str) -> float:
        names = names or tuple(self.totals)
        return sum(self.totals.get(n, 0.0) for n in names)


def _first_tensor(out) -> Optional[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for v in out:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def sync(out):
    """Wait until the device that holds ``out`` (a tensor, or the first
    tensor of a dict / list / tuple) has finished its work; returns ``out``.
    On the CPU there is nothing to wait for."""
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
    return out


def slope_time(build_chained: Callable[[int], Callable], k1: int = 6, k2: int = 16, iters: int = 3) -> float:
    """Seconds per iteration by the two-point slope: ``build_chained(k)``
    returns a zero-argument callable that runs the operation ``k`` times in
    a row and returns its result; ``(t(k2) - t(k1)) / (k2 - k1)`` cancels
    the fixed cost of a call.  Each ``t`` is the median of ``iters`` timed
    calls after one warm-up: CUDA events when the result lies on a card,
    else the host clock."""

    def timed(f) -> float:
        out = _first_tensor(sync(f()))
        on_card = out is not None and out.is_cuda
        ts = []
        for _ in range(iters):
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                f()
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                sync(f())
                ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    f1, f2 = build_chained(k1), build_chained(k2)
    return (timed(f2) - timed(f1)) / (k2 - k1)


@contextlib.contextmanager
def torch_trace(logdir: Optional[str] = None):
    """A ``torch.profiler`` trace of the block (the host, and the card when
    CUDA is present) written into ``logdir`` as a Chrome / Perfetto /
    TensorBoard trace; the counterpart of ``sgl_tpu``'s ``xla_trace``.
    Yields the profiler, or None (and traces nothing) without ``logdir``."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
