"""Timing and tracing — counterpart of ``sgl_tpu/utils/profiling.py``.

* :class:`StageTimer`: wall-clock seconds per named stage (the NAS
  objective and the tasks' printouts read it);
* :func:`sync`: wait for the device work behind a result;
* :func:`slope_time`: per-iteration time by the two-point slope, CUDA
  events on the card;
* :func:`torch_trace`: a ``torch.profiler`` trace into a directory, the
  counterpart of ``xla_trace``.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch


@dataclass
class StageTimer:
    """Accumulates wall-clock seconds per named stage."""

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
