"""Ports of the ``dev/`` harnesses that run TPU kernels D1–D6.

* :mod:`sgl_tpu_torch.dev.exp_spmm` — the SpMM variants of
  ``dev/exp_spmm.py`` that reach D3–D6 (``--check``, ``--perf``,
  ``--micro7``, ``--micro9``), each a PyTorch gather followed by the
  segment-reduce kernel;
* :mod:`sgl_tpu_torch.dev.exp_gather_dma` — D1's gather-rate probe;
* :mod:`sgl_tpu_torch.dev.exp_acc_alias` — D2's accumulate-in-place probe.

Each runs on the GPU unless ``--device cpu`` is given, and imports nothing
of JAX, ``sgl_tpu`` or ``dev/``.  Times are CUDA events on the card and the
host clock on the CPU, and each is printed with the device it ran on.
``chip_smoke.py`` times and compares with the helpers below too.
"""

from __future__ import annotations

import statistics
import time

import torch

#: H100 SXM published HBM3 bandwidth (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12


def device_label(device: torch.device) -> str:
    """Where a time was taken: the card's name, or the host clock."""
    if device.type == "cuda":
        return f"CUDA events, {torch.cuda.get_device_name(device)}"
    return f"host clock, {device.type}"


def time_ms(fn, device: torch.device = None, warmup: int = 3, iters: int = 20) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` runs after ``warmup``:
    CUDA events on the card (the current one when ``device`` is None), the
    host clock elsewhere."""
    device = torch.device("cuda") if device is None else torch.device(device)
    for _ in range(warmup):
        fn()
    times = []
    if device.type != "cuda":
        for _ in range(iters):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)
    torch.cuda.synchronize(device)
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """``(max|got - want|, max|got - want| / max|want|)``, in float64."""
    diff = (got.double() - want.double()).abs().max().item()
    return diff, diff / max(want.double().abs().max().item(), 1e-30)
