"""Gather-and-sum of feature rows on Hopper: the port of the Pallas kernel
of the ``dev/exp_gather_dma.py`` harness (D1).

``out[1, D] = Σ_e x[src_e]``.  On the TPU this is a probe of the per-row DMA
rate (one DMA per edge into VMEM, ``chunk`` ids per grid step, ``n_flight``
copies outstanding); here it is a plain gather with loads, summed in two
deterministic passes (``csrc/gather_sum.cu``), for any number of edges.

* :func:`gather_sum` — the wrapper: launches the kernels on a CUDA tensor,
  runs :func:`gather_sum_reference` on a CPU tensor, raises on anything
  else;
* :func:`gather_sum_reference` — the plain PyTorch twin.

``gather_sum.launches["f32"]`` counts calls that launched the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sgl_tpu_torch.kernels import _build

#: blocks resident on one SM in the first pass (8 warps each, 2048 threads)
_BLOCKS_PER_SM = 8


def gather_sum_reference(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: ``x.index_select(0, src).sum(0, keepdim=True)``."""
    return x.index_select(0, src.long()).sum(0, keepdim=True)


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signature set."""
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    # src x partial out, e d nb, stream
    return _build.load_entries("gather_sum", {"sgl_gather_sum_f32": [ptr] * 4 + [i64] * 3 + [ptr]})


def gather_sum(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``out[1, D] = Σ_e x[src_e]`` in f32 for f32 ``x [n, D]`` and int32
    ``src [E]``, any ``E``.

    On a CUDA tensor this launches the kernels on the current stream (the
    same bits on every run: no atomics) or raises; on a CPU tensor it runs
    :func:`gather_sum_reference`.  ``src`` must lie in ``[0, n)``: the
    kernel does not check it (that would wait for the card).
    """
    if x.dtype != torch.float32:
        raise TypeError(f"gather_sum takes float32 features, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [n, D] tensor, got {tuple(x.shape)}")
    if src.device != x.device:
        raise ValueError(f"src is on {src.device}, features on {x.device}")
    if src.dtype != torch.int32:
        raise TypeError(f"src must be int32, got {src.dtype}")
    if src.dim() != 1 or not src.is_contiguous():
        raise ValueError(f"src must be a contiguous vector, got {tuple(src.shape)}")
    if x.device.type == "cpu":
        return gather_sum_reference(x, src)
    if x.device.type != "cuda":
        raise ValueError(f"gather_sum runs on CUDA or CPU tensors, got {x.device}")
    e, d = src.shape[0], x.shape[1]
    out = torch.zeros((1, d), dtype=torch.float32, device=x.device)
    if e == 0 or d == 0:
        return out
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    # one wave of resident blocks, at least 64 edges each
    nb = max(1, min(-(-e // 64), sms * _BLOCKS_PER_SM))
    partial = torch.empty((nb, d), dtype=torch.float32, device=x.device)
    _build.call(
        _library(), "sgl_gather_sum_f32", x.device,
        src.data_ptr(), x.data_ptr(), partial.data_ptr(), out.data_ptr(), e, d, nb,
    )
    gather_sum.launches["f32"] += 1
    return out


gather_sum.launches = {"f32": 0}
