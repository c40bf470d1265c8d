"""Host-to-card uploads through a bounded ring of pinned host slots.

``torch.as_tensor(array, device="cuda")`` on a pageable host array is one
synchronous ``cudaMemcpy``: the driver stages it through a small pinned
buffer of its own, on one thread, its host copy and its DMA in turn.
:func:`to_device` gives the same tensor (shape, dtype, bits) for a large
host array by copying it chunk by chunk into a few pinned slots, each with
torch's threaded ``copy_``, and issuing each slot's DMA with
``non_blocking=True`` on the current stream: the host fills one slot while
the copy engine drains another.  A slot is refilled only after the event
recorded behind its last DMA.  The call returns once the last chunk's host
copy is made, so the caller may overwrite or free its array at once; the
result is ordered on the current stream like any other tensor.

The slots are one ring per process (:data:`SLOTS` slots of
:data:`SLOT_BYTES`, pinned at the first large upload and held for the life
of the process), so the pinned memory stays bounded however many uploads
run.  Arrays below :data:`STAGE_MIN_BYTES`, pinned tensors (their copy is
already a DMA), arrays with rows wider than a slot and inputs that are not
host arrays keep ``torch.as_tensor``.

:class:`~sgl_tpu_torch.kernels.spmm_ooc.PinnedRing` is the out-of-core
pipeline's staging too, and the host hop store's.

:func:`to_device_nonblocking` sends a small host array that the host must
not wait for (a batch order an epoch) in one pinned copy.

While recording is on (``utils/profiling.py``) each upload of host data to
a card adds its bytes to the counter ``sgl.h2d_bytes`` of the innermost
open span, with ``kind="staged"``, ``kind="direct"`` or ``kind="pinned"``.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import numpy as np
import torch

from sgl_tpu_torch.kernels.spmm_ooc import PinnedRing
from sgl_tpu_torch.utils.profiling import count

#: bytes of one slot of the shared ring (swept on an H100 by
#: ``python -m sgl_tpu_torch.dev.tune_upload``)
SLOT_BYTES = 32 << 20
#: slots of the shared ring
SLOTS = 2
#: host arrays of fewer bytes keep the direct copy
STAGE_MIN_BYTES = 8 << 20


_ring: Optional[PinnedRing] = None
_ring_lock = threading.Lock()


def to_device(x, device: Union[str, torch.device], dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)``, with a large host
    ``x`` (a numpy array or a CPU tensor) uploaded to a card through the
    process's ring of pinned slots (see the module's docstring).  A dtype
    conversion happens on the host, as the direct copy makes it.  ``x``
    already on ``device``, and any ``x`` for a CPU ``device``, is
    ``torch.as_tensor``'s: no copy where it makes none, and no count.  A
    staged result is row-major (``torch.as_tensor`` keeps the strides of a
    permuted dense tensor)."""
    global _ring
    device = torch.device(device)
    if device.type != "cuda" or (isinstance(x, torch.Tensor) and x.device.type != "cpu"):
        return torch.as_tensor(x, dtype=dtype, device=device)
    with _ring_lock:
        if _ring is None:
            _ring = PinnedRing(SLOTS, SLOT_BYTES)
        return _upload(x, device, dtype, _ring, STAGE_MIN_BYTES)


def to_device_nonblocking(x: np.ndarray, device: Union[str, torch.device]) -> torch.Tensor:
    """``torch.as_tensor(x, device=device)`` for a small host array, without
    the host waiting for the card: ``x`` is copied into a pinned block of
    torch's caching host allocator, which keeps the block until the copy
    issued from it with ``non_blocking=True`` on the current stream has
    run, so the caller may overwrite or drop ``x`` at once.  A CPU
    ``device`` gets ``torch.as_tensor`` and no count."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.as_tensor(x, device=device)
    out = torch.as_tensor(x).pin_memory().to(device, non_blocking=True)
    count("sgl.h2d_bytes", out.nbytes, kind="pinned")
    return out


def _host_source(x):
    """``x`` as a CPU tensor (a view, no copy) or, for a read-only numpy
    array (torch makes no tensor of one without a warning), the array
    itself with its torch dtype; None where torch cannot hold ``x`` without
    a copy (a list, negative strides, a dtype torch lacks)."""
    if isinstance(x, torch.Tensor):
        return x, x.dtype
    if not isinstance(x, np.ndarray):
        return None
    try:
        if x.flags.writeable:
            t = torch.from_numpy(x)
            return t, t.dtype
        return x, torch.from_numpy(np.empty(0, x.dtype)).dtype
    except (TypeError, ValueError):
        return None


def _upload(x, device: torch.device, dtype: Optional[torch.dtype], ring: PinnedRing,
            min_bytes: int) -> torch.Tensor:
    """Host ``x`` on ``device`` (a card; any device in the CPU tests),
    through ``ring`` where it holds at least ``min_bytes`` bytes, else by
    ``torch.as_tensor``; counts the bytes by the path they took."""
    found = _host_source(x)
    if found is not None:
        src, src_dtype = found
        dtype = dtype or src_dtype
        shape = tuple(src.shape)
        row_bytes = int(np.prod(shape[1:])) * dtype.itemsize
        staged = (
            len(shape) > 0
            and shape[0] * row_bytes >= min_bytes
            and row_bytes <= ring.slot_bytes
            and not (isinstance(src, torch.Tensor) and (src.is_pinned() or src.requires_grad))
            # a read-only array is copied by numpy, whose casts are not torch's
            and (isinstance(src, torch.Tensor) or dtype == src_dtype)
        )
        if staged:
            out = torch.empty(shape, dtype=dtype, device=device)
            _staged_copy(out, src, ring)
            count("sgl.h2d_bytes", out.nbytes, kind="staged")
            return out
    out = torch.as_tensor(x, dtype=dtype, device=device)
    count("sgl.h2d_bytes", out.nbytes, kind="direct")
    return out


def _staged_copy(dst: torch.Tensor, src, ring: PinnedRing) -> None:
    """``dst[:] = src`` in chunks of whole rows, each through the next slot
    of ``ring``: the host copy into the slot, then the slot's copy to
    ``dst`` issued on the current stream without waiting for it."""
    per = max(1, ring.slot_bytes // max(1, dst[:1].nbytes))
    stream = torch.cuda.current_stream(dst.device) if dst.is_cuda else None
    for a in range(0, dst.shape[0], per):
        b = min(a + per, dst.shape[0])
        host, k = ring.take((b - a, *dst.shape[1:]), dst.dtype)
        if isinstance(src, np.ndarray):
            np.copyto(host.numpy(), src[a:b])
        else:
            host.copy_(src[a:b])
        dst[a:b].copy_(host, non_blocking=True)
        ring.release(k, stream)
