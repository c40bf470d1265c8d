"""Device helpers — counterpart of ``sgl_tpu/utils/device.py``, the
reference's ``GpuWithMaxFreeMem``: pick the visible card with the most free
memory."""

from __future__ import annotations

from typing import Optional

import torch

from sgl_tpu_torch.device import resolve_device


def device_with_max_free_mem() -> torch.device:
    """The visible CUDA device with the most free memory
    (``torch.cuda.mem_get_info``).  Raises without CUDA, as
    :func:`~sgl_tpu_torch.device.resolve_device` does: it never hands back
    the CPU in place of a card."""
    resolve_device(None)  # raises when no CUDA device is present
    free = [torch.cuda.mem_get_info(i)[0] for i in range(torch.cuda.device_count())]
    return torch.device("cuda", max(range(len(free)), key=free.__getitem__))


# the reference's name
GpuWithMaxFreeMem = device_with_max_free_mem


def default_backend() -> str:
    """``"cuda"`` when a CUDA device is present, else ``"cpu"``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def num_devices(platform: Optional[str] = None) -> int:
    """Devices of ``platform`` (``"cuda"``/``"gpu"``, or ``"cpu"``); by
    default of :func:`default_backend`.  The CPU counts as one device."""
    platform = platform or default_backend()
    if platform in ("cuda", "gpu"):
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    if platform == "cpu":
        return 1
    raise ValueError(f"unknown platform {platform!r}")
