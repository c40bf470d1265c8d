"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Turn a user's ``device`` argument into a ``torch.device``.

    ``None`` means the GPU: the port is written for it, and a run that
    silently fell back to the CPU would be mistaken for a GPU run.  A CUDA
    device with no CUDA present raises; pass ``device="cpu"`` to run on the
    CPU on purpose.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "sgl_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        # The JAX reference computes its f32 matmuls in full f32; TF32 keeps
        # only ~3 decimal digits, so it stays off on the port's path.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
