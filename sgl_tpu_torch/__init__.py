"""sgl_tpu_torch — the SGAP pipeline of ``sgl_tpu`` in PyTorch, for one
NVIDIA Hopper GPU.

The package mirrors ``sgl_tpu``'s layout module for module
(``graph/normalize.py`` ↔ ``sgl_tpu/graph/normalize.py`` and so on) and is
held against it by the ``tests/test_torch_*.py`` parity tests.  Plain tensor
code is PyTorch; the sparse-matrix × dense-feature product that every
propagation hop runs is a CUDA C++ kernel written for ``sm_90a``
(``kernels/csrc/spmm_csr.cu``), built with ``nvcc`` at first use.

Entry points run on the GPU unless the caller passes ``device="cpu"``; with
no CUDA device they raise instead of silently running on the CPU
(:func:`sgl_tpu_torch.device.resolve_device`).  Importing the package needs
no CUDA, no ``nvcc`` and no JAX.
"""

__version__ = "0.1.0"

from sgl_tpu_torch.device import resolve_device  # noqa: F401
from sgl_tpu_torch.graph import Graph  # noqa: F401
