from sgl_tpu_torch.kernels.sparse import SparseAdj, spmm, spmm_segment  # noqa: F401
from sgl_tpu_torch.kernels.spmm_csr import (  # noqa: F401
    CsrAdj,
    prepare_csr,
    spmm_csr,
    spmm_csr_reference,
)

__all__ = [
    "SparseAdj",
    "CsrAdj",
    "prepare_csr",
    "spmm",
    "spmm_csr",
    "spmm_csr_reference",
    "spmm_segment",
]
