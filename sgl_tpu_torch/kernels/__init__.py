from sgl_tpu_torch.kernels.sparse import SparseAdj, spmm, spmm_segment  # noqa: F401
from sgl_tpu_torch.kernels.spmm_csr import (  # noqa: F401
    CsrAdj,
    CsrPart,
    CsrParts,
    prepare_csr,
    prepare_csr_parts,
    spmm_csr,
    spmm_csr_acc,
    spmm_csr_acc_reference,
    spmm_csr_reference,
    spmm_csr_streaming,
    spmm_csr_streaming_reference,
)

__all__ = [
    "SparseAdj",
    "CsrAdj",
    "CsrPart",
    "CsrParts",
    "prepare_csr",
    "prepare_csr_parts",
    "spmm",
    "spmm_csr",
    "spmm_csr_acc",
    "spmm_csr_acc_reference",
    "spmm_csr_reference",
    "spmm_csr_streaming",
    "spmm_csr_streaming_reference",
    "spmm_segment",
]
