from sgl_tpu_torch.kernels.sparse import SparseAdj, spmm, spmm_segment  # noqa: F401
from sgl_tpu_torch.kernels.gather_sum import gather_sum, gather_sum_reference  # noqa: F401
from sgl_tpu_torch.kernels.segment_reduce import (  # noqa: F401
    dst_order,
    segment_reduce,
    segment_reduce_reference,
)
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
    "dst_order",
    "gather_sum",
    "gather_sum_reference",
    "prepare_csr",
    "prepare_csr_parts",
    "segment_reduce",
    "segment_reduce_reference",
    "spmm",
    "spmm_csr",
    "spmm_csr_acc",
    "spmm_csr_acc_reference",
    "spmm_csr_reference",
    "spmm_csr_streaming",
    "spmm_csr_streaming_reference",
    "spmm_segment",
]
