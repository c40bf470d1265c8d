"""The host-side helpers of ``chip_smoke.py`` that need no card."""

import pytest
import torch

from chip_smoke import kernels_line, ptxas_summary, segment_bound
from sgl_tpu_torch.kernels.segment_reduce import INSTANTIATIONS

# ``nvcc -Xptxas -v`` output for two entries of the CSR kernel, one of them
# spilling, with a device function's properties in between
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__8bed0cad_11_spmm_csr_cu_b44ff5c715spmm_csr_kernelI13__nv_bfloat16fLi4ELb1EEEvPKiS3_PKfPKT_PT0_ll' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__8bed0cad_11_spmm_csr_cu_b44ff5c715spmm_csr_kernelI13__nv_bfloat16fLi4ELb1EEEvPKiS3_PKfPKT_PT0_ll
    24 bytes stack frame, 36 bytes spill stores, 40 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 24 bytes cumulative stack size
ptxas info    : Compile time = 52.967 ms
ptxas info    : Function properties for helper
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__8bed0cad_11_spmm_csr_cu_b44ff5c715spmm_csr_kernelIffLi4ELb0EEEvPKiS3_PKfPKT_PT0_ll' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__8bed0cad_11_spmm_csr_cu_b44ff5c715spmm_csr_kernelIffLi4ELb0EEEvPKiS3_PKfPKT_PT0_ll
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 0 barriers
"""


def test_ptxas_summary_reads_registers_and_spills_per_entry():
    assert ptxas_summary(PTXAS_LOG) == [
        "13__nv_bfloat16fLi4ELb1E: 32 registers, spill 36 B stored / 40 B loaded",
        "ffLi4ELb0E: 48 registers, spill 0 B stored / 0 B loaded",
    ]
    assert ptxas_summary("nvcc: nothing compiled\n") == []


def _meta(rows, cols, dtype):
    return torch.empty(rows, cols, dtype=dtype, device="meta")


@pytest.mark.parametrize("key,nbytes", [
    # 4(N+1) + E*W*s_m + E*s_w + N*D*4 (+ N*D*4 read back when accumulating)
    ("bf16_acc", 1_536_795_396), ("bf16_hilo", 2_765_590_788), ("f32", 2_765_590_788),
    ("bf16_hilo_w2", 2_786_390_716), ("f32_w2", 2_786_390_716), ("bf16_w", 1_444_795_360),
])
def test_segment_bound_counts_the_bench_shape_bytes(key, nbytes):
    n, e, d = 200_000, 5_199_982, 128
    dtype, halves, n_w, accumulate, _ = INSTANTIATIONS[key]
    w = _meta(e, 1, torch.bfloat16)[:, 0]
    kw = dict(halves=halves, wh=w if n_w >= 1 else None, wl=w if n_w == 2 else None)
    b = segment_bound(_meta(e, halves * d, dtype), kw, n, d, accumulate)
    assert b["nbytes"] == nbytes and b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_kernels_line_lists_every_instantiation_with_every_key():
    r = dict(abs_err=0.0, rel_err=0.0, ms=1.0, plain_ms=2.0, bound_ms=0.5, bound_by="bytes", library_ms=None)
    two = {"f32": dict(r), "bf16": dict(r)}
    products = {k: dict(r, launches=30) for k in ("f32", "bf16")}
    dev_results = {k: dict(r) for k in [*INSTANTIATIONS, "gather_sum"]}
    dev_launches = {k: 1 for k in dev_results}
    line = kernels_line(two, {"f32": 3, "bf16": 3}, {"f32": (0, 0, 0), "bf16": (0, 0, 0)}, two, products,
                        dev_launches, dev_results)
    kernels = line["kernels"]
    assert len(kernels) == 11 and len({k["name"] for k in kernels}) == 11
    for k in kernels:
        assert {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms"} <= set(k), k
        assert k["route"] == "cuda" and k["launches"] > 0
    assert {k["replaces"].split(":")[0] for k in kernels[4:]} == {
        "dev/exp_acc_alias.py", "dev/exp_spmm.py", "dev/exp_gather_dma.py"}
