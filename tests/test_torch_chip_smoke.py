"""The host-side helpers of ``chip_smoke.py`` that need no card."""

from chip_smoke import ptxas_summary

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
