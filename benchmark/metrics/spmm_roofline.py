"""K1's share of its roofline over a held layout: the SpMM roofline's least
time for a call's hops over the device time of the port's spmm_csr kernels
in a traced call, in percent."""

import roofline
import tracing


def read(run):
    s = tracing.device_seconds_per_unit(run.trace, "kernel", r"spmm_csr")
    least = roofline.hops_least_seconds(run)
    return None if not s or least is None else 100.0 * least / s
