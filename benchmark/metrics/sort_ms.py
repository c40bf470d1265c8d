"""Device time of sort and scan kernels a traced call (the stable argsort of
graph/normalize.py, the row pointers and plan of prepare_csr), by kernel name."""

import tracing


def read(run):
    s = tracing.device_seconds_per_unit(run.trace, "kernel", r"(?i)sort|scan")
    return None if s is None else s * 1e3
