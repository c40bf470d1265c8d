"""Device time of host-to-card copies a traced call (torch.profiler Memcpy HtoD)."""

import tracing


def read(run):
    s = tracing.device_seconds_per_unit(run.trace, "gpu_memcpy", "HtoD")
    return None if s is None else s * 1e3
