"""The program's stream ms of a cold call's hops (the sgl.graph_op.hop
spans: each SpMM with its write into the stack or the sum), the mean over
the traced calls."""

import program_spans as ps


def read(run):
    return ps.stream_ms_per_call(run, "sgl.graph_op.hop", cold=True)
