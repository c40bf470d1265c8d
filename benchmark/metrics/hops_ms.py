"""The program's stream ms of a call's hops over a held layout (the
sgl.graph_op.hop spans: each SpMM with its write into the stack), the mean
over the traced calls."""

import program_spans as ps


def read(run):
    return ps.stream_ms_per_call(run, "sgl.graph_op.hop", cold=False)
