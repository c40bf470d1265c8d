"""The program's stream ms of a cold call's feature upload (the
sgl.graph_op.features span: x to the card and its cast), the mean over the
traced calls."""

import program_spans as ps


def read(run):
    return ps.stream_ms_per_call(run, "sgl.graph_op.features", cold=True)
