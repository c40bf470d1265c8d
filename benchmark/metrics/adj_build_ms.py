"""The program's stream ms of a cold call's adjacency build (the
sgl.graph_op.build span: the edges' upload, degrees, normalization, the
stable sort and prepare_csr), the mean over the traced calls."""

import program_spans as ps


def read(run):
    return ps.stream_ms_per_call(run, "sgl.graph_op.build", cold=True)
