"""The program's host ms of an epoch's batch preparation (the sgl.task.batch
spans, train and eval: a step of batch_iterator and the upload of the
batch's indices and weights), the mean over the traced job's epochs."""

import program_spans as ps


def read(run):
    return ps.per_epoch(run, lambda epoch, recs: sum(ps.host_ms(r) for r in recs if r["name"] == "sgl.task.batch"))
