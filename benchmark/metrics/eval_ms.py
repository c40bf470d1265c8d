"""The program's host ms of an epoch's eval (the sgl.task.eval span: the
eval of the validation and the test rows), the mean over the traced job's
epochs."""

import program_spans as ps


def read(run):
    return ps.per_epoch(run, lambda epoch, recs: sum(ps.host_ms(r) for r in recs if r["name"] == "sgl.task.eval"))
