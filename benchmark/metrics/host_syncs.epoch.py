"""The program's count of host syncs an epoch (the sgl.task.host_sync
counter: each blocking read of a loss, an accuracy or an eval sum, and each
pageable upload of a batch's indices or weights), the mean over the traced
job's epochs."""

import program_spans as ps


def read(run):
    return ps.per_epoch(run, lambda epoch, recs: sum(r["counts"].get("sgl.task.host_sync", 0)
                                                     for r in [epoch, *recs]))
