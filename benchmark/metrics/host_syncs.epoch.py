"""The program's count of host syncs an epoch (the sgl.task.host_sync
counter: each blocking read of the steps' results; since the task loop
builds its batches on the card, two an epoch, the train steps' losses and
accuracies and the eval's sums), the mean over the traced job's epochs."""

import program_spans as ps


def read(run):
    return ps.per_epoch(run, lambda epoch, recs: sum(r["counts"].get("sgl.task.host_sync", 0)
                                                     for r in [epoch, *recs]))
