"""The program's host ms of a job outside its epochs (the sgl.task.job span
less its sgl.task.epoch spans: the held precompute with x's upload, the
dataset's move to the card, the parameters' init, the postprocess), the
mean over the traced jobs."""

import program_spans as ps


def read(run):
    trees = ps.unit_trees(run, "train")
    if not trees:
        return None
    return sum(ps.host_ms(job) - sum(ps.host_ms(r) for r in recs if r["name"] == "sgl.task.epoch")
               for job, recs in trees) / len(trees)
