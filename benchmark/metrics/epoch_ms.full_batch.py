"""What ``epoch_ms`` reads, in the full-batch training cell, where the
host's speed sets it: the window's whole time over the epochs its jobs
completed (host clock), each job's fixed part in it."""


def read(run):
    if run.kind != "train" or not getattr(run, "epochs", 0):
        return None
    return run.window_s / run.epochs * 1e3
