"""The window's whole time over the epochs its jobs completed (host clock);
each job's fixed part (preprocess, set-up of the task, postprocess) is in
it, as a user pays it."""


def read(run):
    if run.kind != "train" or not getattr(run, "epochs", 0):
        return None
    return run.window_s / run.epochs * 1e3
