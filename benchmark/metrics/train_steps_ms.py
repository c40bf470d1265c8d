"""The mean of NodeClassification.epoch_seconds over the window's epochs:
the program's own host clock around an epoch's train steps (ending in
float(loss)), eval excluded."""


def read(run):
    e = getattr(run, "epoch_seconds", None)
    return sum(e) / len(e) * 1e3 if e else None
