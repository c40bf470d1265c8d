"""The window's whole time over the propagation calls (a held layout) it
completed (host clock)."""


def read(run):
    if run.kind != "preprocess" or not run.units:
        return None
    return run.window_s / run.units * 1e3
