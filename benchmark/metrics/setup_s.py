"""From process start to the window's start: imports, CUDA start, the inputs
drawn on the card, Graph.from_coo, the warm-up (and a first run's build)."""


def read(run):
    return run.setup_s
