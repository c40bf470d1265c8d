"""The whole propagation step's share of the card's peak over a held
layout: the SpMM roofline's least time for a call's hops over the call's
measured time (host clock, the window's mean), in percent; the copy of x
into the stack and the allocations count only in the denominator."""

import roofline


def read(run):
    least = roofline.hops_least_seconds(run)
    if run.kind != "preprocess" or not run.units or least is None:
        return None
    return 100.0 * least / (run.window_s / run.units)
