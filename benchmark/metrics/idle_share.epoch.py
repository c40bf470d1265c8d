"""The share of the traced job with no kernel, copy or memset on the card,
in percent."""

import tracing


def read(run):
    return tracing.idle_share(run.trace) if run.kind == "train" else None
