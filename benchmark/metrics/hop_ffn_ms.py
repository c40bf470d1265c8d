"""The program's stream ms of an epoch's hop-token FFN sublayers (the
sgl.hop_token.ffn spans of every train and eval forward: the LayerNorm,
both products, the GELU, dropout and residual; forward only), the mean
over the traced job's epochs.  None where a span has no stream time (off
the card) or the program opens no such span."""

import math

import program_spans as ps

NAME = "sgl.hop_token.ffn"


def read(run):
    found = [0]

    def measure(epoch, recs):
        times = [r["stream_ms"] for r in recs if r["name"] == NAME]
        found[0] += len(times)
        return math.nan if None in times else sum(times)

    ms = ps.per_epoch(run, measure)
    return None if ms is None or not found[0] or math.isnan(ms) else ms
