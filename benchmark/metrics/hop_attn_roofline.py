"""The hop-token attention sublayer's share of its roofline in the traced
job's epochs: its least time over the stream ms of the
sgl.hop_token.attention spans there, in percent.

The least time is counted here, from the cell's configuration (``run.cfg``,
its ``model_args``) and the program's token counter, so the share reads
the same work whatever implements the sublayer: ``T`` tokens a layer (the
sgl.hop_tokens counter, rows × (K+1) a forward, times ``num_layers``),
``h`` wide in ``H`` heads; the larger of its ``8·T·h² + 4·T·(K+1)·h``
FLOPs at the card's f32 peak and its least bytes at the HBM rate:
``T·h·4`` in and out, the ``4h²·4`` bytes of the q/k/v and output weights
a span, and in training ``T·H·(K+1)`` bytes of dropout bits.  None off the
card, without the spans or the counter, or without a configuration of
that shape."""

import program_spans as ps

NAME = "sgl.hop_token.attention"


def least_seconds(args: dict, peaks: dict, tokens: int, train_tokens: int, spans: int) -> float:
    """The least time of ``spans`` attention sublayers over ``tokens``
    tokens a layer, ``train_tokens`` of them in training."""
    h, heads, t = args["hidden_dim"], args["num_heads"], args["prop_steps"] + 1
    n, n_train = args["num_layers"] * tokens, args["num_layers"] * train_tokens
    flops = 8 * n * h * h + 4 * n * t * h
    nbytes = 2 * n * h * 4 + spans * 4 * h * h * 4 + n_train * heads * t
    return max(flops / peaks["f32_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])


def read(run):
    args = run.cfg.get("model_args")
    trees = ps.unit_trees(run, "train")
    if run.peaks is None or not trees or not args or "num_heads" not in args:
        return None
    times, tokens, train_tokens = [], 0, 0
    for _, recs in trees:
        children: dict = {}
        for r in recs:
            children.setdefault(r["parent"], []).append(r)
        for epoch in (r for r in recs if r["name"] == "sgl.task.epoch"):
            under = [epoch, *ps.below(children, epoch["id"])]
            times += [r["stream_ms"] for r in under if r["name"] == NAME]
            tokens += sum(r["counts"].get("sgl.hop_tokens", 0) for r in under)
            train_tokens += sum(r["counts"].get("sgl.hop_tokens[kind=train]", 0) for r in under)
    if not times or None in times or not tokens or not sum(times):
        return None
    return 100.0 * least_seconds(args, run.peaks, tokens, train_tokens, len(times)) / (sum(times) / 1e3)
