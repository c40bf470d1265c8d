"""The share of a cold call's host-to-card bytes that the program staged
through its ring of pinned slots: the sgl.h2d_bytes counter of kind staged
over the counter's bytes of every kind, in the traced calls' sgl.precompute
trees.  None where the program counts no such bytes (a program without the
counter)."""

import program_spans as ps


def read(run):
    trees = ps.unit_trees(run, "preprocess")
    if not trees:
        return None
    staged = total = 0
    for root, recs in trees:
        for r in [root, *recs]:
            staged += r["counts"].get("sgl.h2d_bytes[kind=staged]", 0)
            total += r["counts"].get("sgl.h2d_bytes", 0)
    return 100.0 * staged / total if total else None
