"""The program's own spans and counters (``sgl_tpu_torch.utils.profiling``)
as the traced sub-window left them: recording is on while a
``torch.profiler`` profile collects, so the traced units' spans are in the
program's store when the readers run.  A unit's root is the span with no
parent that its kind opens: ``sgl.precompute`` (a ``preprocess`` call) or
``sgl.task.job`` (a ``train`` job).  A program without the span API, or a
trace that did not see the card, gives every reader nothing."""

from __future__ import annotations

ROOTS = {"preprocess": "sgl.precompute", "train": "sgl.task.job"}


def unit_trees(run, kind: str):
    """``[(root, records under it)]`` of the last ``run.trace["units"]``
    roots, for a run of ``kind`` whose trace saw the card; else None."""
    if run.kind != kind or not run.trace or not run.trace.get("busy_s"):
        return None
    from sgl_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):  # a program from before the span API
        return None
    records = profiling.spans()
    units = int(run.trace["units"])
    roots = [r for r in records if r["name"] == ROOTS[kind] and r["parent"] is None][-units:]
    if len(roots) < units:
        return None
    children: dict = {}
    for r in records:
        children.setdefault(r["parent"], []).append(r)
    return [(root, below(children, root["id"])) for root in roots]


def below(children: dict, rid) -> list:
    """Every record under the span ``rid``."""
    out, todo = [], [rid]
    while todo:
        for c in children.get(todo.pop(), ()):
            out.append(c)
            todo.append(c["id"])
    return out


def host_ms(r) -> float:
    return (r["end_ns"] - r["start_ns"]) / 1e6


def per_epoch(run, measure):
    """``measure(epoch, records under it)`` summed over the traced jobs'
    epochs, over their number; None without a traced job."""
    trees = unit_trees(run, "train")
    if not trees:
        return None
    total, epochs = 0.0, 0
    for _, recs in trees:
        children: dict = {}
        for r in recs:
            children.setdefault(r["parent"], []).append(r)
        for e in (r for r in recs if r["name"] == "sgl.task.epoch"):
            total += measure(e, below(children, e["id"]))
            epochs += 1
    return total / epochs if epochs else None


def stream_ms_per_call(run, name: str, cold: bool):
    """Stream ms of the ``name`` spans of a traced ``preprocess`` call,
    the mean over the calls; None without a traced call, where a stream
    time is missing, or where the calls built their adjacency (``cold``)
    and these did not, or the other way round."""
    trees = unit_trees(run, "preprocess")
    if not trees:
        return None
    total = 0.0
    for _, recs in trees:
        if any(r["name"] == "sgl.graph_op.build" for r in recs) != cold:
            return None
        times = [r["stream_ms"] for r in recs if r["name"] == name]
        if not times or None in times:
            return None
        total += sum(times)
    return total / len(trees)
