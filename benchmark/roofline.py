"""The yardstick's arithmetic: the card's peaks, an SpMM's least time and a
job's model FLOPs.

The SpMM's least time is ``chip_smoke.py``'s one-shot formula: the larger
of its ``2·E·D`` f32 operations at the f32 peak and its bytes (the row
pointers, the column and weight of each nonzero, ``x`` read and ``y``
written once) at the HBM rate.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def peaks_for(kind: str):
    """The published peaks of the card named ``kind``, or None."""
    return json.loads(PEAKS_FILE.read_text()).get(kind)


def spmm_least_seconds(peaks: dict, n: int, nnz: int, d: int, elem: int = 4) -> float:
    ops = 2 * nnz * d / peaks["f32_flops_per_s"]
    nbytes = 4 * (n + 1) + 8 * nnz + 2 * n * d * elem
    return max(ops, nbytes / peaks["hbm_bytes_per_s"])


def hops_least_seconds(run):
    """The least time of a precompute call's hops (``run.spmm``), or None
    on a card without published peaks."""
    if run.peaks is None:
        return None
    sp = run.spmm
    return sp["hops"] * spmm_least_seconds(run.peaks, sp["n"], sp["nnz"], sp["d"])


def rows_computed(idx_count: int, batch_size) -> int:
    """Rows a pass over ``idx_count`` rows computes in batches of
    ``batch_size`` (the tail padded to a whole batch)."""
    if batch_size is None or batch_size >= idx_count:
        return idx_count
    return -(-idx_count // batch_size) * batch_size


def job_flops(flops_per_row: int, cfg: dict, inputs) -> int:
    """The model FLOPs of one job: each epoch's train rows (forward and
    backward, three forwards' worth) and eval rows, then the forward over
    every node after the last epoch."""
    train = rows_computed(len(inputs.train_idx), cfg["train_batch_size"])
    evals = sum(rows_computed(len(i), cfg["eval_batch_size"]) for i in (inputs.val_idx, inputs.test_idx))
    return (cfg["epochs"] * (3 * train + evals) + inputs.num_nodes) * flops_per_row
