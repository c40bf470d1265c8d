"""The yardstick's arithmetic: the card's peaks, an SpMM's least time and
the model FLOPs of the rows jobs ran.

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
    on a card without published peaks or for inputs of no one graph."""
    if run.peaks is None or run.spmm is None:
        return None
    sp = run.spmm
    return sp["hops"] * spmm_least_seconds(run.peaks, sp["n"], sp["nnz"], sp["d"])


def job_flops(flops_per_row: int, rows: dict) -> int:
    """The model FLOPs of the rows that jobs' steps ran (``rows``, as
    ``harness.JobRecorder`` counts them, padded tails included): each train
    row forward and backward, three forwards' worth, each eval row and
    each row of a forward over every row one."""
    return (3 * rows["train"] + rows["eval"] + rows["forward"]) * flops_per_row
