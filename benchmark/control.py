"""The control and the planted faults, read at a cell's own size: the plain
reference put in the program's place and judged as the program is.

    python3 benchmark/control.py --workload <name> --variant tf32 --seeds 1 2 3

``tf32``: the reference in float32 with every product's operands rounded
to TF32 (the precision below the configuration's f32 with TF32 off), the
control that has to come out not correct.  ``half_batch`` (train cells):
the reference in plain float32 whose loss is the mean over the first half
of each batch.  ``f32``: the reference in plain float32, a sound run.
Each seed prints one JSON line: the numbers, the limits and the verdict.
The cell's inputs, reference features and compared rows are reached
through ``harness.Cell`` and the judge, as a run reaches them.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
VARIANTS = {"tf32": ("tf32", False), "half_batch": ("f32", True), "f32": ("f32", False)}


def control_run(root: Path, workload: str, seed: int, variant: str, device) -> dict:
    """The numbers of one control (or fault) run of ``workload``."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    import harness
    import judge

    prec, half = VARIANTS[variant]
    cell = harness.Cell(root, workload)
    cfg, limits, model = cell.cfg, cell.limits, cell.model_ref
    t0 = time.perf_counter()
    inputs = cell.make_inputs(seed, device)
    idx = judge.sample_rows(model, inputs, seed)
    feats = judge.candidate_features(model, inputs, device, prec)
    cand = {"full": feats, "samples": [model.rows(feats, torch.as_tensor(idx, device=device)).cpu()], "train": None}
    if cell.traffic["kind"] == "train":
        r = judge.reference_run(model, cfg, inputs, feats, harness.job_seed(seed, 0), prec, device, idx,
                                half_batch=half)
        cand["train"] = r
    numbers, _ = judge.judge(cand, model, cfg, inputs, idx, device)
    correct, checks = judge.verdict(numbers, limits)
    return {"workload": workload, "variant": variant, "seed": seed, "correct": correct,
            "numbers": numbers, "limits": limits, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Read the control or a planted fault at a cell's own size.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", choices=sorted(VARIANTS), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    device = torch.device(args.device)
    for seed in args.seeds:
        print(json.dumps(control_run(ROOT, args.workload, seed, args.variant, device)), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
