"""Run one cell of the benchmark once and print its result as the last
line of standard output:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``sgl_tpu_torch``.  It exits
non-zero, with no result, where no CUDA card is present or fewer than the
cell asks for, where the checkout holds no ``sgl_tpu_torch`` of its own,
and where a module of JAX or of the JAX package was loaded.  The numbers
compared, each beside its limit, are the last lines of standard error and
the last key of the result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "benchmark"))
    import torch

    import harness

    try:
        import sgl_tpu_torch
    except ImportError as e:
        print(f"no sgl_tpu_torch in this checkout: {e}", file=sys.stderr)
        return 1
    if ROOT not in Path(sgl_tpu_torch.__file__).resolve().parents:
        print(f"no sgl_tpu_torch in this checkout: it comes from {sgl_tpu_torch.__file__}", file=sys.stderr)
        return 1
    chips = harness.Manifest(ROOT).workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell asks for {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 1
    try:
        out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                               torch.device("cuda", 0), T_START, chips=chips)
    except harness.ForbiddenModules as e:
        print(str(e), file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
