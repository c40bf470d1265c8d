"""The shared upload ring's constants, each timed against other values on
the card.

    python -m sgl_tpu_torch.dev.tune_upload [--out chiprun_out/tune_upload.json]

``utils/transfer.py`` fixes three constants: the bytes of a slot
(``SLOT_BYTES``), the slots of the ring (``SLOTS``) and the bytes below
which a host array keeps the direct copy (``STAGE_MIN_BYTES``).  At the
sizes of a cold precompute of Reddit (an edge array of 114,848,857 int32 or
f32, 459 MB; the features, 232,965 x 602 f32, 561 MB) each (slot bytes,
slots) pair of :data:`GRID` uploads the same pageable host array through a
ring of its own, beside ``torch.as_tensor``'s direct copy and a copy from
pinned memory (what the link allows); then, at small sizes, the direct
copy against the staged one (the threshold); then the four arrays of a cold
call in turn.  Each time is the median host-clock ms of :data:`REPEATS`
calls, each ended by a synchronize; each staged result is held against the
direct copy bit for bit.  First of all, the one-time cost of pinning the
shared ring's slots.

It needs the card, and changes nothing in the package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from sgl_tpu_torch.kernels.spmm_ooc import PinnedRing
from sgl_tpu_torch.utils import transfer

#: (slot MiB, slots) pairs timed at the large sizes
GRID = [(mib, slots) for mib in (8, 16, 32, 64) for slots in (2, 3, 4)]
#: sizes (bytes) of the threshold's sweep
SMALL = [64 << 10, 256 << 10, 1 << 20, 2 << 20, 4 << 20, 8 << 20, 16 << 20]
REPEATS = 7
#: Reddit's stored edges and features (the benchmark's ``sgc_reddit``)
EDGES, NODES, FEATURES = 114_848_857, 232_965, 602


def timed_ms(fn, device, repeats: int = REPEATS) -> float:
    fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(repeats):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def staged(x, device, ring: PinnedRing) -> torch.Tensor:
    return transfer._upload(x, device, None, ring, 0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args(argv)
    device = torch.device("cuda")
    torch.cuda.init()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"card": smi, "host_threads": torch.get_num_threads()}
    print(f"card {smi}; torch threads {out['host_threads']}; host clock, median of {REPEATS}")

    t = time.perf_counter()
    ring = PinnedRing(transfer.SLOTS, transfer.SLOT_BYTES)
    for _ in range(transfer.SLOTS):
        ring.take((transfer.SLOT_BYTES,), torch.uint8)
    out["ring_pin_ms"] = (time.perf_counter() - t) * 1e3
    print(f"pinning the shared ring ({transfer.SLOTS} x {transfer.SLOT_BYTES >> 20} MiB): "
          f"{out['ring_pin_ms']:.2f} ms")

    rng = np.random.default_rng(0)
    arrays = {
        "src_int32": rng.integers(0, NODES, EDGES, dtype=np.int32),
        "val_f32": rng.random(EDGES, dtype=np.float32),
        "x_f32": rng.standard_normal((NODES, FEATURES), dtype=np.float32),
    }
    out["large"] = {}
    for name, a in arrays.items():
        gb = a.nbytes / 1e9
        pinned = torch.from_numpy(a).pin_memory()
        row = {"bytes": a.nbytes,
               "direct_ms": timed_ms(lambda: torch.as_tensor(a, device=device), device),
               "pinned_ms": timed_ms(lambda: pinned.to(device), device)}
        del pinned
        want = torch.as_tensor(a, device=device)
        for mib, slots in GRID:
            r = PinnedRing(slots, mib << 20)
            assert torch.equal(staged(a, device, r), want), (name, mib, slots)
            row[f"{mib}MiBx{slots}"] = timed_ms(lambda: staged(a, device, r), device)
            del r
        del want
        out["large"][name] = row
        best = min((k for k in row if "MiB" in k), key=row.get)
        print(f"{name} ({gb:.3f} GB): direct {row['direct_ms']:.2f} ms ({gb / row['direct_ms'] * 1e3:.2f} GB/s), "
              f"pinned {row['pinned_ms']:.2f} ({gb / row['pinned_ms'] * 1e3:.2f} GB/s), best {best} "
              f"{row[best]:.2f} ({gb / row[best] * 1e3:.2f} GB/s)")
        print("   " + ", ".join(f"{k} {v:.2f}" for k, v in row.items() if "MiB" in k))

    out["small"] = {}
    for nbytes in SMALL:
        a = rng.random(nbytes // 4, dtype=np.float32)
        d = timed_ms(lambda: torch.as_tensor(a, device=device), device, 21)
        s = timed_ms(lambda: staged(a, device, ring), device, 21)
        out["small"][nbytes] = {"direct_ms": d, "staged_ms": s}
        print(f"{nbytes >> 10} KiB: direct {d:.4f} ms, staged {s:.4f} ms")

    def cold_call(up):
        for a in (arrays["src_int32"], arrays["src_int32"], arrays["val_f32"], arrays["x_f32"]):
            up(a)

    out["cold_call"] = {
        "direct_ms": timed_ms(lambda: cold_call(lambda a: torch.as_tensor(a, device=device)), device, 5),
        "to_device_ms": timed_ms(lambda: cold_call(lambda a: transfer.to_device(a, device)), device, 5),
    }
    print("a cold call's four arrays (1.94 GB): direct {direct_ms:.2f} ms, to_device {to_device_ms:.2f} ms"
          .format(**out["cold_call"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
