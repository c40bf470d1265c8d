"""Where an out-of-core hop's time goes: the host's share split by step, and
the card's own copy and kernel timeline from a trace.

    python -m sgl_tpu_torch.dev.ooc_probe [--out ooc_probe.json]
    python -m sgl_tpu_torch.dev.ooc_probe --device cpu --n 20000 --part-edges 60000

On phase 5's products-scale graph (2.4M nodes, avg degree 25, d = 100,
parts of ``6 << 20`` nonzeros) it builds each layout of ``chip_smoke.py``'s
phase 10 (1-D f32; 2-D f32 and bf16 at ``src_blocks="auto"``; 2-D f32 at
one block), runs one warm hop, then:

* **the host's split** (:func:`host_split`): one hop with a timer on each
  step of ``kernels/spmm_ooc.py``: the output's allocation, the staging of
  each workspace (its wait for a free pinned slot and its host gather
  apart), the kernel launches, the readbacks, the copies of each result
  into the output (its wait for the copy apart), the self-loop term and
  the rest; then a hop into an output that was written once before, whose
  difference is the first touch of a fresh output's pages;
* **the card's timeline** (:func:`device_overlap`, on the card only): a
  ``torch.profiler`` trace of one hop after a warm-up hop, its copies and
  kernels as kineto exports them, with each copy's bytes.  A trace is
  complete only when its copies carry at least the hop's bytes each way
  and take at least 0.9 of a plain pinned ``copy_`` of those bytes; a
  shorter one is missing events.  Up to three traces are taken, and the
  overlap share
  (copy + kernels - busy) / min(copy, kernels) and the card's idle share
  of an untraced hop's host-clock time come only from a complete one.

Times are the host clock (the split) and the trace's own (the timeline),
each printed with the device.  Results go to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import torch

from sgl_tpu_torch.dev import device_label, time_ms

#: A complete trace's copies take at least this share of a plain pinned
#: ``copy_`` of the same bytes: a copy cannot beat the link by more.
COPY_TIME_FLOOR = 0.9

#: (name, layout, dtype, src_blocks): chip_smoke.py phase 10's forms
FORMS = (
    ("1d f32", "1d", torch.float32, None),
    ("2d f32", "2d", torch.float32, "auto"),
    ("2d bf16", "2d", torch.bfloat16, "auto"),
    ("2d f32 src_blocks=1", "2d", torch.float32, 1),
)


def busy_ms(intervals) -> float:
    """Milliseconds covered by the union of ``(start, end)`` intervals (us)."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def device_events(fn) -> list:
    """The device events of one ``fn()`` as ``torch.profiler`` (kineto)
    exports them: ``(category, name, start us, duration us, bytes)`` for
    each copy (``gpu_memcpy``), kernel and memset.  ``fn()`` runs twice:
    the first run is the profiler's warm-up step, whose events are
    dropped, since a trace that starts with ``fn`` misses its first copies
    on the card."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return [(ev["cat"], ev.get("name", ""), float(ev["ts"]), float(ev["dur"]),
             int(ev.get("args", {}).get("bytes", 0)))
            for ev in trace.get("traceEvents", [])
            if ev.get("ph") == "X" and ev.get("cat") in ("gpu_memcpy", "kernel", "gpu_memset")]


def summarize(events, want_bytes, plain_copy_ms: float, wall_ms: float) -> dict:
    """One trace's copy and kernel time, its bytes each way, whether it is
    complete (see the module docstring) and, when it is, the overlap share
    and the card's idle share of ``wall_ms``."""
    copies = [e for e in events if e[0] == "gpu_memcpy"]
    work = [(e[2], e[2] + e[3]) for e in events if e[0] != "gpu_memcpy"]
    h2d = sum(e[4] for e in copies if "HtoD" in e[1])
    d2h = sum(e[4] for e in copies if "DtoH" in e[1])
    copy_sum = sum(e[3] for e in copies) / 1e3
    c = busy_ms([(e[2], e[2] + e[3]) for e in copies])
    w = busy_ms(work)
    both = busy_ms([(e[2], e[2] + e[3]) for e in copies] + work)
    complete = (h2d >= want_bytes[0] and d2h >= want_bytes[1]
                and copy_sum >= COPY_TIME_FLOOR * plain_copy_ms)
    return dict(
        complete=complete, copies=len(copies), h2d_bytes=h2d, d2h_bytes=d2h, copy_sum_ms=copy_sum,
        copy_ms=c, compute_ms=w, busy_ms=both,
        overlap_share=(c + w - both) / min(c, w) if complete and c > 0 and w > 0 else None,
        idle_share=1.0 - both / wall_ms if complete else None,
    )


def device_overlap(fn, want_bytes, plain_copy_ms: float, wall_ms: float, tries: int = 3) -> dict:
    """:func:`summarize` of a trace of one ``fn()`` (``wall_ms``: its host
    clock untraced), traced again (up to ``tries`` times) while the trace is
    incomplete; ``tries`` says how many were taken."""
    for k in range(1, tries + 1):
        s = summarize(device_events(fn), want_bytes, plain_copy_ms, wall_ms)
        if s["complete"]:
            break
    return dict(s, tries=k, wall_ms=wall_ms)


def copy_ms(nbytes: int, to_card: bool, device, chunk: int = 1 << 30) -> float:
    """CUDA-event ms of a plain ``copy_`` of ``nbytes`` between a pinned
    buffer and the card, one way, in pieces of at most ``chunk``."""
    chunk = max(min(nbytes, chunk), 1)
    host = torch.empty(chunk, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(chunk, dtype=torch.uint8, device=device)
    sizes = [chunk] * (nbytes // chunk) + ([nbytes % chunk] if nbytes % chunk else [])

    def run():
        for s in sizes:
            if to_card:
                card[:s].copy_(host[:s], non_blocking=True)
            else:
                host[:s].copy_(card[:s], non_blocking=True)

    return time_ms(run, device, warmup=1, iters=3)


# the steps of a hop that host_split times: (label, owner, attribute)
_STEPS = (
    ("allocate the output", "ooc", "_new_out"),
    ("stage a workspace", "pipe", "stage"),
    ("  host gathers (staging and the self-loop term)", "native", "gather_rows"),
    ("launch the kernels", "ooc", "spmm_csr_acc"),
    ("issue a readback", "pipe", "readback"),
    ("copy a result into the output", "ooc", "_flush_copy"),
    ("copy a result into the output", "ooc", "_flush_add"),
    ("  waits for a copy (staging, readback, result)", "ring", "wait"),
    ("the self-loop term", "ooc", "_apply_diag"),
    ("order the streams at the end", "pipe", "finish"),
)


@contextlib.contextmanager
def _timed_steps(totals: dict):
    """Wrap each step of :data:`_STEPS` with a host-clock timer adding into
    ``totals[label]``; restored on exit."""
    from sgl_tpu_torch.graph import native
    from sgl_tpu_torch.kernels import spmm_ooc

    owners = {"ooc": spmm_ooc, "pipe": spmm_ooc._Pipeline, "ring": spmm_ooc.PinnedRing, "native": native}
    saved = []

    def timed(label, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                totals[label] = totals.get(label, 0.0) + time.perf_counter() - t
        return run

    try:
        for label, owner, attr in _STEPS:
            obj = owners[owner]
            saved.append((obj, attr, getattr(obj, attr)))
            setattr(obj, attr, timed(label, getattr(obj, attr)))
        yield totals
    finally:
        for obj, attr, fn in reversed(saved):
            setattr(obj, attr, fn)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_split(spmm, oc, x_host, device) -> dict:
    """Host-clock seconds of one hop by step (:data:`_STEPS`; an indented
    label is part of the one above it), the rest apart; then the seconds of
    a hop into an output written once before (``pretouched_s``), whose gap
    to ``hop_s`` is the first touch of a fresh output's pages."""
    totals = {}
    _sync(device)
    with _timed_steps(totals):
        t = time.perf_counter()
        out = spmm(oc, x_host, device=device)
        hop = time.perf_counter() - t
    top = sum(v for k, v in totals.items() if not k.startswith(" "))
    _sync(device)
    t = time.perf_counter()
    spmm(oc, x_host, out=out, device=device)
    pretouched = time.perf_counter() - t
    return dict(hop_s=hop, steps_s=totals, rest_s=hop - top, pretouched_s=pretouched)


def run_form(graph, adj, name, layout, dtype, blocks, part_edges: int, device) -> dict:
    """One form: its layout, a warm hop, the host's split and, on the card,
    the plain copies and the trace."""
    from sgl_tpu_torch.kernels import (
        hop_transfer_bytes, prepare_out_of_core, prepare_out_of_core_2d, spmm_out_of_core,
        spmm_out_of_core_2d,
    )

    x32 = torch.as_tensor(graph.x)
    x_host = x32.numpy() if dtype == torch.float32 else x32.to(dtype)
    n, d = x32.shape
    if layout == "1d":
        oc, spmm = prepare_out_of_core(adj, part_edges), spmm_out_of_core
    else:
        oc = prepare_out_of_core_2d(adj, part_edges, blocks, feat_dim=d, feat_dtype=dtype)
        spmm = spmm_out_of_core_2d
    spmm(oc, x_host, device=device)  # uploads the edges
    _sync(device)
    r = dict(form=name, parts=oc.num_parts, cells=getattr(oc, "num_cells", oc.num_parts),
             blocks=getattr(oc, "num_blocks", None), **host_split(spmm, oc, x_host, device))
    h2d, d2h = hop_transfer_bytes(oc, d, x32.to(dtype).element_size())
    r.update(h2d_bytes=h2d, d2h_bytes=d2h)
    if device.type == "cuda":
        h2d_ms, d2h_ms = copy_ms(h2d, True, device), copy_ms(d2h, False, device)
        r.update(h2d_copy_ms=h2d_ms, d2h_copy_ms=d2h_ms,
                 trace=device_overlap(lambda: spmm(oc, x_host, device=device), (h2d, d2h), h2d_ms + d2h_ms,
                                      r["hop_s"] * 1e3))
    return r


def describe(r: dict) -> str:
    steps = ", ".join(f"{k.strip()} {v:.4f}" for k, v in r["steps_s"].items())
    line = (f"{r['form']}: hop {r['hop_s']:.4f} s = {steps}, rest {r['rest_s']:.4f} s; into an output "
            f"written before {r['pretouched_s']:.4f} s")
    t = r.get("trace")
    if t is None:
        return line
    line += (f"; plain pinned copy_ {r['h2d_copy_ms']:.4f} + {r['d2h_copy_ms']:.4f} ms for "
             f"{r['h2d_bytes'] / 1e9:.4f} + {r['d2h_bytes'] / 1e9:.4f} GB; trace ({t['tries']} taken) "
             f"{t['copies']} copies of {t['h2d_bytes'] / 1e9:.4f} + {t['d2h_bytes'] / 1e9:.4f} GB in "
             f"{t['copy_sum_ms']:.4f} ms, ")
    if not t["complete"]:
        return line + "incomplete: overlap not measured"
    return line + (f"copies {t['copy_ms']:.4f} ms, kernels and memsets {t['compute_ms']:.4f} ms, busy "
                   f"{t['busy_ms']:.4f} of {t['wall_ms']:.4f} ms, overlap share {t['overlap_share']:.4f}, "
                   f"idle share {t['idle_share']:.4f}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=2_400_000)
    p.add_argument("--avg-deg", type=int, default=25)
    p.add_argument("--d", type=int, default=100)
    p.add_argument("--part-edges", type=int, default=6 << 20)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--out", default=None, help="write the results here as JSON")
    return p.parse_args(argv)


def main(argv=None) -> list:
    from sgl_tpu_torch.datasets import random_power_law_graph
    from sgl_tpu_torch.device import resolve_device
    from sgl_tpu_torch.graph import symmetric_normalized_weights_host

    args = parse_args(argv)
    device = resolve_device(args.device)
    graph = random_power_law_graph(args.n, args.avg_deg, args.d, seed=0, pad_multiple=1 << 20)
    adj = symmetric_normalized_weights_host(graph)
    print(f"out-of-core hop probe: {args.n} nodes, avg degree {args.avg_deg}, d={args.d}, parts of "
          f"{args.part_edges}; {device_label(device)}", flush=True)
    results = []
    for name, layout, dtype, blocks in FORMS:
        r = run_form(graph, adj, name, layout, dtype, blocks, args.part_edges, device)
        print(describe(r), flush=True)
        results.append(r)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=device_label(device), args=vars(args), forms=results), f, indent=1)
    return results


if __name__ == "__main__":
    main()
