"""The design constants of the CSR SpMM kernel, each timed against other
values on the card.

    python -m sgl_tpu_torch.dev.tune_spmm_csr [--products]

``kernels/csrc/spmm_csr.cu`` fixes five constants (:data:`CONSTANTS`): the
split length ``kSplitNnz`` (the package's ``SPLIT_NNZ``), the gathers a
warp keeps in flight (``kGroup``), the resident blocks its launch bounds
ask for (``kMinBlocks``), the rows a warp takes (``kRowsPerWarp``) and the
partials per commit group of the fix-up (``kFixupGroup``).  Each variant
of :data:`VARIANTS` is a copy of that source with one constant changed,
built with the package's ``nvcc`` flags into a temporary directory (one
``nvcc`` per variant, all started together, beside the source as it
stands).  Every variant is held against the twin under a plan of its own
split length and timed with :func:`sgl_tpu_torch.dev.time_ms`, the source
as it stands first and again last:

* at the SpMM bench shape (``random_power_law_graph(200_000, 25, 128,
  seed=0)``): one-shot f32 (K1) and bf16 (K2), and the f32 hub row alone
  (the same CSR with every other row empty);
* with ``--products``, at the products scale of ``chip_smoke.py``
  (``products_scale_demo``: 2.4M nodes, ~62.4M nonzeros, d = 100): one f32
  hop streaming in its 10 parts (K3) and one-shot, each held against the
  source's own result within the f32 limit (another order of one sum).

Its copy-build helpers (:func:`source_constants`, :func:`variant_source`,
:func:`build_variants`) take any source and its constants;
``tune_segment_reduce`` times ``segment_reduce.cu``'s with them.

It needs the card, and changes nothing in the package.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import tempfile
from pathlib import Path

import torch

from sgl_tpu_torch.dev import device_label, rel_err, time_ms
from sgl_tpu_torch.kernels import _build
from sgl_tpu_torch.kernels.spmm_csr import (
    SPLIT_NNZ, CsrAdj, _make_plan, _split_sum_f32, run_passes, signatures,
)

SOURCE = _build.CSRC / "spmm_csr.cu"
#: the design constants of ``spmm_csr.cu``
CONSTANTS = ("kSplitNnz", "kGroup", "kMinBlocks", "kRowsPerWarp", "kFixupGroup")
#: (constant, value) of each variant, beside the source as it stands
VARIANTS = (
    ("kSplitNnz", 256), ("kSplitNnz", 1024),
    ("kGroup", 8), ("kGroup", 16),
    ("kMinBlocks", 2),
    ("kRowsPerWarp", 1), ("kRowsPerWarp", 2),
    ("kFixupGroup", 1), ("kFixupGroup", 4),
)
#: kernel against twin (or against the source's result), of max|y|
TOL = {"f32": 1e-5, "bf16": 1e-2}
BENCH_GRAPH = dict(num_nodes=200_000, avg_degree=25, feat_dim=128, seed=0)


def _pattern(name: str) -> re.Pattern:
    return re.compile(rf"(constexpr (?:int|int64_t) {name} = )(\d+);")


def source_constants(text: str, constants=CONSTANTS) -> dict:
    """``{constant: value}`` of ``constants`` (by default
    :data:`CONSTANTS`) in the source ``text``; raises unless each is
    defined exactly once."""
    values = {}
    for name in constants:
        found = _pattern(name).findall(text)
        if len(found) != 1:
            raise ValueError(f"{name} is defined {len(found)} times in the source, expected once")
        values[name] = int(found[0][1])
    return values


def variant_source(text: str, name: str, value: int, constants=CONSTANTS) -> str:
    """The source ``text`` with constant ``name``, one of ``constants``,
    set to ``value``."""
    if name not in constants:
        raise ValueError(f"{name} is not one of {constants}")
    source_constants(text, constants)  # each defined once
    return _pattern(name).sub(rf"\g<1>{value};", text)


def build_variants(variants, out_dir: Path, source: Path = SOURCE, constants=CONSTANTS,
                   entries=None) -> dict:
    """Build ``source`` as it stands (key None) and each ``(name, value)``
    variant of its ``constants`` into ``out_dir``, one ``nvcc`` each, all
    started together; returns ``{key: library}`` with the signatures of
    ``entries`` set (by default ``spmm_csr.cu``'s)."""
    text = source.read_text()
    entries = signatures() if entries is None else entries
    jobs = {}
    try:
        for key in (None, *variants):
            tag = "as_is" if key is None else f"{key[0]}_{key[1]}"
            src, lib = out_dir / f"{source.stem}_{tag}.cu", out_dir / f"{source.stem}_{tag}.so"
            src.write_text(text if key is None else variant_source(text, *key, constants))
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
            jobs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                         lib)
        libs = {}
        for key, (proc, lib) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for the variant {key}:\n{log}")
            libs[key] = _build.bind(ctypes.CDLL(str(lib)), entries)
        return libs
    finally:  # leave no compiler running behind a failure
        for proc, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _split(key, as_is: dict) -> int:
    return key[1] if key is not None and key[0] == "kSplitNnz" else as_is["kSplitNnz"]


def one_shot(lib, csr, plan, x) -> torch.Tensor:
    """``csr @ x`` through ``lib``'s plain instantiation for ``x``'s dtype."""
    y = torch.empty_like(x)
    key = "f32" if x.dtype == torch.float32 else "bf16"
    run_passes(lib, key, plan, csr.rowptr, csr.col, csr.val, x, y, csr.num_nodes, x.shape[1])
    return y


def streaming(lib, parts, plans, x) -> torch.Tensor:
    """``adj @ x`` part by part through ``lib``'s f32 accumulating form."""
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for part, plan in zip(parts, plans):
        run_passes(lib, "acc_f32", plan, part.rowptr, part.col, part.val, x, acc,
                   part.row_offset, part.num_rows, x.shape[1])
    return acc


def _hub_only(csr):
    """``csr`` with every row but its longest emptied (a CSR of its own)."""
    lengths = torch.diff(csr.rowptr.long())
    top = int(lengths.argmax())
    beg, end = int(csr.rowptr[top]), int(csr.rowptr[top + 1])
    rowptr = torch.zeros_like(csr.rowptr)
    rowptr[top + 1:] = end - beg
    return CsrAdj(rowptr, csr.col[beg:end].contiguous(), csr.val[beg:end].contiguous(), csr.num_nodes)


def _name(key) -> str:
    return "as is" if key is None else f"{key[0]} = {key[1]}"


def bench_shape(libs: dict, as_is: dict, device) -> None:
    """K1, K2 and the hub row alone at the bench shape, for every library."""
    from sgl_tpu_torch.datasets import random_power_law_graph
    from sgl_tpu_torch.graph import symmetric_normalized_weights
    from sgl_tpu_torch.kernels import prepare_csr

    g = random_power_law_graph(**BENCH_GRAPH)
    csr = prepare_csr(symmetric_normalized_weights(g, device=device))
    hub = _hub_only(csr)
    x32 = torch.as_tensor(g.x, device=device)
    print(f"bench shape: {csr.num_nodes} nodes, {csr.nnz} nonzeros, d={x32.shape[1]}, "
          f"longest row {hub.nnz}", flush=True)
    for key in (*libs, None):  # the source as it stands first and last
        lib, split = libs[key], _split(key, as_is)
        plan, hub_plan = _make_plan(csr.rowptr, split), _make_plan(hub.rowptr, split)
        notes = []
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x = x32.to(dtype)
            want = _split_sum_f32(csr.rowptr, csr.col, csr.val, csr.num_nodes, plan, x)
            err = rel_err(one_shot(lib, csr, plan, x), want.to(dtype))[1]
            if err > TOL[name]:
                raise RuntimeError(f"{_name(key)}: {name} disagrees with its twin: {err:.3e}")
            notes.append(f"{name} {time_ms(lambda: one_shot(lib, csr, plan, x), device):.4f} ms "
                         f"(max rel err {err:.2e})")
        hub_ms = time_ms(lambda: one_shot(lib, hub, hub_plan, x32), device)
        print(f"[bench] {_name(key)} (segments of {split}: {plan.num_long} long rows, "
              f"{plan.num_segments} segments): {'; '.join(notes)}; the hub row alone {hub_ms:.4f} ms",
              flush=True)


def products_shape(libs: dict, as_is: dict, device) -> None:
    """One f32 hop at products scale, streaming and one-shot, for every
    library, each against the source's own result."""
    from sgl_tpu_torch.examples import products_scale_demo

    out = products_scale_demo.main(hops=1, device=device)
    csr, parts, x = out["csr"], out["parts"], out["hops"][0]
    del out
    want_stream = streaming(libs[None], parts, [p.plan for p in parts], x)
    want_one = one_shot(libs[None], csr, csr.plan, x)
    for key in (*libs, None):
        lib, split = libs[key], _split(key, as_is)
        plans = [_make_plan(p.rowptr, split) for p in parts]
        plan = _make_plan(csr.rowptr, split)
        errs = (rel_err(streaming(lib, parts, plans, x), want_stream)[1],
                rel_err(one_shot(lib, csr, plan, x), want_one)[1])
        if max(errs) > TOL["f32"]:
            raise RuntimeError(f"{_name(key)}: products hop {errs} from the source's result")
        stream_ms = time_ms(lambda: streaming(lib, parts, plans, x), device)
        one_ms = time_ms(lambda: one_shot(lib, csr, plan, x), device)
        print(f"[products] {_name(key)} (segments of {split}: {plan.num_long} long rows, "
              f"{plan.num_segments} segments): f32 hop streaming in {len(parts)} parts {stream_ms:.4f} ms, "
              f"one-shot {one_ms:.4f} ms (max rel err from the source's result {max(errs):.2e})", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--products", action="store_true", help="also one hop at products scale")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_spmm_csr: the variants are timed on a CUDA device")
    device = torch.device("cuda")
    as_is = source_constants(SOURCE.read_text())
    if as_is["kSplitNnz"] != SPLIT_NNZ:
        raise SystemExit(f"spmm_csr.cu cuts at {as_is['kSplitNnz']}, SPLIT_NNZ is {SPLIT_NNZ}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{smi}; {device_label(device)}; the source as it stands: {as_is}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(VARIANTS, Path(tmp))
        bench_shape(libs, as_is, device)
        if args.products:
            products_shape(libs, as_is, device)


if __name__ == "__main__":
    main()
