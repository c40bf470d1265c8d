"""The design constants of the segment-reduce kernel, each timed against
other values on the card.

    python -m sgl_tpu_torch.dev.tune_segment_reduce

``kernels/csrc/segment_reduce.cu`` fixes three constants (:data:`CONSTANTS`):
the messages a block sums, ``kTileMessages`` (the package's
``TILE_MESSAGES``), the stages of its shared-memory ring, ``kStages``, and
the bytes a stage holds, ``kChunkBytes``.  Each variant of :data:`VARIANTS`
is a copy of that source with one constant changed, built with the
package's ``nvcc`` flags into a temporary directory beside the source as it
stands (``tune_spmm_csr.build_variants``: one ``nvcc`` each, all started
together).  At the SpMM bench shape (``random_power_law_graph(200_000, 25,
128, seed=0)``, 5,199,982 messages) every variant runs the forms of
:data:`FORMS` on the messages ``chip_smoke.py`` phase 6 gives them (``f32``
on ``exp_spmm``'s ``factored_f32`` messages; ``bf16_acc`` on the gathered
bf16 features, into an f32 accumulator), each held against the twin cut at
the variant's own tile within 1e-5 of max|y| and timed with
:func:`sgl_tpu_torch.dev.time_ms`, with the ``f32`` hub row alone beside
it (every other row empty, as ``chip_smoke.py`` probes it, and as a call
of one row, which writes no other row); the source as it stands first and
again last.

It needs the card, and changes nothing in the package.
"""

from __future__ import annotations

import argparse
import subprocess
import tempfile
from pathlib import Path

import torch

from sgl_tpu_torch.dev import device_label, exp_spmm, rel_err, time_ms
from sgl_tpu_torch.dev.tune_spmm_csr import build_variants, source_constants
from sgl_tpu_torch.kernels import _build
from sgl_tpu_torch.kernels.segment_reduce import (
    TILE_MESSAGES, run_kernel, segment_reduce_reference, signatures,
)

SOURCE = _build.CSRC / "segment_reduce.cu"
#: the design constants of ``segment_reduce.cu``
CONSTANTS = ("kTileMessages", "kStages", "kChunkBytes")
#: (constant, value) of each variant, beside the source as it stands
VARIANTS = (
    ("kTileMessages", 256), ("kTileMessages", 1024), ("kTileMessages", 2048),
    ("kStages", 2), ("kStages", 3), ("kStages", 6),
    ("kChunkBytes", 8192), ("kChunkBytes", 32768),
)
#: the forms timed, and the ``exp_spmm`` variant whose messages each sums
FORMS = {"f32": "factored_f32", "bf16_acc": "b"}
#: kernel against the twin at the variant's tile, of max|y|
TOL = 1e-5


def _tile(key, as_is: dict) -> int:
    return key[1] if key is not None and key[0] == "kTileMessages" else as_is["kTileMessages"]


def _name(key) -> str:
    return "as is" if key is None else f"{key[0]} = {key[1]}"


def bench_shape(libs: dict, as_is: dict, device) -> None:
    """The forms of :data:`FORMS` and the f32 hub row alone at the bench
    shape, for every library."""
    g, csr = exp_spmm.make_graph(device=device)
    ops = exp_spmm.prepare(csr)
    x = torch.as_tensor(g.x, device=device)
    n, d = x.shape
    lengths = torch.diff(csr.rowptr.long())
    top = int(lengths.argmax())
    beg, end = int(csr.rowptr[top]), int(csr.rowptr[top + 1])
    hub_rowptr = torch.zeros_like(csr.rowptr)
    hub_rowptr[top + 1:] = end - beg
    one_rowptr = torch.tensor([0, end - beg], dtype=torch.int32, device=device)
    e = csr.nnz
    print(f"bench shape: {n} rows, {e} messages, d={d}, longest row {end - beg}", flush=True)
    # the messages alone: bf16_acc sums the gathered bf16 features unweighted
    inputs = {key: exp_spmm.kernel_inputs(variant, ops, x)[0] for key, variant in FORMS.items()}
    acc0 = torch.randn(n, d, device=device, generator=torch.Generator(device).manual_seed(0))
    for lib_key in (*libs, None):  # the source as it stands first and last
        lib, tile = libs[lib_key], _tile(lib_key, as_is)
        notes = []
        for key, m in inputs.items():
            accumulate = key == "bf16_acc"

            def run(m=m, key=key, accumulate=accumulate):
                out = acc0.clone() if accumulate else torch.empty(n, d, device=device)
                run_kernel(lib, key, csr.rowptr, m, None, None, out, 0, e, tile)
                return out

            got = run()
            want = segment_reduce_reference(csr.rowptr, m, out=acc0.clone() if accumulate else None,
                                            tile=tile)
            err = rel_err(got, want)[1]
            if err > TOL:
                raise RuntimeError(f"{_name(lib_key)}: {key} disagrees with its twin: {err:.3e}")
            del got, want
            notes.append(f"{key} {time_ms(run, device, warmup=2, iters=10):.4f} ms (max rel err {err:.2e})")
        out = torch.empty(n, d, device=device)
        m_hub = inputs["f32"][beg:end]
        hub_ms = time_ms(lambda: run_kernel(lib, "f32", hub_rowptr, m_hub, None, None, out, 0, end - beg, tile),
                         device, warmup=2, iters=10)
        one_ms = time_ms(lambda: run_kernel(lib, "f32", one_rowptr, m_hub, None, None, out, 0, end - beg, tile),
                         device, warmup=2, iters=10)
        print(f"[bench] {_name(lib_key)} (tiles of {tile}: {-(-e // tile)} tiles): {'; '.join(notes)}; "
              f"the f32 hub row alone {hub_ms:.4f} ms (every other row empty), {one_ms:.4f} ms (a call of "
              f"one row)", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_segment_reduce: the variants are timed on a CUDA device")
    device = torch.device("cuda")
    as_is = source_constants(SOURCE.read_text(), CONSTANTS)
    if as_is["kTileMessages"] != TILE_MESSAGES:
        raise SystemExit(f"segment_reduce.cu cuts at {as_is['kTileMessages']}, TILE_MESSAGES is {TILE_MESSAGES}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{smi}; {device_label(device)}; the source as it stands: {as_is}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(VARIANTS, Path(tmp), SOURCE, CONSTANTS, signatures())
        bench_shape(libs, as_is, device)


if __name__ == "__main__":
    main()
