"""The design constants of the CSR SpMM kernel, each timed against other
values on the card, and the kernel beside another source of it.

    python -m sgl_tpu_torch.dev.tune_spmm_csr [--products] [--wide] [--ring]
        [--ooc] [--batches] [--baseline PATH]

``kernels/csrc/spmm_csr.cu`` fixes six constants (:data:`CONSTANTS`):
the split length ``kSplitNnz`` (the package's ``SPLIT_NNZ``), the gathers
a warp keeps in flight (``kGroup``), the resident blocks its launch bounds
ask for (``kMinBlocks``), the rows a task takes (``kRowsPerWarp``), the
partials per commit group of the fix-up (``kFixupGroup``), and the most
nonzeros of a short row (``kShortNnz``; 0 turns the short rows' path of
bf16 into f32 off).  Each variant of :data:`VARIANTS` is a copy of that
source with one constant changed, built with the package's ``nvcc`` flags
into a temporary directory (one ``nvcc`` per variant, all started
together, beside the source as it stands).  Every variant is held against
the twin under a plan of its own split length, or against the source's
own result, and timed with :func:`sgl_tpu_torch.dev.time_ms`, the source
as it stands first and again last.  Three more constants live in the
wrapper and need no build: the column panels' L2 budget
(``spmm_csr.L2_BUDGET``) and width (``spmm_csr.PANEL_BYTES``), timed by
passing each width of :data:`PANEL_SWEEP` to the launch directly at
shapes on both sides of the budget; and ``spmm_csr.LIST_MAX_NNZ``,
whether a plan lists its rows, timed by making the plans with and
without the list.

* at the SpMM bench shape (``random_power_law_graph(200_000, 25, 128,
  seed=0)``): one-shot f32 (K1) and bf16 (K2), and the f32 hub row alone
  (the same CSR with every other row empty); the source as it stands also
  at every panel width;
* with ``--products``, at the products scale of ``chip_smoke.py``
  (``products_scale_demo``: 2.4M nodes, ~62.4M nonzeros, d = 100): one hop
  streaming in its 10 parts, f32 (K3) and bf16 (K4), and f32 one-shot;
  the source as it stands also one-shot at every panel width, at d = 100
  and at d = 256 (x far larger than the L2, and every panel too);
* with ``--wide``, K1 and K2 at Reddit's and Flickr's published shapes,
  their files written from a seed and loaded as ``chip_smoke.py``'s phase
  13 does: the source as it stands also at every panel width;
* with ``--ring``, one hop of bucket work (K3 and K4) on the 16 buckets of
  the products graph at P = 4 (phase 12's ``ring_bucket_work_time``), the
  source as it stands also with and without the plans' row lists;
* with ``--ooc``, the out-of-core cells of the products graph (phase 10):
  K3 at 4 and 1 source blocks (the resident executor launches the
  4-block cells), K4 at 2, also with and without the row lists;
* with ``--batches``, K1 and K2 at phase 9's NARS batch and graph batch,
  the source as it stands also at every panel width (x larger than the
  L2, but not its panels).

``--baseline PATH`` (given once or more) builds another ``spmm_csr.cu``
(an earlier source, kept outside the package) and times it beside the
source as it stands at every shape, in turns (as is, the baselines, the
variants, the baselines, as is), printing whether its results are the same
bits.  A baseline from before the panels and the listed rows takes the
arguments it took then.

Its copy-build helpers (:func:`source_constants`, :func:`variant_source`,
:func:`build_variants`) take any source and its constants;
``tune_segment_reduce`` times ``segment_reduce.cu``'s with them.

It needs the card, and changes nothing in the package.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import os
import re
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from sgl_tpu_torch.dev import device_label, rel_err, time_ms
from sgl_tpu_torch.kernels import _build
from sgl_tpu_torch.kernels.spmm_csr import (
    _ENTRY, SPLIT_NNZ, CsrAdj, _make_plan, _split_sum_f32, panel_columns, run_passes, signatures,
)

SOURCE = _build.CSRC / "spmm_csr.cu"
#: the design constants of ``spmm_csr.cu``
CONSTANTS = ("kSplitNnz", "kGroup", "kMinBlocks", "kRowsPerWarp", "kFixupGroup", "kShortNnz")
#: (constant, value) of each variant, beside the source as it stands
VARIANTS = (
    ("kSplitNnz", 256), ("kSplitNnz", 1024),
    ("kGroup", 8), ("kGroup", 16),
    ("kMinBlocks", 2), ("kMinBlocks", 3),
    ("kRowsPerWarp", 1), ("kRowsPerWarp", 2),
    ("kFixupGroup", 1), ("kFixupGroup", 4),
    ("kShortNnz", 0), ("kShortNnz", 4),
)
#: the column panel widths timed, in bytes of a row of x (each at most d
#: columns), beside no panels; ``spmm_csr.PANEL_BYTES`` is one of them
PANEL_SWEEP = (512, 256, 128, 64)
#: kernel against twin (or against the source's result), of max|y|
TOL = {"f32": 1e-5, "bf16": 1e-2}
BENCH_GRAPH = dict(num_nodes=200_000, avg_degree=25, feat_dim=128, seed=0)
# phase 5's products graph, phase 12's P, phase 10's source blocks a form
PRODUCTS_GRAPH = dict(num_nodes=2_400_000, avg_degree=25, feat_dim=100, seed=0, pad_multiple=1 << 20)
RING_PARTS = 4
OOC_CELLS = (("f32", 4), ("f32", 1), ("bf16", 2))
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
BASELINE = "baseline"


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


def is_legacy(text: str) -> bool:
    """Whether a ``spmm_csr.cu`` source predates the column panels and the
    listed rows: its entry points take no ``rows``, ``n_rows`` or
    ``panel``."""
    return "int64_t panel" not in text


def legacy_signatures() -> dict:
    """The C argument types of a legacy source's entry points."""
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    return {fn: [ptr] * 10 + [i64] * (n_ints - 2) + [ptr] for fn, n_ints in _ENTRY.values()}


@dataclasses.dataclass
class Kernel:
    """A built ``spmm_csr.cu`` and the arguments its entry points take."""

    lib: ctypes.CDLL
    legacy: bool = False

    def run(self, key, plan, rowptr, col, val, x, out, *ints, panel=None) -> None:
        """Both passes of instantiation ``key`` (``run_passes``); a legacy
        source gets no listed rows and no panel width."""
        if not self.legacy:
            run_passes(self.lib, key, plan, rowptr, col, val, x, out, *ints, panel=panel)
            return
        work = torch.empty((plan.num_segments, x.shape[1]), dtype=torch.float32, device=x.device)
        _build.call(
            self.lib, _ENTRY[key][0], x.device,
            rowptr.data_ptr(), col.data_ptr(), val.data_ptr(), x.data_ptr(), out.data_ptr(),
            plan.seg_beg.data_ptr(), plan.seg_end.data_ptr(), plan.seg_ptr.data_ptr(),
            plan.long_rows.data_ptr(), work.data_ptr(), *ints, plan.num_segments, plan.num_long,
        )


def build_kernels(out_dir: Path, baselines=()) -> dict:
    """The source as it stands (key None), its :data:`VARIANTS` and each
    of the ``baselines`` sources (key ``(BASELINE, its file's stem)``)."""
    kernels = {k: Kernel(lib) for k, lib in build_variants(VARIANTS, out_dir).items()}
    for i, path in enumerate(map(Path, baselines)):
        legacy = is_legacy(path.read_text())
        base_dir = out_dir / f"{BASELINE}{i}"
        base_dir.mkdir()
        lib = build_variants((), base_dir, path, (), legacy_signatures() if legacy else signatures())[None]
        kernels[(BASELINE, path.stem)] = Kernel(lib, legacy)
    return kernels


def order(kernels: dict) -> list:
    """The keys in the order they are timed: the source as it stands, the
    baselines, the variants, the baselines again in reverse, the source
    again."""
    base = [k for k in kernels if k is not None and k[0] == BASELINE]
    rest = [k for k in kernels if k is not None and k[0] != BASELINE]
    return [None, *base, *rest, *base[::-1], None]


_PLANS: dict = {}


def plan_of(rowptr: torch.Tensor, split: int, listed=None):
    """The plan of ``rowptr`` for segments of ``split`` nonzeros (its row
    list as ``_make_plan``'s ``listed`` says), built once (outside the
    timed calls) and kept."""
    key = (rowptr.data_ptr(), rowptr.shape[0], split, listed)
    if key not in _PLANS:
        _PLANS[key] = _make_plan(rowptr, split, listed)
    return _PLANS[key]


def _split(key, as_is: dict) -> int:
    return key[1] if key is not None and key[0] == "kSplitNnz" else as_is["kSplitNnz"]


def _name(key) -> str:
    if key is None:
        return "as is"
    return f"baseline {key[1]}" if key[0] == BASELINE else f"{key[0]} = {key[1]}"


def one_shot(kernel: Kernel, csr, plan, x, panel=None) -> torch.Tensor:
    """``csr @ x`` through ``kernel``'s plain instantiation for ``x``'s dtype."""
    y = torch.empty_like(x)
    key = "f32" if x.dtype == torch.float32 else "bf16"
    kernel.run(key, plan, csr.rowptr, csr.col, csr.val, x, y, csr.num_nodes, x.shape[1], panel=panel)
    return y


def accumulate(kernel: Kernel, parts, plans, x, acc) -> torch.Tensor:
    """Each ``(part, its x)`` of ``parts`` added into ``acc`` through
    ``kernel``'s accumulating form for the features' dtype; returns
    ``acc``."""
    for (part, xp), plan in zip(parts, plans):
        key = "acc_f32" if xp.dtype == torch.float32 else "acc_bf16"
        kernel.run(key, plan, part.rowptr, part.col, part.val, xp, acc, part.row_offset, part.num_rows,
                   xp.shape[1])
    return acc


def list_sweep(hop, where: str, device) -> None:
    """``hop(listed, fresh)`` (an accumulating hop of the source as it
    stands under plans made with ``_make_plan``'s ``listed``; into fresh
    accumulators, or timed into the same ones) with the rule's lists, with
    every plan listing its rows and with none, each against the rule's
    result."""
    want = hop(None, True)
    for listed, label in ((None, "the rule's lists"), (True, "every plan listed"), (False, "no lists")):
        got = hop(listed, True)
        ms = time_ms(lambda: hop(listed, False), device)
        print(f"[{where}] {label}: {ms:.4f} ms ({_same(got, want)} against the rule's)", flush=True)


def streaming(kernel: Kernel, parts, plans, x) -> torch.Tensor:
    """``adj @ x`` part by part through ``kernel``'s accumulating form."""
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    return accumulate(kernel, [(p, x) for p in parts], plans, x, acc)


def _hub_only(csr):
    """``csr`` with every row but its longest emptied (a CSR of its own)."""
    lengths = torch.diff(csr.rowptr.long())
    top = int(lengths.argmax())
    beg, end = int(csr.rowptr[top]), int(csr.rowptr[top + 1])
    rowptr = torch.zeros_like(csr.rowptr)
    rowptr[top + 1:] = end - beg
    return CsrAdj(rowptr, csr.col[beg:end].contiguous(), csr.val[beg:end].contiguous(), csr.num_nodes)


def _same(a, b) -> str:
    return "same bits" if torch.equal(a, b) else f"max rel err {rel_err(a, b)[1]:.2e}"


def timed(kernels: dict, as_is: dict, tag: str, fn, device, check=True, run=None) -> dict:
    """For each kernel in :func:`order`: ``fn(kernel, split)`` (one call,
    returning its result) held against the source's own first result
    (within ``TOL["f32"]`` of max|y| when ``check``; the bits compared), then
    ``run(kernel, split)`` timed (``fn`` by default; an accumulating call
    times into one accumulator, without zeroing it each call); one line
    each, tagged ``tag``.  Returns ``{key: ms}`` (the last time of a key
    timed twice)."""
    run = fn if run is None else run
    want = fn(kernels[None], as_is["kSplitNnz"])
    out = {}
    for key in order(kernels):
        split = _split(key, as_is)
        got = fn(kernels[key], split)
        err = rel_err(got.float(), want.float())[1]
        if check and err > TOL["f32"]:
            raise RuntimeError(f"{_name(key)}: {tag} is {err:.3e} from the source's result")
        out[key] = time_ms(lambda: run(kernels[key], split), device)
        print(f"[{tag}] {_name(key)}: {out[key]:.4f} ms ({_same(got, want)} against the source's result)",
              flush=True)
    return out


def panel_sweep(kernel: Kernel, csr, x, where: str, device) -> None:
    """The source as it stands on ``csr @ x`` without panels and at every
    width of :data:`PANEL_SWEEP` narrower than a row, each against the
    panel-free result; then the width the rule picks."""
    n, d = x.shape
    elem = x.element_size()
    plan = _make_plan(csr.rowptr)
    want = one_shot(kernel, csr, plan, x, d)
    for cols in (d, *[w // elem for w in PANEL_SWEEP if w // elem < d]):
        got = one_shot(kernel, csr, plan, x, cols)
        ms = time_ms(lambda: one_shot(kernel, csr, plan, x, cols), device)
        label = "no panels" if cols == d else f"panels of {cols} columns ({n * cols * elem / 1e6:.1f} MB of x)"
        print(f"[{where}] {label}: {ms:.4f} ms ({_same(got, want)} against no panels)", flush=True)
    print(f"[{where}] the rule picks {panel_columns(n, d, elem)} columns (x {n * d * elem / 1e6:.1f} MB)",
          flush=True)


def bench_shape(kernels: dict, as_is: dict, device) -> None:
    """K1, K2 and the hub row alone at the bench shape, for every kernel;
    the panel widths of the source as it stands."""
    from sgl_tpu_torch.datasets import random_power_law_graph
    from sgl_tpu_torch.graph import symmetric_normalized_weights
    from sgl_tpu_torch.kernels import prepare_csr

    g = random_power_law_graph(**BENCH_GRAPH)
    csr = prepare_csr(symmetric_normalized_weights(g, device=device))
    hub = _hub_only(csr)
    x32 = torch.as_tensor(g.x, device=device)
    print(f"bench shape: {csr.num_nodes} nodes, {csr.nnz} nonzeros, d={x32.shape[1]}, "
          f"longest row {hub.nnz}", flush=True)
    for key in order(kernels):
        kernel, split = kernels[key], _split(key, as_is)
        plan, hub_plan = _make_plan(csr.rowptr, split), _make_plan(hub.rowptr, split)
        notes = []
        for name, dtype in DTYPES.items():
            x = x32.to(dtype)
            want = _split_sum_f32(csr.rowptr, csr.col, csr.val, csr.num_nodes, plan, x)
            err = rel_err(one_shot(kernel, csr, plan, x), want.to(dtype))[1]
            if err > TOL[name]:
                raise RuntimeError(f"{_name(key)}: {name} disagrees with its twin: {err:.3e}")
            notes.append(f"{name} {time_ms(lambda: one_shot(kernel, csr, plan, x), device):.4f} ms "
                         f"(max rel err {err:.2e})")
        hub_ms = time_ms(lambda: one_shot(kernel, hub, hub_plan, x32), device)
        print(f"[bench] {_name(key)} (segments of {split}: {plan.num_long} long rows, "
              f"{plan.num_segments} segments): {'; '.join(notes)}; the hub row alone {hub_ms:.4f} ms",
              flush=True)
    for name, dtype in DTYPES.items():
        panel_sweep(kernels[None], csr, x32.to(dtype), f"bench {name}", device)


def products_shape(kernels: dict, as_is: dict, device) -> None:
    """One hop at products scale, streaming f32 (K3) and bf16 (K4) and
    one-shot f32, for every kernel, each against the source's own result."""
    from sgl_tpu_torch.examples import products_scale_demo

    out = products_scale_demo.main(hops=1, device=device)
    csr, parts, x = out["csr"], out["parts"], out["hops"][0]
    del out
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for name, dtype in DTYPES.items():
        xd = x.to(dtype)
        timed(kernels, as_is, f"products streaming {name}, {len(parts)} parts",
              lambda k, s: streaming(k, parts, [plan_of(p.rowptr, s) for p in parts], xd), device,
              run=lambda k, s: accumulate(k, [(p, xd) for p in parts], [plan_of(p.rowptr, s) for p in parts],
                                          xd, acc))
    timed(kernels, as_is, "products one-shot f32", lambda k, s: one_shot(k, csr, plan_of(csr.rowptr, s), x), device)
    _PLANS.clear()
    for name, dtype in DTYPES.items():
        panel_sweep(kernels[None], csr, x.to(dtype), f"products one-shot {name}", device)
    wide = torch.randn((csr.num_nodes, 256), generator=torch.Generator(device).manual_seed(0), device=device)
    panel_sweep(kernels[None], csr, wide, "products one-shot f32, d = 256", device)


def _load(name: str, root: str, device):
    """Reddit's or Flickr's files at the published shape, written from a
    seed (on the card, as phase 13 writes them) and loaded."""
    from sgl_tpu_torch.datasets import Flickr, Reddit, raw_files

    if name == "Reddit":
        raw_files.write_reddit(os.path.join(root, "reddit", "reddit", "raw"), device=device)
        return Reddit(root + "/")
    raw_files.write_graphsaint(os.path.join(root, "flickr", "flickr", "raw"), device=device)
    return Flickr(root + "/")


def wide_shapes(kernels: dict, as_is: dict, device) -> None:
    """K1 and K2 at Reddit's and Flickr's shapes: every kernel at the
    rule's panel width, then the source at every width."""
    from sgl_tpu_torch.kernels import prepare_csr
    from sgl_tpu_torch.ops import LaplacianGraphOp

    for name in ("Reddit", "Flickr"):
        with tempfile.TemporaryDirectory() as root:
            ds = _load(name, root, device)
            csr = prepare_csr(LaplacianGraphOp(1).construct_adj(ds.graph, device))
            x32 = torch.as_tensor(np.asarray(ds.x), device=device)
            del ds
        print(f"{name}: {csr.num_nodes} nodes, {csr.nnz} nonzeros with self-loops, d={x32.shape[1]}, "
              f"{csr.plan.num_long} long rows", flush=True)
        for key, dtype in DTYPES.items():
            x = x32.to(dtype)
            timed(kernels, as_is, f"{name} {key}, panels of {panel_columns(*x.shape, x.element_size())}",
                  lambda k, s: one_shot(k, csr, plan_of(csr.rowptr, s), x), device, check=key == "f32")
            panel_sweep(kernels[None], csr, x, f"{name} {key}", device)
        _PLANS.clear()
        del csr, x32
        torch.cuda.empty_cache()


def _products_adj(device):
    from sgl_tpu_torch.datasets import random_power_law_graph
    from sgl_tpu_torch.graph import symmetric_normalized_weights

    g = random_power_law_graph(**PRODUCTS_GRAPH)
    return g, symmetric_normalized_weights(g, device=device)


def ring_buckets(kernels: dict, as_is: dict, device) -> None:
    """One hop of bucket work on the products graph's P² buckets, f32 and
    bf16 blocks into f32 accumulators, for every kernel."""
    from sgl_tpu_torch.parallel import partition_adj_chunked

    g, adj = _products_adj(device)
    dadj = partition_adj_chunked(adj, RING_PARTS)
    del adj
    p, d = RING_PARTS, g.num_features
    work = [(o, b, part) for o in range(p) for b, part in enumerate(dadj.local(o, device).buckets)]
    listed = sum(part.plan.num_listed for *_, part in work)
    rows = sum(part.num_rows for *_, part in work)
    print(f"ring buckets at P = {p}: {len(work)} buckets, {dadj.nnz} nonzeros, {listed} of {rows} rows "
          f"listed (neither empty nor long)", flush=True)
    for name, dtype in DTYPES.items():
        x = torch.as_tensor(np.random.default_rng(0).standard_normal((p, dadj.block, d)), dtype=dtype).to(device)
        acc = torch.zeros((p, dadj.block, d), dtype=torch.float32, device=device)

        def hop(k, s, y=None, listed=None):
            y = torch.zeros_like(acc) if y is None else y
            for o, b, part in work:
                accumulate(k, [(part, x[b])], [plan_of(part.rowptr, s, listed)], x[b], y[o])
            return y
        timed(kernels, as_is, f"ring hop {name}, {len(work)} buckets", hop, device,
              run=lambda k, s: hop(k, s, acc))
        list_sweep(lambda listed, fresh: hop(kernels[None], SPLIT_NNZ, None if fresh else acc, listed),
                   f"ring hop {name}", device)
    _PLANS.clear()


def ooc_cells(kernels: dict, as_is: dict, device) -> None:
    """The 2-D out-of-core cells of the products graph on the card, each
    cell's launch into its part's accumulator, for every kernel."""
    from sgl_tpu_torch.datasets import random_power_law_graph
    from sgl_tpu_torch.graph import symmetric_normalized_weights_host
    from sgl_tpu_torch.kernels import prepare_out_of_core_2d
    from sgl_tpu_torch.kernels.spmm_ooc import _upload

    g = random_power_law_graph(**PRODUCTS_GRAPH)
    adj = symmetric_normalized_weights_host(g)
    x32 = torch.as_tensor(g.x, device=device)
    for name, blocks in OOC_CELLS:
        oc = prepare_out_of_core_2d(adj, src_blocks=blocks, feat_dim=g.num_features, feat_dtype=DTYPES[name])
        x = x32.to(DTYPES[name])
        cells = []
        for p, row in enumerate(oc.parts):
            for b, c in enumerate(row):
                if c.nnz:
                    lo, rows = oc.block_range(b)
                    cells.append((p, _upload(c, device, rows), x.narrow(0, lo, rows)))
        accs = [torch.zeros((v, x.shape[1]), device=device) for v in oc.valid_rows]

        def hop(k, s, zero=True, listed=None):
            if zero:
                for acc in accs:
                    acc.zero_()
            for p, part, xp in cells:
                accumulate(k, [(part, xp)], [plan_of(part.rowptr, s, listed)], xp, accs[p])
            return torch.cat(accs) if zero else None
        where = f"ooc 2-D {name}, {blocks} source blocks, {len(cells)} cells"
        timed(kernels, as_is, where, hop, device, run=lambda k, s: hop(k, s, zero=False))
        list_sweep(lambda listed, fresh: hop(kernels[None], SPLIT_NNZ, fresh, listed), where, device)
        _PLANS.clear()
        del oc, cells, accs
        torch.cuda.empty_cache()


def batches(kernels: dict, as_is: dict, device) -> None:
    """K1 and K2 at phase 9's NARS batch and graph batch, for every kernel."""
    from sgl_tpu_torch.datasets import SyntheticGraphClassification, SyntheticHeteroDataset
    from sgl_tpu_torch.graph import batch_graphs, symmetric_normalized_weights
    from sgl_tpu_torch.kernels import prepare_csr

    ds = SyntheticHeteroDataset(counts={"paper": 200_000, "author": 308_000, "subject": 16_000}, avg_degree=10,
                                feat_dim=128, num_classes=349, seed=0)
    subgraphs = ds.nars_preprocess(ds.edge_types, "paper", seed=42, random_subgraph_num=3,
                                   subgraph_edge_type_num=2)
    nars = batch_graphs([g.replace(x=feat) for g, feat, _ in subgraphs.values()])
    del ds, subgraphs
    graph = SyntheticGraphClassification(num_graphs=40_000, nodes_per_graph=(20, 40), feat_dim=128, seed=0).batch()
    for where, batch in (("NARS batch", nars), ("graph batch", graph)):
        csr = prepare_csr(symmetric_normalized_weights(batch.graph, device=device))
        x32 = torch.as_tensor(batch.graph.x, device=device)
        for key, dtype in DTYPES.items():
            x = x32.to(dtype)
            timed(kernels, as_is, f"{where} {key} ({csr.num_nodes} x {csr.nnz})",
                  lambda k, s: one_shot(k, csr, plan_of(csr.rowptr, s), x), device, check=key == "f32")
            panel_sweep(kernels[None], csr, x, f"{where} {key}", device)
        _PLANS.clear()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--products", action="store_true", help="also one hop at products scale")
    ap.add_argument("--wide", action="store_true", help="also K1/K2 at Reddit's and Flickr's shapes")
    ap.add_argument("--ring", action="store_true", help="also the ring's buckets of the products graph")
    ap.add_argument("--ooc", action="store_true", help="also the products graph's out-of-core cells")
    ap.add_argument("--batches", action="store_true", help="also phase 9's NARS and graph batches")
    ap.add_argument("--baseline", action="append", default=[],
                    help="another spmm_csr.cu, timed beside the source as it stands (repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_spmm_csr: the variants are timed on a CUDA device")
    device = torch.device("cuda")
    as_is = source_constants(SOURCE.read_text())
    if as_is["kSplitNnz"] != SPLIT_NNZ:
        raise SystemExit(f"spmm_csr.cu cuts at {as_is['kSplitNnz']}, SPLIT_NNZ is {SPLIT_NNZ}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{smi}; {device_label(device)}; the source as it stands: {as_is}; baseline {args.baseline}",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        kernels = build_kernels(Path(tmp), args.baseline)
        bench_shape(kernels, as_is, device)
        for flag, fn in ((args.products, products_shape), (args.wide, wide_shapes), (args.ring, ring_buckets),
                         (args.ooc, ooc_cells), (args.batches, batches)):
            if flag:
                fn(kernels, as_is, device)
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
