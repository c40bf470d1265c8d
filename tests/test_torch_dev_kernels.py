"""The port of the ``dev/`` harness kernels D1–D6 against the JAX package, on
the CPU (the plain versions; the CUDA kernels are held against the same
plain versions on the card in ``test_torch_cuda.py``).

The JAX harnesses are run as they are, with ``jax.experimental.pallas.
pallas_call`` replaced for the duration by a wrapper that forces
``interpret=True`` and records each call's inputs and output, under
``jax.disable_jit()``.  Each recorded kernel is then held against the
port's segment reduce (or gather sum) on the same inputs, converted from
the TPU's chunk layout (flatten, stable sort by ``dst``, row pointer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import dev.exp_acc_alias as j_acc_alias
import dev.exp_gather_dma as j_gather_dma
import dev.exp_spmm as j_spmm
from sgl_tpu.kernels.sparse import spmm_segment as j_spmm_segment
from sgl_tpu_torch.dev import exp_acc_alias, exp_gather_dma, exp_spmm
from sgl_tpu_torch.kernels import (
    dst_order,
    gather_sum,
    gather_sum_reference,
    segment_reduce,
    segment_reduce_reference,
)
from sgl_tpu_torch.dev import tune_segment_reduce as TUNE_SEGMENT
from sgl_tpu_torch.dev.tune_spmm_csr import source_constants, variant_source
from sgl_tpu_torch.kernels.segment_reduce import COLUMN_WINDOW, INSTANTIATIONS, TILE_MESSAGES, tiling

#: the graph of the JAX harness's ``--check`` (``dev/exp_spmm.py:238``)
SMALL = (2000, 8, 64)


class _Stop(Exception):
    """Raised by the patched ``timed``: the harness's correctness step is
    done, its timing loop is not wanted."""


def _stop(*args, **kwargs):
    raise _Stop


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def recorded():
    """``{stage: [(kernel name, inputs, output), ...]}`` for each Pallas
    call the JAX harnesses make, in interpret mode."""
    calls = []
    pallas_call = pl.pallas_call

    def recording(kernel, *args, **kwargs):
        kwargs["interpret"] = True
        call = pallas_call(kernel, *args, **kwargs)
        name = getattr(kernel, "__name__", None) or kernel.func.__name__

        def run(*operands):
            out = call(*operands)
            calls.append((name, [np.asarray(v) for v in operands], np.asarray(out)))
            return out

        return run

    make_graph = j_spmm.make_graph
    rng = np.random.default_rng(0)
    stages = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call", recording)
    mp.setattr(j_spmm, "timed", _stop)
    mp.setattr(j_spmm, "make_graph", lambda *a, **k: make_graph(*SMALL))

    def stage(name, fn):
        n0 = len(calls)
        try:
            fn()
        except _Stop:
            pass
        stages[name] = calls[n0:]

    def d1():
        x = jnp.asarray(rng.normal(size=(1024, 128)).astype(np.float32))
        src = jnp.asarray(rng.integers(0, 1024, 512).astype(np.int32))
        j_gather_dma.gather_dma(src, x, 128, 8)

    def d2():
        dst, hi, acc = exp_acc_alias.make_inputs()
        ct = jnp.asarray(dst[:, 0, 0] // exp_acc_alias.TILE_R)
        j_acc_alias.run(ct, jnp.asarray([exp_acc_alias.OFF_TILES], jnp.int32), jnp.asarray(dst),
                        jnp.asarray(hi, jnp.bfloat16), jnp.asarray(acc), interpret=True, alias_idx=4)

    def factored():
        spmm_factored, spmm_factored_f32 = j_spmm.build_factored()
        g, adj = make_graph(*SMALL)
        (src, dst, ct), f, ch = j_spmm.factored_inputs(g, adj)
        for fn in (spmm_factored, spmm_factored_f32):
            fn((src, dst, ct), jnp.asarray(g.x), f, f, ch.num_nodes)

    try:
        with jax.disable_jit():
            stage("D1", d1)
            stage("D2", d2)
            stage("factored", factored)
            stage("micro7", j_spmm.run_micro7)
            stage("micro9", j_spmm.run_micro9)
    finally:
        mp.undo()
    return stages


def _pick(recorded, stage, kernel):
    (hit,) = [(args, out) for name, args, out in recorded[stage] if name == kernel]
    return hit


def _bf16(a) -> torch.Tensor:
    """A bf16 (or f32) numpy array as a torch bf16 tensor, exactly."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _from_chunks(dst3, n_rows, m3, weights):
    """The TPU's chunk layout as the port takes it: the edges flattened and
    stably sorted by ``dst``, with their row pointer."""
    order, rowptr = dst_order(torch.from_numpy(dst3.reshape(-1).astype(np.int64)), n_rows)
    m = m3.reshape(order.shape[0], -1)
    m = (_bf16(m) if m.dtype != np.float32 else torch.from_numpy(m))[order].contiguous()
    ws = [_bf16(w.reshape(-1))[order].contiguous() for w in weights]
    return rowptr, m, ws


# -- D1 ------------------------------------------------------------------------


def test_d1_gather_sum_matches_gather_dma(recorded):
    (src3, x), out = _pick(recorded, "D1", "_gather_kernel")
    got = gather_sum(torch.from_numpy(x), torch.from_numpy(src3.reshape(-1)))
    assert got.shape == out.shape == (1, 128) and got.dtype == torch.float32
    assert _rel(got.numpy(), out) <= 1e-5  # two f32 orders of one sum


# -- D2 ------------------------------------------------------------------------


def test_d2_accumulate_matches_acc_alias_run(recorded):
    (ct, off, dst3, hi3, acc), out = _pick(recorded, "D2", "kernel")
    off_rows = int(off[0]) * exp_acc_alias.TILE_R
    rowptr, m, _ = _from_chunks(dst3, exp_acc_alias.N_TILES * exp_acc_alias.TILE_R, hi3, [])
    acc_t = torch.from_numpy(acc.copy())
    got = segment_reduce(rowptr, m, out=acc_t, row_offset=off_rows)
    assert got is acc_t  # in place: the counterpart of the aliased output
    touched = np.zeros(acc.shape[0], bool)
    touched[dst3.reshape(-1) + off_rows] = True
    assert touched.sum() > 0 and (~touched).sum() > 0
    # rows no message reaches: the TPU leaves the blocks it never visits,
    # the port the rows with an empty range, both bit for bit
    np.testing.assert_array_equal(got.numpy()[~touched], acc[~touched])
    np.testing.assert_array_equal(out[~touched], acc[~touched])
    # the order of the sum differs: one-hot matmuls against a sorted row sum
    assert _rel(got.numpy()[touched], out[touched]) <= 1e-5


# -- D3–D6 ---------------------------------------------------------------------

# (TPU kernel, harness stage, kernel body, halves, max rel err of max|y|):
# the messages arrive as the TPU kernel gets them; D3, D5 and B take bf16
# inputs, whose products are exact in f32, so only the order of the sum
# differs; D4 and A' split f32 messages into bf16 halves on the TPU (2^-17
# each), the port sums them whole; A also drops wl·ml on the TPU
SEGMENT_CASES = [
    ("D3", "factored", "_seg_kernel_cat", 2, 1e-5),
    ("D4", "factored", "_seg_kernel_f32", 1, 1e-5),
    ("D5", "micro7", "_seg_kernel_packed", 2, 1e-5),
    ("D6 A", "micro9", "_kern_a", 1, 1e-4),
    ("D6 A'", "micro9", "_kern_a2", 1, 1e-5),
    ("D6 B", "micro9", "_kern_b", 1, 1e-5),
]


@pytest.mark.parametrize("tpu,stage,kernel,halves,tol", SEGMENT_CASES, ids=[c[0] for c in SEGMENT_CASES])
def test_segment_reduce_matches_tpu_kernel(recorded, tpu, stage, kernel, halves, tol):
    args, out = _pick(recorded, stage, kernel)
    dst3, weights, m3 = args[1], args[2:-1], args[-1]
    rowptr, m, ws = _from_chunks(dst3, out.shape[0], m3, weights)
    wh, wl = (ws + [None, None])[:2]
    got = segment_reduce(rowptr, m, halves=halves, wh=wh, wl=wl)
    assert got.dtype == torch.float32 and got.shape == out.shape
    assert _rel(got.numpy(), out) <= tol


# -- the slice as a whole --------------------------------------------------------

# against sgl_tpu's f32 segment path on the same graph (see exp_spmm.LIMITS
# for the card's bench-shape limits): a2 and factored_f32 round messages
# apart only in the last f32 bit; the bf16 halves carry 2^-17 (JAX's own
# harness reads 2.7e-6 for packed and A); B has bf16 features, held to the
# bar of __graft_entry__.dryrun_multichip (JAX's harness reads 1.36e-3)
SLICE_LIMITS = {"factored": 1e-4, "factored_f32": 1e-5, "packed": 1e-4, "a": 1e-4, "a2": 1e-5,
                "b": 3e-2}


@pytest.fixture(scope="module")
def small_graphs():
    jg, jadj = j_spmm.make_graph(*SMALL)
    g, csr = exp_spmm.make_graph(*SMALL, device="cpu")
    np.testing.assert_array_equal(g.x, np.asarray(jg.x))
    want = np.asarray(j_spmm_segment(jadj, jnp.asarray(jg.x)))
    return exp_spmm.prepare(csr), torch.as_tensor(g.x), want


@pytest.mark.parametrize("variant", exp_spmm.VARIANTS)
def test_harness_variant_matches_spmm_segment(small_graphs, variant):
    ops, x, want = small_graphs
    got = exp_spmm.spmm_variant(variant, ops, x)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= SLICE_LIMITS[variant]
    assert SLICE_LIMITS[variant] <= exp_spmm.LIMITS[variant]


def test_named_variants_are_the_table(small_graphs):
    ops, x, _ = small_graphs
    for fn, variant in (
        (exp_spmm.spmm_factored, "factored"), (exp_spmm.spmm_factored_f32, "factored_f32"),
        (exp_spmm.spmm_packed, "packed"), (exp_spmm.spmm_a, "a"), (exp_spmm.spmm_a2, "a2"),
        (exp_spmm.spmm_b, "b"),
    ):
        assert torch.equal(fn(ops, x), exp_spmm.spmm_variant(variant, ops, x))


def test_prepare_refuses_a_weighted_graph(small_graphs):
    ops, _, _ = small_graphs
    import dataclasses

    scaled = dataclasses.replace(ops.csr, val=ops.csr.val * 1.5)
    with pytest.raises(ValueError, match="unweighted"):
        exp_spmm.prepare(scaled)


# -- the port's own contract (plain versions) ---------------------------------------


def _segment_inputs(key, d=5, n=40, seed=0):
    """Dst-ordered random messages for instantiation ``key``: a long row,
    empty rows (every 7th) and the weights the form takes."""
    dtype, halves, n_w, _, _ = INSTANTIATIONS[key]
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 6, n)
    lengths[3] = 60
    lengths[::7] = 0
    rowptr = torch.as_tensor(np.concatenate([[0], np.cumsum(lengths)]), dtype=torch.int32)
    e = int(rowptr[-1])
    m = torch.as_tensor(rng.normal(size=(e, halves * d)).astype(np.float32)).to(dtype)
    w = torch.as_tensor(rng.random(e).astype(np.float32) + 0.5)
    wh, wl = exp_spmm.split_bf16(w)
    kw = dict(halves=halves, wh=wh if n_w >= 1 else None, wl=wl if n_w == 2 else None)
    return rowptr, m, kw


def _numpy_loop(rowptr, m, halves, wh, wl):
    """Row by row, message by message, in f32."""
    rowptr, m = rowptr.numpy(), m.float().numpy()
    d = m.shape[1] // halves
    y = np.zeros((rowptr.shape[0] - 1, d), np.float32)
    for r in range(y.shape[0]):
        for e in range(rowptr[r], rowptr[r + 1]):
            a, b = m[e, :d], m[e, d:] if halves == 2 else None
            h = None if wh is None else np.float32(wh[e].float())
            l = None if wl is None else np.float32(wl[e].float())
            if h is None:
                msg = a if b is None else a + b
            elif l is None:
                msg = h * a if b is None else h * a + h * b
            else:
                msg = (h + l) * a if b is None else h * a + h * b + l * a
            y[r] += msg
    return y


@pytest.mark.parametrize("key", sorted(INSTANTIATIONS))
def test_each_form_matches_a_numpy_loop(key):
    rowptr, m, kw = _segment_inputs(key)
    want = _numpy_loop(rowptr, m, kw["halves"], kw["wh"], kw["wl"])
    if INSTANTIATIONS[key][3]:  # the accumulating form, into zeros
        got = segment_reduce(rowptr, m, out=torch.zeros(want.shape), **kw)
    else:
        got = segment_reduce(rowptr, m, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    empty = (torch.diff(rowptr) == 0).numpy()
    assert empty.sum() >= 5 and not got.numpy()[empty].any()


#: a small tile, so that small rows cross tile edges
TILE = 8
# rows of T-1, T and T+1 messages, 3T+5, one across 12 tiles, empty rows at
# tile edges (offsets 8 and 16) and inside a tile, trailing empty rows
TILE_LENGTHS = [0, TILE, 0, TILE - 1, 1, 0, TILE + 1, 3 * TILE + 5, 0, 2, 12 * TILE + 3, TILE, 0, 5, 0, 0, 0]


def _tile_inputs(key, d=6, seed=3):
    dtype, halves, n_w, _, _ = INSTANTIATIONS[key]
    rng = np.random.default_rng(seed)
    rowptr = torch.as_tensor(np.concatenate([[0], np.cumsum(TILE_LENGTHS)]), dtype=torch.int32)
    e = int(rowptr[-1])
    m = torch.as_tensor(rng.normal(size=(e, halves * d)).astype(np.float32)).to(dtype)
    wh, wl = exp_spmm.split_bf16(torch.as_tensor(rng.random(e).astype(np.float32) + 0.5))
    return rowptr, m, dict(halves=halves, wh=wh if n_w >= 1 else None, wl=wl if n_w == 2 else None)


def _numpy_tile_order(rowptr, m, halves, wh, wl, tile):
    """The kernel's order, message by message in f32: each row's piece of
    each tile summed in edge order from 0, the pieces added in tile order
    from 0."""
    msgs = _numpy_loop(torch.arange(m.shape[0] + 1, dtype=torch.int32), m, halves, wh, wl)
    rowptr = rowptr.numpy()
    y = np.zeros((rowptr.shape[0] - 1, msgs.shape[1]), np.float32)
    for r in range(y.shape[0]):
        beg, end = rowptr[r], rowptr[r + 1]
        for t in range(beg // tile, (end + tile - 1) // tile) if end > beg else ():
            piece = np.zeros(msgs.shape[1], np.float32)
            for e in range(max(beg, t * tile), min(end, (t + 1) * tile)):
                piece += msgs[e]
            y[r] += piece
    return y


@pytest.mark.parametrize("key", sorted(INSTANTIATIONS))
def test_twin_sums_in_tile_order(key):
    rowptr, m, kw = _tile_inputs(key)
    starts = rowptr[:-1].numpy()
    empty = (torch.diff(rowptr) == 0).numpy()
    assert (empty & (starts % TILE == 0) & (starts > 0)).sum() >= 2 and empty[-3:].all()
    assert (torch.diff(rowptr) > 10 * TILE).any()
    want = _numpy_tile_order(rowptr, m, kw["halves"], kw["wh"], kw["wl"], TILE)
    if INSTANTIATIONS[key][3]:  # the accumulating form, into random rows at an offset
        n, off = rowptr.shape[0] - 1, 3
        acc0 = torch.randn(off + n + 2, want.shape[1], generator=torch.Generator().manual_seed(4))
        got = segment_reduce_reference(rowptr, m, out=acc0.clone(), row_offset=off, tile=TILE, **kw)
        touched = torch.zeros(acc0.shape[0], dtype=torch.bool)
        touched[off:off + n] = torch.diff(rowptr) > 0
        assert torch.equal(got[~touched], acc0[~touched])
        got = (got - acc0)[off:off + n]
    else:
        got = segment_reduce_reference(rowptr, m, tile=TILE, **kw)
        assert not got.numpy()[empty].any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the kernel's cut at the small tile: the rows that cross an edge
    cut = tiling(rowptr, m, kw["halves"], tile=TILE)
    assert cut["tiles"] == -(-int(rowptr[-1]) // TILE) and cut["cut_rows"] == 4
    assert cut["windows"] == 1 and cut["path"] != "windows"
    wide = tiling(rowptr, torch.zeros(m.shape[0], kw["halves"] * (COLUMN_WINDOW + 1)), kw["halves"], tile=TILE)
    assert wide["windows"] == 2 and wide["path"] == "windows"


@pytest.mark.parametrize("key", sorted(INSTANTIATIONS))
def test_twin_at_the_kernel_tile_is_close_to_float64_on_a_long_row(key):
    # one row of 20,000 messages (40 tiles) between short ones, against
    # the same f32 messages summed in float64
    dtype, halves, n_w, accumulate, _ = INSTANTIATIONS[key]
    lengths = [3, 20_000, 0, 7]
    rowptr = torch.as_tensor(np.concatenate([[0], np.cumsum(lengths)]), dtype=torch.int32)
    rng = np.random.default_rng(5)
    m = torch.as_tensor(rng.normal(size=(rowptr[-1].item(), halves * 16)).astype(np.float32)).to(dtype)
    wh, wl = exp_spmm.split_bf16(torch.as_tensor(rng.random(m.shape[0]).astype(np.float32) + 0.5))
    kw = dict(halves=halves, wh=wh if n_w >= 1 else None, wl=wl if n_w == 2 else None)
    out = torch.zeros(len(lengths), 16) if accumulate else None
    got = segment_reduce_reference(rowptr, m, out=out, **kw)
    msgs = _numpy_loop(torch.arange(m.shape[0] + 1, dtype=torch.int32), m, halves, kw["wh"], kw["wl"])
    want = np.add.reduceat(msgs.astype(np.float64), np.minimum(rowptr[:-1].numpy(), m.shape[0] - 1))
    want[np.diff(rowptr.numpy()) == 0] = 0
    assert _rel(got.numpy(), want) <= 1e-6


def test_tile_length_is_the_kernel_source_constant():
    # the wrapper sizes the workspace by TILE_MESSAGES, the kernel cuts by
    # kTileMessages; the wrapper counts a launch per column window of
    # COLUMN_WINDOW, the kernel launches one per kThreads * kColsMax columns
    text = TUNE_SEGMENT.SOURCE.read_text()
    assert source_constants(text, TUNE_SEGMENT.CONSTANTS)["kTileMessages"] == TILE_MESSAGES
    window = source_constants(text, ("kThreads", "kColsMax"))
    assert window["kThreads"] * window["kColsMax"] == COLUMN_WINDOW
    assert "kWindowCols = (int64_t)kThreads * kColsMax;" in text


@pytest.mark.parametrize("name, value", list(TUNE_SEGMENT.VARIANTS))
def test_segment_tune_variant_changes_one_constant(name, value):
    text = TUNE_SEGMENT.SOURCE.read_text()
    as_is = source_constants(text, TUNE_SEGMENT.CONSTANTS)
    assert as_is[name] != value
    variant = variant_source(text, name, value, TUNE_SEGMENT.CONSTANTS)
    assert source_constants(variant, TUNE_SEGMENT.CONSTANTS) == {**as_is, name: value}
    assert sum(a != b for a, b in zip(text.splitlines(), variant.splitlines())) == 1
    with pytest.raises(ValueError, match="not one of"):
        variant_source(text, "kSplitNnz", 256, TUNE_SEGMENT.CONSTANTS)


def test_segment_tune_refuses_to_run_without_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        TUNE_SEGMENT.main([])


def test_accumulate_keeps_untouched_rows_bit_for_bit():
    rowptr, m, kw = _segment_inputs("bf16_acc", d=8)
    n, off = rowptr.shape[0] - 1, 9
    acc0 = torch.full((off + n + 4, 8), -0.0)
    acc0[:off] = torch.randn(off, 8, generator=torch.Generator().manual_seed(1))
    acc = acc0.clone()
    assert segment_reduce(rowptr, m, out=acc, row_offset=off, **kw) is acc
    touched = torch.zeros(acc.shape[0], dtype=torch.bool)
    touched[off:off + n] = torch.diff(rowptr) > 0
    # outside the window and the window's empty rows: the same bits (-0.0 too)
    assert torch.equal(acc[~touched], acc0[~touched])
    assert torch.signbit(acc[~touched][off:]).all()
    want = torch.as_tensor(_numpy_loop(rowptr, m, 1, None, None))
    np.testing.assert_allclose(acc[off:off + n][torch.diff(rowptr) > 0].numpy(),
                               want[torch.diff(rowptr) > 0].numpy(), rtol=1e-6, atol=1e-6)


def test_twin_is_the_wrapper_on_the_cpu_and_counts_nothing():
    rowptr, m, kw = _segment_inputs("bf16_hilo_w2")
    before = dict(segment_reduce.launches), dict(gather_sum.launches)
    assert torch.equal(segment_reduce(rowptr, m, **kw), segment_reduce_reference(rowptr, m, **kw))
    x = torch.randn(30, 6)
    src = torch.randint(0, 30, (77,), dtype=torch.int32)
    assert torch.equal(gather_sum(x, src), gather_sum_reference(x, src))
    assert (dict(segment_reduce.launches), dict(gather_sum.launches)) == before


def test_rowptr_may_name_a_prefix_of_the_messages():
    rowptr, m, kw = _segment_inputs("f32")
    spare = torch.cat([m, torch.full((3, m.shape[1]), float("nan"))])
    assert torch.equal(segment_reduce(rowptr, spare), segment_reduce(rowptr, m))


def _bad_segment_calls():
    rowptr, m, _ = _segment_inputs("f32", d=4)
    e, n = m.shape[0], rowptr.shape[0] - 1
    wh = torch.ones(e, dtype=torch.bfloat16)
    out = torch.zeros(n + 2, 4)
    return {
        "f16 messages": (TypeError, lambda: segment_reduce(rowptr, m.half())),
        "int64 rowptr": (TypeError, lambda: segment_reduce(rowptr.long(), m)),
        "empty rowptr": (ValueError, lambda: segment_reduce(rowptr[:0], m)),
        "rowptr past the messages": (ValueError, lambda: segment_reduce(rowptr, m[:-1].contiguous())),
        "2-d rowptr": (ValueError, lambda: segment_reduce(rowptr[None], m)),
        "strided messages": (ValueError, lambda: segment_reduce(rowptr, m.t().contiguous().t())),
        "odd halves": (ValueError, lambda: segment_reduce(rowptr, m[:, :3].contiguous(), halves=2)),
        "halves 3": (ValueError, lambda: segment_reduce(rowptr, m, halves=3)),
        "f32 wh": (TypeError, lambda: segment_reduce(rowptr, m, wh=wh.float())),
        "short wh": (ValueError, lambda: segment_reduce(rowptr, m, wh=wh[1:])),
        "wl alone": (ValueError, lambda: segment_reduce(rowptr, m, wl=wh)),
        "no such form": (ValueError, lambda: segment_reduce(rowptr, m, wh=wh)),
        "out too short": (ValueError, lambda: segment_reduce(rowptr, m, out=out, row_offset=3)),
        "out too narrow": (ValueError, lambda: segment_reduce(rowptr, m, out=out[:, :3].contiguous())),
        "f64 out": (TypeError, lambda: segment_reduce(rowptr, m, out=out.double())),
        "offset without out": (ValueError, lambda: segment_reduce(rowptr, m, row_offset=1)),
        "meta messages": (ValueError, lambda: segment_reduce(rowptr, m.to("meta"))),
    }


@pytest.mark.parametrize("case", sorted(_bad_segment_calls()))
def test_segment_reduce_rejects_bad_input(case):
    exc, call = _bad_segment_calls()[case]
    with pytest.raises(exc):
        call()


@pytest.mark.parametrize("case", ["f64 x", "int64 src", "2-d src", "strided x", "meta x"])
def test_gather_sum_rejects_bad_input(case):
    x = torch.randn(10, 4)
    src = torch.tensor([1, 2, 9], dtype=torch.int32)
    exc, call = {
        "f64 x": (TypeError, lambda: gather_sum(x.double(), src)),
        "int64 src": (TypeError, lambda: gather_sum(x, src.long())),
        "2-d src": (ValueError, lambda: gather_sum(x, src[None])),
        "strided x": (ValueError, lambda: gather_sum(x.t(), src)),
        "meta x": (ValueError, lambda: gather_sum(x.to("meta"), src.to("meta"))),
    }[case]
    with pytest.raises(exc):
        call()


def test_dst_order_is_stable_with_its_row_pointer():
    dst = torch.tensor([4, 1, 4, 0, 1, 4])
    order, rowptr = dst_order(dst, 6)
    assert order.tolist() == [3, 1, 4, 0, 2, 5]
    assert rowptr.dtype == torch.int32 and rowptr.tolist() == [0, 1, 3, 3, 3, 6, 6]
    with pytest.raises(ValueError):
        dst_order(dst, 4)


# -- the harnesses on the CPU ------------------------------------------------------


@pytest.mark.parametrize("harness", ["exp_spmm", "exp_gather_dma", "exp_acc_alias"])
def test_harness_runs_on_the_cpu(harness, capsys):
    argv = {
        "exp_spmm": ["--graph", "400,6,16", "--check", "--perf", "--micro7", "--micro9"],
        "exp_gather_dma": ["--n", "500", "--d", "37", "--e", "300", "1001"],
        "exp_acc_alias": [],
    }[harness]
    {"exp_spmm": exp_spmm, "exp_gather_dma": exp_gather_dma, "exp_acc_alias": exp_acc_alias}[
        harness
    ].main(argv + ["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "host clock, cpu" in printed or harness == "exp_acc_alias"
    assert "max rel err" in printed or "err " in printed
    assert "TB/s" not in printed  # no rate against the card's bound from a CPU run


def test_gather_probe_bound_counts_each_distinct_row_once():
    # 4 ids naming 3 rows of 8 f32: 3 rows, 4 ids, one output row
    assert exp_gather_dma.bound_bytes(3, 4, 8) == 3 * 32 + 16 + 32
    # the probe's table: 2^20 ids over 2^20 rows name ~(1 - 1/e) of them
    src = torch.randint(0, 1 << 20, (1 << 20,), generator=torch.Generator().manual_seed(0))
    assert torch.unique(src).numel() / (1 << 20) == pytest.approx(1 - np.exp(-1), abs=2e-3)


def test_gather_probe_prints_the_rate_in_tb_per_s():
    # 3.35 GB in 2 ms is 1.675 TB/s; a 1 ms bound is half the time taken
    note = exp_gather_dma.rate_note(3_350_000_000, 2.0, 1.0)
    assert note.startswith("1.675 TB/s = 50.0% of the bound 1.0000 ms at 3.35 TB/s")


def test_gather_probe_library_call_is_the_same_function():
    x = torch.randn(50, 7, generator=torch.Generator().manual_seed(1))
    src = torch.tensor([3, 3, 49, 0, 7, 3], dtype=torch.int32)
    got = exp_gather_dma.library_sum(x, src)
    assert got.shape == (1, 7)
    torch.testing.assert_close(got, gather_sum_reference(x, src), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("harness", [exp_spmm, exp_gather_dma, exp_acc_alias],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_harness_runs_on_the_gpu_by_default(harness):
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU refusal; this machine has a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        harness.main([])
