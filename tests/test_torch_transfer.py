"""The staged host-to-card upload (``sgl_tpu_torch/utils/transfer.py``) on
the CPU: its chunk loop runs through a ring of plain (unpinned) slots into a
CPU destination, and gives ``torch.as_tensor``'s tensor bit for bit; the
``sgl.h2d_bytes`` counter names the path the bytes took."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sgl_tpu_torch.kernels.spmm_ooc import PinnedRing
from sgl_tpu_torch.utils import profiling, transfer

CPU = torch.device("cpu")
SLOT = 64  # bytes of a test ring's slot


def ring(slots=2):
    return PinnedRing(slots, SLOT, pin=False)


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    if got.dtype != want.dtype or got.shape != want.shape or not got.is_contiguous():
        return False
    return got.numel() == 0 or torch.equal(got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8))


def upload(x, dtype=None, min_bytes=0, r=None):
    """``transfer._upload`` onto the CPU inside a recorded span; returns
    the result and the span's counts."""
    with profiling.recording(), profiling.span("test.upload") as rec:
        out = transfer._upload(x, CPU, dtype, r or ring(), min_bytes)
    return out, rec["counts"]


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.float64])
@pytest.mark.parametrize("slots_long", [0, "1", -1, 1, 3.5])
def test_staged_upload_is_as_tensor_bit_for_bit(dtype, slots_long):
    """Lengths 0, 1, a slot less one element, a slot and one, 3.5 slots."""
    per = SLOT // np.dtype(dtype).itemsize
    n = {0: 0, "1": 1, -1: per - 1, 1: per + 1, 3.5: int(3.5 * per)}[slots_long]
    a = (np.random.default_rng(n).standard_normal(n) * 1e6).astype(dtype)
    got, counts = upload(a)
    assert same_bits(got, torch.as_tensor(a))
    assert counts["sgl.h2d_bytes[kind=staged]"] == a.nbytes == counts["sgl.h2d_bytes"]


def test_non_contiguous_memmap_and_cpu_tensor_inputs(tmp_path):
    rng = np.random.default_rng(1)
    base = rng.standard_normal((37, 10)).astype(np.float32)
    strided = base[:, ::3]  # rows of 4 elements, 12 bytes apart
    assert not strided.flags.c_contiguous
    path = tmp_path / "x.npy"
    np.save(path, base)
    memmap = np.load(path, mmap_mode="r")  # read-only
    assert not memmap.flags.writeable
    tensor = torch.from_numpy(base.copy())
    for x, want in (
        (strided, torch.as_tensor(strided)),
        (memmap, torch.as_tensor(np.array(memmap))),
        (memmap[::-2], torch.as_tensor(np.array(memmap[::-2]))),  # negative strides, read-only
        (tensor, tensor),
        (tensor.t(), tensor.t().contiguous()),
        (tensor[:, 1:4], tensor[:, 1:4].contiguous()),
    ):
        got, counts = upload(x, r=PinnedRing(2, 160, pin=False))  # a row of tensor.t() is 148 bytes
        assert same_bits(got, want)  # row-major, as torch.as_tensor makes a slice of rows
        assert counts["sgl.h2d_bytes[kind=staged]"] == want.nbytes


def test_a_cast_happens_on_the_host_as_the_direct_copy_makes_it():
    a = np.random.default_rng(2).standard_normal(101)
    got, counts = upload(torch.from_numpy(a), dtype=torch.float32)
    assert same_bits(got, torch.as_tensor(a, dtype=torch.float32))
    assert counts["sgl.h2d_bytes[kind=staged]"] == 101 * 4
    # numpy's casts are not torch's: a read-only array to cast goes direct
    a.flags.writeable = False
    got, counts = upload(a, dtype=torch.float32)
    assert same_bits(got, torch.as_tensor(np.array(a), dtype=torch.float32))
    assert counts == {"sgl.h2d_bytes": 101 * 4, "sgl.h2d_bytes[kind=direct]": 101 * 4}


def test_the_counter_names_the_path_and_totals_the_bytes():
    a = np.arange(100, dtype=np.int32)  # 400 bytes
    wide = np.zeros((3, SLOT // 4 + 1), np.float32)  # a row wider than a slot
    with profiling.recording(), profiling.span("test.uploads") as rec:
        r = ring()
        transfer._upload(a, CPU, None, r, 400)  # at the threshold: staged
        transfer._upload(a, CPU, None, r, 401)  # below it: direct
        transfer._upload(wide, CPU, None, r, 0)  # direct
        transfer._upload([1.0, 2.0], CPU, None, r, 0)  # not a host array: direct
        transfer._upload(np.float64(3.0) * np.ones(()), CPU, None, r, 0)  # 0-d: direct
    assert rec["counts"] == {
        "sgl.h2d_bytes": 400 + 400 + wide.nbytes + 8 + 8,
        "sgl.h2d_bytes[kind=staged]": 400,
        "sgl.h2d_bytes[kind=direct]": 400 + wide.nbytes + 8 + 8,
    }


def test_an_input_on_the_target_device_is_returned_without_a_copy_or_a_count():
    t = torch.arange(1 << 20, dtype=torch.float32)
    a = np.arange(1 << 20, dtype=np.int32)
    with profiling.recording(), profiling.span("test.on_device") as rec:
        assert transfer.to_device(t, "cpu") is t
        got = transfer.to_device(a, CPU)
        assert got.data_ptr() == a.ctypes.data  # a view of the array, as torch.as_tensor gives
        assert transfer.to_device(t, CPU, torch.float64).dtype == torch.float64
        assert transfer.to_device_nonblocking(a, CPU).data_ptr() == a.ctypes.data
    assert rec["counts"] == {}


def test_the_ring_reuses_its_slots_across_dtypes_and_stays_bounded():
    r = ring(slots=3)
    for dtype in (np.int32, np.float32, np.float64, np.int64, np.float32):
        a = np.ones(int(7.5 * SLOT), dtype)
        assert same_bits(upload(a, r=r)[0], torch.as_tensor(a))
        assert r.nbytes == 3 * SLOT
    ptrs = [r.take((SLOT // 4,), torch.int32)[0].data_ptr() for _ in range(3)]
    assert [r.take((SLOT // 8,), torch.float64)[0].data_ptr() for _ in range(3)] == ptrs
    # a larger shape grows its slot
    assert r.take((SLOT,), torch.int32)[0].numel() == SLOT and r.nbytes == 6 * SLOT


def test_the_call_sites_give_the_same_bits_through_the_chunk_loop(monkeypatch):
    """The graph normalizations, the features' upload of a graph op and the
    no-graph-op precompute, with the helper sending every host array
    through the chunk loop (as on a card), against the direct conversions;
    the loop sees each array the call sites upload."""
    from sgl_tpu_torch.datasets import random_power_law_graph
    from sgl_tpu_torch.graph import normalize
    from sgl_tpu_torch.models import SGC, base
    from sgl_tpu_torch.ops import LaplacianGraphOp, graph_ops

    g = random_power_law_graph(500, 6, 8, seed=3)
    x64 = g.x.astype(np.float64)

    def run():
        model = SGC(prop_steps=2, feat_dim=8, output_dim=3)
        model.pre_graph_op = None
        model.preprocess(g, x64, device="cpu")
        return [
            *normalize.symmetric_normalized_weights(g, device="cpu").__dict__.values(),
            *normalize.row_normalized_weights(g, add_self_loops=False, device="cpu").__dict__.values(),
            LaplacianGraphOp(2).propagate(g, g.x, device="cpu"),
            model.processed_feature,
        ]

    want = run()
    staged = []

    def through_the_loop(x, device, dtype=None):
        out = transfer._upload(x, torch.device(device), dtype, ring(3), 0)
        staged.append(out.nbytes)
        return out

    for module in (normalize, graph_ops, base):
        monkeypatch.setattr(module, "to_device", through_the_loop)
    got = run()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert same_bits(a, b) if isinstance(a, torch.Tensor) else a == b
    edges = [g.src.nbytes, g.dst.nbytes, g.val.nbytes]
    # the precompute's cast x, two normalizations, the graph op's own and its x
    assert staged == [x64.size * 4, *edges, *edges, *edges, g.x.nbytes]
