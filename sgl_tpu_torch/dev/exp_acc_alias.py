"""Accumulate in place at a row offset: the port of ``dev/exp_acc_alias.py``
(TPU kernel D2).

    python -m sgl_tpu_torch.dev.exp_acc_alias [--device cpu]

The JAX probe adds 6 chunks of 64 bf16 message rows, each chunk's
destinations unsorted within one 128-row tile, into an f32 accumulator of
8 tiles at an offset of 2 tiles, through a Pallas output aliased to the
accumulator input, and asks which ``input_output_aliases`` index that
aliasing needs under scalar prefetch (4, counting the prefetch operands,
or 2).  That question has no counterpart in PyTorch: nothing aliases a
kernel's output to an input there, the kernel is handed ``out`` and writes
into it.  So this probe checks what the alias was for, on the same inputs:
the result *is* the accumulator (same storage), every row no message
reaches keeps its bits, and the rows that messages reach equal the
accumulator plus their messages.

The messages go through :func:`~sgl_tpu_torch.kernels.dst_order` (a stable
sort by destination) and then the accumulating segment-reduce kernel, so
each row adds its messages in their original order, as one sum, and then
adds that sum to the accumulator; the JAX probe's reference adds them one
by one.  The two orders agree within :data:`TOL` of max|expected|.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from sgl_tpu_torch.dev import rel_err
from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.kernels import dst_order, segment_reduce

#: the JAX probe's shapes: chunk, features, chunks, tiles the chunks use,
#: tiles of the accumulator, offset in tiles, rows per tile
CHUNK, D, N_CHUNKS, N_TILES, TOTAL_TILES, OFF_TILES, TILE_R = 64, 128, 6, 3, 8, 2, 128
#: touched rows against the one-by-one f32 reference, of max|expected|
TOL = 1e-5


def make_inputs(seed: int = 0):
    """The JAX probe's inputs, drawn in its order: ``dst`` int32
    ``[N_CHUNKS, 1, CHUNK]`` (rows of the window ``[0, N_TILES·128)``,
    unsorted within each chunk's tile), ``hi`` f32 ``[N_CHUNKS, CHUNK, D]``
    holding bf16 values, and ``acc`` f32 ``[TOTAL_TILES·128, D]``."""
    rng = np.random.default_rng(seed)
    ct = np.sort(rng.integers(0, N_TILES, N_CHUNKS)).astype(np.int32)
    dst = rng.integers(0, TILE_R, (N_CHUNKS, 1, CHUNK)).astype(np.int32) + ct[:, None, None] * TILE_R
    hi = torch.from_numpy(rng.normal(size=(N_CHUNKS, CHUNK, D)).astype(np.float32))
    hi = hi.to(torch.bfloat16).float().numpy()  # round to nearest even, as ml_dtypes does
    acc = rng.normal(size=(TOTAL_TILES * TILE_R, D)).astype(np.float32)
    return dst, hi, acc


def expected(dst, hi, acc) -> np.ndarray:
    """The JAX probe's reference: each message added to ``acc`` one by one,
    in chunk order, at its row plus the offset."""
    out = acc.copy()
    np.add.at(out, dst.reshape(-1) + OFF_TILES * TILE_R, hi.reshape(-1, D))
    return out


def probe(device=None, seed: int = 0) -> dict:
    """Run the accumulate contract on ``device`` (the GPU by default);
    raises if it fails.  Returns the counts and the error."""
    device = resolve_device(device)
    dst, hi, acc_np = make_inputs(seed)
    want = torch.from_numpy(expected(dst, hi, acc_np))
    order, rowptr = dst_order(torch.from_numpy(dst.reshape(-1)), N_TILES * TILE_R)
    m = torch.from_numpy(hi.reshape(-1, D))[order].to(device, torch.bfloat16).contiguous()
    acc = torch.from_numpy(acc_np).to(device)
    ptr = acc.data_ptr()
    got = segment_reduce(rowptr.to(device), m, out=acc, row_offset=OFF_TILES * TILE_R)
    if got is not acc or got.data_ptr() != ptr:
        raise RuntimeError("segment_reduce(out=acc) did not return acc's own storage")
    got = got.cpu()
    touched = torch.zeros(acc_np.shape[0], dtype=torch.bool)
    touched[torch.from_numpy(dst.reshape(-1)).long() + OFF_TILES * TILE_R] = True
    if not torch.equal(got[~touched], torch.from_numpy(acc_np)[~touched]):
        raise RuntimeError("rows no message reaches changed")
    err = rel_err(got[touched], want[touched])[1]
    if err > TOL:
        raise RuntimeError(f"touched rows disagree with the one-by-one reference: {err:.3e}")
    n_touched = int(touched.sum())
    print(f"accumulate in place: result is acc's storage; {acc_np.shape[0] - n_touched} rows no "
          f"message reaches bit-exact; {n_touched} touched rows max rel err {err:.2e} "
          f"(limit {TOL:.0e}); input_output_aliases index: no counterpart in PyTorch "
          f"(the kernel writes into the out it is handed), not tested", flush=True)
    return dict(err=err, touched=n_touched, untouched=acc_np.shape[0] - n_touched)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="the GPU unless 'cpu'")
    args = ap.parse_args(argv)
    probe(args.device)


if __name__ == "__main__":
    main()
