"""The gather rate of the card: the port of ``dev/exp_gather_dma.py`` (TPU
kernel D1).

    python -m sgl_tpu_torch.dev.exp_gather_dma [--n 1048576] [--d 128]
        [--e 262144 1048576] [--device cpu]

The JAX probe asked how fast a TPU kernel can gather rows itself, one DMA
per row from HBM into VMEM, against XLA's gather (~3.5 ns/row there).  Its
chunk and DMA-depth sweep has no counterpart on a GPU, whose loads need no
descriptors: this probe times :func:`~sgl_tpu_torch.kernels.gather_sum`,
``out[1, D] = Σ_e x[src_e]`` over an f32 ``x`` of ``n`` rows (512 MB at the
defaults, ten times the L2) and ``E`` random ids, and prints the ns per
gathered row and, on the card, the rate against the byte bound (each
distinct row once, the ids and the output row, at 3.35 TB/s).  Each result
is held against the plain version first.  Beside them it times one PyTorch
call for the same function, ``embedding_bag`` with the ids as one bag, as a
yardstick only.
"""

from __future__ import annotations

import argparse

import torch

from sgl_tpu_torch.dev import HBM_BYTES_PER_S, device_label, rel_err, time_ms
from sgl_tpu_torch.device import resolve_device
from sgl_tpu_torch.kernels import gather_sum, gather_sum_reference

#: the JAX probe's table: 2^20 rows of 128 f32, 2^18 and 2^20 edges
N, D, ES = 1 << 20, 128, (1 << 18, 1 << 20)
#: kernel against plain version, of max|y|: two f32 orders of one long sum
TOL = 1e-5


def bound_bytes(distinct: int, e: int, d: int) -> int:
    """Compulsory bytes of ``gather_sum`` over ``e`` ids naming ``distinct``
    rows of ``d`` f32: each distinct row once (a repeated id needs no second
    read), the ids, and the output row."""
    return distinct * d * 4 + 4 * e + 4 * d


def rate_note(nbytes: int, ms: float, bound_ms: float) -> str:
    """``nbytes`` moved in ``ms``, as a rate and as a share of the bound."""
    return (f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s = {bound_ms / ms:.1%} of the bound "
            f"{bound_ms:.4f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")


def library_sum(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The same function in one PyTorch call (the yardstick, used nowhere in
    the port): ``embedding_bag`` over one bag of all the ids."""
    return torch.nn.functional.embedding_bag(src[None], x, mode="sum")


def probe(n: int = N, d: int = D, es=ES, device=None, seed: int = 0) -> list:
    """Time ``gather_sum`` for each ``E`` in ``es``; returns one dict per
    ``E`` (``e``, ``distinct`` ids, ``ms``, ``plain_ms``, ``library_ms``,
    ``ns_per_row``, ``bound_ms``, ``err`` relative to max|y|, ``abs_err``,
    ``library_err``).  Raises if the kernel disagrees with its plain
    version; the library call's error is reported, not held to a limit."""
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(seed)
    x = torch.randn(n, d, generator=gen, device=device)
    print(f"x: {n} rows x {d} f32 ({x.numel() * 4 / 1e6:.0f} MB); {device_label(device)}", flush=True)
    results = []
    for e in es:
        src = torch.randint(0, n, (e,), generator=gen, device=device, dtype=torch.int32)
        got, want = gather_sum(x, src), gather_sum_reference(x, src)
        abs_err, err = rel_err(got, want)
        if err > TOL:
            raise RuntimeError(f"gather_sum disagrees with its plain version at E={e}: {err:.3e}")
        library_err = rel_err(library_sum(x, src), want)[1]
        ms = time_ms(lambda: gather_sum(x, src), device)
        plain_ms = time_ms(lambda: gather_sum_reference(x, src), device)
        library_ms = time_ms(lambda: library_sum(x, src), device, 1, 5)
        distinct = torch.unique(src).numel()
        nbytes = bound_bytes(distinct, e, d)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        results.append(dict(e=e, distinct=distinct, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            ns_per_row=ms * 1e6 / e, bound_ms=bound_ms, err=err, abs_err=abs_err,
                            library_err=library_err))
        # the bound is the card's: a rate against it means nothing elsewhere
        rate = f"; {rate_note(nbytes, ms, bound_ms)}" if device.type == "cuda" else ""
        print(f"E={e} ({distinct} distinct rows): {ms * 1e6 / e:.4f} ns/row ({ms:.4f} ms{rate}); "
              f"plain version {plain_ms:.4f} ms; embedding_bag {library_ms:.4f} ms "
              f"(max rel err {library_err:.2e}); max rel err {err:.2e} (limit {TOL:.0e})", flush=True)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--d", type=int, default=D)
    ap.add_argument("--e", type=int, nargs="+", default=list(ES))
    ap.add_argument("--device", default=None, help="the GPU unless 'cpu'")
    args = ap.parse_args(argv)
    probe(args.n, args.d, args.e, args.device)


if __name__ == "__main__":
    main()
