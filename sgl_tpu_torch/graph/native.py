"""ctypes bridge to the native graph builder (``graph/csrc/graph_builder.cpp``).

Counterpart of ``sgl_tpu/graph/native.py`` for what the port's graph layer
needs: the stable sort of edges by destination, degrees, normalized
weights, a parallel row gather and the sort of edges into the cells of the
2-D out-of-core layout, all on the host.  The library is the
port's own copy of those C++ functions, built at first use with
``g++ -O3 -fopenmp -shared -fPIC`` into ``sgl_tpu_torch/_build/``
(``kernels/_build.py::build_host``).  Every entry point keeps a numpy
fallback that gives the same result (the sort: a stable ``argsort`` by
dst, the same order); :func:`native_available` says which one runs.

The csv parser (:func:`load_csv_native`, ``graph/csrc/csv_loader.cpp``,
the port's own copy of ``sgl_tpu/csrc/csv_loader.cpp``) is a library of
its own, so that a host without zlib keeps the graph builder: it is built
with zlib when it can be (``-DSGL_CSV_ZLIB -lz``; the file is streamed
and inflated in C++) and else without (Python inflates, the parse stays
native).  Its callers fall back to ``numpy.loadtxt``.
"""

from __future__ import annotations

import ctypes
import functools
import gzip
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import numpy.ctypeslib as ctl

from sgl_tpu_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "graph_builder.cpp"
CSV_SOURCE = Path(__file__).resolve().parent / "csrc" / "csv_loader.cpp"
# dtype codes of sgl_csv_load / sgl_csv_parse
_CSV_DTYPES = {np.dtype(np.float32): 0, np.dtype(np.int64): 1}


@functools.cache
def _load() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None when it cannot be built or
    loaded (the numpy fallbacks run then)."""
    try:
        lib = ctypes.CDLL(str(_build.build_host(SOURCE)))
    except (RuntimeError, OSError, FileNotFoundError):
        return None
    i32 = ctl.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32 = ctl.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.sgl_sort_edges_by_dst.argtypes = [i32, i32, f32, ctypes.c_int64, ctypes.c_int32, i32, i32, f32]
    lib.sgl_compute_degrees.argtypes = [i32, f32, ctypes.c_int64, ctypes.c_int32, f32]
    lib.sgl_normalized_weights.argtypes = [i32, i32, f32, ctypes.c_int64, f32, ctypes.c_float, f32]
    lib.sgl_gather_rows.argtypes = [ctypes.c_void_p, ctypes.c_int64, i32, ctypes.c_int64, ctypes.c_void_p]
    i64 = ctl.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.sgl_classify_sort_cells_2d.argtypes = [
        i32, i32, f32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i32, ctypes.c_int32, i32, i32, f32, i64,
    ]
    for fn in ("sgl_sort_edges_by_dst", "sgl_compute_degrees", "sgl_normalized_weights", "sgl_gather_rows",
               "sgl_classify_sort_cells_2d"):
        getattr(lib, fn).restype = None
    return lib


def native_available() -> bool:
    """True when the native library is built and loaded; False when the
    numpy fallbacks run."""
    return _load() is not None


def sort_edges_by_dst(
    src: np.ndarray, dst: np.ndarray, val: np.ndarray, num_nodes: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stable parallel counting sort of COO edges by dst: within a dst, the
    input order is kept (fallback: ``np.argsort(dst, kind="stable")``)."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    val = np.ascontiguousarray(val, np.float32)
    lib = _load()
    if lib is None:
        order = np.argsort(dst, kind="stable")
        return src[order], dst[order], val[order]
    n = src.shape[0]
    out_src = np.empty(n, np.int32)
    out_dst = np.empty(n, np.int32)
    out_val = np.empty(n, np.float32)
    lib.sgl_sort_edges_by_dst(src, dst, val, n, num_nodes, out_src, out_dst, out_val)
    return out_src, out_dst, out_val


def compute_degrees(src: np.ndarray, val: np.ndarray, num_nodes: int) -> np.ndarray:
    """f32 ``deg[i] = Σ val[e]`` over the edges with ``src[e] == i``."""
    src = np.ascontiguousarray(src, np.int32)
    val = np.ascontiguousarray(val, np.float32)
    deg = np.zeros(num_nodes, np.float32)
    lib = _load()
    if lib is None:
        np.add.at(deg, src, val)
        return deg
    lib.sgl_compute_degrees(src, val, src.shape[0], num_nodes, deg)
    return deg


def normalized_weights(
    src: np.ndarray, dst: np.ndarray, val: np.ndarray, deg: np.ndarray, r: float
) -> np.ndarray:
    """``w[e] = deg[dst]^(r-1) · val[e] · deg[src]^(-r)``, 0 where a degree is 0."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    val = np.ascontiguousarray(val, np.float32)
    deg = np.ascontiguousarray(deg, np.float32)
    lib = _load()
    if lib is None:
        with np.errstate(divide="ignore"):
            left = np.where(deg > 0, deg ** (r - 1.0), 0.0)
            right = np.where(deg > 0, deg ** (-r), 0.0)
        return (left[dst] * val * right[src]).astype(np.float32)
    out = np.empty(src.shape[0], np.float32)
    lib.sgl_normalized_weights(src, dst, val, src.shape[0], deg, r, out)
    return out


def gather_rows(x: np.ndarray, idx: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """``x[idx]`` as a parallel native row gather (fallback: ``np.take``)."""
    x = np.ascontiguousarray(x)
    idx = np.ascontiguousarray(idx, np.int32)
    lib = _load()
    if lib is None:
        return np.take(x, idx, axis=0, out=out)
    # the C gather copies raw rows: an index out of range would read
    # arbitrary memory where numpy raises
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= x.shape[0]):
        raise IndexError(
            f"gather_rows: index out of range [0, {x.shape[0]}) "
            f"(got min {int(idx.min())}, max {int(idx.max())})"
        )
    expect = (idx.shape[0],) + x.shape[1:]
    if out is None:
        out = np.empty(expect, x.dtype)
    elif out.shape != expect or out.dtype != x.dtype or not out.flags["C_CONTIGUOUS"]:
        raise ValueError(
            f"gather_rows: out must be C-contiguous {expect} {x.dtype} (got {out.shape} "
            f"{out.dtype}, contiguous={out.flags['C_CONTIGUOUS']})"
        )
    row_bytes = x.nbytes // max(x.shape[0], 1)
    lib.sgl_gather_rows(
        x.ctypes.data_as(ctypes.c_void_p), row_bytes, idx, idx.shape[0],
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def classify_sort_cells_2d(src, dst, w, sb: int, k: int, part_of_row):
    """Sort edges by the cell of the 2-D out-of-core layout, stably: cell key
    ``part_of_row[dst] * k + src // sb`` (the edge's destination part times
    the block count ``k``, plus its source block of ``sb`` rows).  Inside a
    cell the input order is kept, so dst-sorted input stays dst order.
    Returns ``(src, dst, w, cell_counts)`` in cell order, ``cell_counts``
    int64 of ``(part_of_row[-1] + 1) * k`` cells (fallback: a stable
    ``argsort`` by the key, the same arrays)."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    w = np.ascontiguousarray(w, np.float32)
    part_of_row = np.ascontiguousarray(part_of_row, np.int32)
    n = src.shape[0]
    n_keys = (int(part_of_row[-1]) + 1) * k if part_of_row.size else k
    if n_keys >= 2**31:
        raise ValueError(f"{n_keys} cells overflow the int32 cell count")
    lib = _load()
    if lib is None:
        key = part_of_row[dst].astype(np.int64) * k + src // np.int32(sb)
        order = np.argsort(key, kind="stable")
        return src[order], dst[order], w[order], np.bincount(key, minlength=n_keys).astype(np.int64)
    o_src = np.empty(n, np.int32)
    o_dst = np.empty(n, np.int32)
    o_w = np.empty(n, np.float32)
    cell_counts = np.empty(n_keys, np.int64)
    lib.sgl_classify_sort_cells_2d(src, dst, w, n, sb, k, part_of_row, n_keys, o_src, o_dst, o_w, cell_counts)
    return o_src, o_dst, o_w, cell_counts


def build_normalized_adj_host(src, dst, val, num_nodes: int, r: float = 0.5):
    """The whole normalized-adjacency build on the host: append the self
    loops, sum degrees, normalize, sort by dst.  Returns dst-sorted
    ``(src, dst, w)`` numpy arrays."""
    loop = np.arange(num_nodes, dtype=np.int32)
    s = np.concatenate([np.asarray(src, np.int32), loop])
    d = np.concatenate([np.asarray(dst, np.int32), loop])
    v = np.concatenate([np.asarray(val, np.float32), np.ones(num_nodes, np.float32)])
    deg = compute_degrees(s, v, num_nodes)
    w = normalized_weights(s, d, v, deg, r)
    return sort_edges_by_dst(s, d, w, num_nodes)


@functools.cache
def _load_csv() -> Optional[Tuple[ctypes.CDLL, bool]]:
    """``(library, has_zlib)``: the csv parser built with zlib, or without
    it when that build fails; None when neither builds or loads."""
    for flags, libs in ((["-DSGL_CSV_ZLIB"], ["-lz"]), ([], [])):
        try:
            lib = ctypes.CDLL(str(_build.build_host(CSV_SOURCE, flags, libs)))
        except (RuntimeError, OSError, FileNotFoundError):
            continue
        out = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.sgl_csv_load.argtypes = [ctypes.c_char_p, ctypes.c_int, *out]
        lib.sgl_csv_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, *out]
        lib.sgl_csv_load.restype = lib.sgl_csv_parse.restype = ctypes.c_int64
        lib.sgl_csv_has_zlib.argtypes = []
        lib.sgl_csv_has_zlib.restype = ctypes.c_int
        lib.sgl_buf_free.argtypes = [ctypes.c_void_p]
        lib.sgl_buf_free.restype = None
        return lib, bool(lib.sgl_csv_has_zlib())
    return None


def csv_native_available() -> bool:
    """True when the native csv parser is built and loaded."""
    return _load_csv() is not None


def csv_native_zlib() -> bool:
    """True when the native csv parser was built with zlib (it streams and
    inflates the file itself); False when Python inflates for it or it is
    missing."""
    found = _load_csv()
    return found is not None and found[1]


def load_csv_native(path: str, dtype=np.float32) -> Optional[np.ndarray]:
    """A headerless numeric csv or csv.gz parsed by the native parser, as a
    2-D array; None when the parser is missing, the dtype is neither
    float32 nor int64, or the text does not fit its strict numeric dialect
    (callers fall back to ``numpy.loadtxt``)."""
    dtype = np.dtype(dtype)
    code = _CSV_DTYPES.get(dtype)
    found = _load_csv()
    if found is None or code is None:
        return None
    lib, zlib = found
    data, rows, cols = ctypes.c_void_p(), ctypes.c_int64(), ctypes.c_int64()
    refs = (ctypes.byref(data), ctypes.byref(rows), ctypes.byref(cols))
    if zlib:
        status = lib.sgl_csv_load(str(path).encode(), code, *refs)
    else:
        # gzread reads a plain file unchanged: inflate only gzip data
        with open(path, "rb") as f:
            text = f.read()
        if text[:2] == b"\x1f\x8b":
            text = gzip.decompress(text)
        status = lib.sgl_csv_parse(text, len(text), code, *refs)
    try:
        if status != 0:
            return None
        n = rows.value * cols.value
        if n == 0:
            return np.zeros((rows.value, cols.value), dtype)
        buf = (ctypes.c_char * (n * dtype.itemsize)).from_address(data.value)
        return np.frombuffer(buf, dtype=dtype).reshape(rows.value, cols.value).copy()
    finally:
        if data.value:
            lib.sgl_buf_free(data)
