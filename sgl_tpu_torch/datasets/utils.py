"""Dataset parsing helpers — counterpart of ``sgl_tpu/datasets/utils.py``:
the download of a raw file, the Planetoid, npz, OGB and TU parsers'
helpers, and the 60/20/20 random split."""

from __future__ import annotations

import gzip
import http.client
import os
import pickle
import ssl
import urllib.request
from typing import Tuple

import numpy as np
import scipy.sparse as sp


def download_to(url: str, path: str) -> None:
    """Fetch ``url`` into ``path``.  Raises ``IOError`` naming both when the
    fetch fails (no network): place the file at ``path`` by hand then."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".part"  # renamed into place only when whole
    try:
        context = ssl._create_unverified_context()
        data = urllib.request.urlopen(url, context=context, timeout=30)
        with open(tmp, "wb") as wf:
            wf.write(data.read())
        os.replace(tmp, path)
    except (OSError, ValueError, http.client.HTTPException) as e:  # no network, a bad URL or reply
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise IOError(f"cannot download {url} (offline?); place the file at {path}") from e


def pkl_read_file(filepath: str):
    """Unpickle a raw file of the Planetoid format (Python 2 pickles: latin1)."""
    with open(filepath, "rb") as rf:
        return pickle.load(rf, encoding="latin1")


def row_normalize(mx: sp.spmatrix) -> sp.spmatrix:
    """Each row divided by its sum (rows that sum to 0 stay 0)."""
    rowsum = np.asarray(mx.sum(1)).flatten()
    r_inv = np.divide(1.0, rowsum, out=np.zeros_like(rowsum, dtype=float), where=rowsum != 0)
    return sp.diags(r_inv) @ mx


def undirect_and_clean(src: np.ndarray, dst: np.ndarray):
    """Remove self loops, add reversed edges, dedup; the pairs come back
    sorted by (src, dst)."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    pairs = np.unique(np.stack([s, d], axis=1), axis=0)
    return pairs[:, 0], pairs[:, 1]


def random_split_dataset(n_samples: int, seed=None):
    """60/20/20 random split: validation drawn first, then test from the
    rest; train is what remains (sorted)."""
    rng = np.random.default_rng(seed)
    val_idx = rng.choice(n_samples, size=int(n_samples * 0.2), replace=False)
    remain = np.setdiff1d(np.arange(n_samples), val_idx)
    test_idx = rng.choice(remain, size=int(n_samples * 0.2), replace=False)
    train_idx = np.setdiff1d(remain, test_idx)
    return train_idx, val_idx, test_idx


def read_npz(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """A gnn-benchmark npz (Amazon, Coauthor): ``(x, src, dst, y)`` with the
    features binarized to float32 and the edges undirected and cleaned."""
    with np.load(path, allow_pickle=True) as f:
        x = sp.csr_matrix((f["attr_data"], f["attr_indices"], f["attr_indptr"]), f["attr_shape"]).toarray()
        x = (x > 0).astype(np.float32)
        adj = sp.csr_matrix((f["adj_data"], f["adj_indices"], f["adj_indptr"]), f["adj_shape"]).tocoo()
        src, dst = undirect_and_clean(adj.row.astype(np.int64), adj.col.astype(np.int64))
        y = f["labels"].astype(np.int64)
    return x, src, dst, y


def read_csv_gz(path: str, dtype=np.float32) -> np.ndarray:
    """A headerless csv, gzipped or not (the OGB and TU raw formats), as a
    2-D array: the native parser first (``graph/native.py::load_csv_native``),
    else ``numpy.loadtxt``; the arrays are the same."""
    from sgl_tpu_torch.graph.native import load_csv_native

    out = load_csv_native(path, dtype)
    if out is not None:
        return out
    return read_csv_numpy(path, dtype)


def read_csv_numpy(path: str, dtype=np.float32) -> np.ndarray:
    """:func:`read_csv_gz` by ``numpy.loadtxt`` alone (the fallback)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)


def read_index_csv_gz(path: str) -> np.ndarray:
    """A one-column integer csv as a flat int64 array."""
    return read_csv_gz(path, dtype=np.int64).reshape(-1)
