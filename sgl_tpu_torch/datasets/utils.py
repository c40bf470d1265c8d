"""Dataset parsing helpers — counterpart of ``sgl_tpu/datasets/utils.py``
(the ones the Planetoid and TU loaders need, and the 60/20/20 random
split)."""

from __future__ import annotations

import gzip
import pickle

import numpy as np
import scipy.sparse as sp


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


def read_csv_gz(path: str, dtype=np.float32) -> np.ndarray:
    """A headerless csv, gzipped or not (the OGB and TU raw formats), as a
    2-D array.  ``sgl_tpu`` parses with a native loader when it builds and
    falls back to this ``numpy.loadtxt``; the arrays are the same."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)


def read_index_csv_gz(path: str) -> np.ndarray:
    """A one-column integer csv as a flat int64 array."""
    return read_csv_gz(path, dtype=np.int64).reshape(-1)
