"""The OGB loaders, the native csv parser and the download flow of the
PyTorch port against ``sgl_tpu``'s, on the CPU.

* OGB fixture directories (``.csv.gz``, ``.csv`` and ``.npy`` raw files,
  ``tests/test_datasets.py``'s layout) parsed by both packages: edges,
  features, labels and splits equal by ``np.array_equal``;
* an ogbn-mag fixture: the same graph, and the neighbour-averaged features
  of the featureless types within 1e-6;
* the native parser equals ``numpy.loadtxt`` (with zlib, and without it:
  Python inflates, the parse stays native), and input it refuses falls
  back to ``numpy.loadtxt``;
* the download flow with ``urlopen`` mocked, and the offline ``IOError``
  that names the file (``tests/test_datasets.py``'s pattern).  No test
  reaches the network: ``urlopen`` is replaced in every one that could.
"""

import gzip
import io
import os
import urllib.request
import zipfile

import numpy as np
import pytest

from sgl_tpu.datasets import Ogbn as JOgbn
from sgl_tpu.datasets.ogbn import OgbnMag as JOgbnMag
from sgl_tpu.datasets.utils import read_npz as j_read_npz
from sgl_tpu_torch.datasets import Ogbn, OgbnMag
from sgl_tpu_torch.datasets import utils as U
from sgl_tpu_torch.graph import native


def _write(path, arr, fmt):
    path = str(path)
    if path.endswith(".npy"):
        np.save(path, arr)
    elif path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            np.savetxt(f, arr, delimiter=",", fmt=fmt)
    else:
        np.savetxt(path, arr, delimiter=",", fmt=fmt)


def _ogbn_fixture(base, name="arxiv", ext=".csv.gz", n=40, seed=0):
    """The OGB raw layout under ``base/ogbn/<name>/ogbn_<name>`` (the
    directory an OGB archive unzips to), in ``ext``."""
    d = base / "ogbn" / name / f"ogbn_{name}"
    split = {"arxiv": "time", "products": "sales_ranking", "papers100M": "time"}[name]
    (d / "raw").mkdir(parents=True, exist_ok=True)
    (d / "split" / split).mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, (3 * n, 2))
    feats = rng.normal(size=(n, 5)).astype(np.float32)
    labels = rng.integers(0, 6, n).astype(np.float64)
    if ext == ".npy":
        labels[::7] = np.nan  # papers100M: unlabeled nodes
    _write(d / "raw" / f"edge{ext}", edges, "%d")
    _write(d / "raw" / f"node-feat{ext}", feats, "%.7g")
    _write(d / "raw" / f"node-label{ext}", labels[:, None], "%d" if ext != ".npy" else "%g")
    perm = rng.permutation(n)
    for part, idx in (("train", perm[: n // 2]), ("valid", perm[n // 2: 3 * n // 4]), ("test", perm[3 * n // 4:])):
        _write(d / "split" / split / f"{part}{ext}", idx[:, None] if ext != ".npy" else idx, "%d")
    return d


def _assert_same(ds, jds):
    g, jg = ds.graph, jds.graph
    assert (g.num_nodes, g.num_edges) == (jg.num_nodes, jg.num_edges)
    for name in ("src", "dst", "val", "x", "y"):
        assert np.array_equal(getattr(g, name), np.asarray(getattr(jg, name))), name
    for name in ("train_idx", "val_idx", "test_idx"):
        assert np.array_equal(np.asarray(getattr(ds, name)), np.asarray(getattr(jds, name))), name


@pytest.mark.parametrize("name,ext", [("arxiv", ".csv.gz"), ("products", ".csv"), ("papers100M", ".npy")])
def test_ogbn_parses_as_sgl_tpu_does(tmp_path, name, ext):
    _ogbn_fixture(tmp_path, name, ext)
    ds = Ogbn(name, root=str(tmp_path) + "/")
    jds = JOgbn(name, root=str(tmp_path) + "/")
    _assert_same(ds, jds)
    assert ds.num_node == 40 and ds.num_features == 5
    s, t, _ = ds.graph.edges()
    pairs = set(zip(s.tolist(), t.tolist()))
    assert all((b, a) in pairs and a != b for a, b in pairs)  # undirected, no self loops
    if ext == ".npy":
        assert (np.asarray(ds.y)[::7] == -1).all()
    _assert_same(Ogbn(name, root=str(tmp_path) + "/"), jds)  # from the pickle cache


def test_ogbn_rejects_unknown_names_and_splits(tmp_path):
    with pytest.raises(ValueError):
        Ogbn("mag", root=str(tmp_path) + "/")
    _ogbn_fixture(tmp_path)
    with pytest.raises(ValueError):
        Ogbn("arxiv", root=str(tmp_path) + "/", split="random")


def _mag_fixture(base, seed=1):
    d = base / "ogbn" / "mag" / "ogbn_mag" / "raw"
    rng = np.random.default_rng(seed)
    counts = {"author": 30, "field_of_study": 12, "institution": 6, "paper": 40}
    rels = [("author", "affiliated_with", "institution"), ("author", "writes", "paper"),
            ("paper", "cites", "paper"), ("paper", "has_topic", "field_of_study")]
    for st, rel, dt in rels:
        (d / "relations" / f"{st}___{rel}___{dt}").mkdir(parents=True)
        e = np.stack([rng.integers(0, counts[st], 80), rng.integers(0, counts[dt], 80)], axis=1)
        e[0] = [counts[st] - 1, counts[dt] - 1]  # every id range is reached
        _write(d / "relations" / f"{st}___{rel}___{dt}" / "edge.csv.gz", e, "%d")
    (d / "node-feat" / "paper").mkdir(parents=True)
    _write(d / "node-feat" / "paper" / "node-feat.csv.gz", rng.normal(size=(40, 6)), "%.7g")
    (d / "node-label" / "paper").mkdir(parents=True)
    _write(d / "node-label" / "paper" / "node-label.csv.gz", rng.integers(0, 5, 40)[:, None], "%d")
    split = base / "ogbn" / "mag" / "ogbn_mag" / "split" / "time" / "paper"
    split.mkdir(parents=True)
    perm = rng.permutation(40)
    for part, idx in (("train", perm[:20]), ("valid", perm[20:30]), ("test", perm[30:])):
        _write(split / f"{part}.csv.gz", idx[:, None], "%d")


def test_ogbn_mag_matches_sgl_tpu(tmp_path):
    _mag_fixture(tmp_path)
    ds, jds = OgbnMag(root=str(tmp_path) + "/"), JOgbnMag(root=str(tmp_path) + "/")
    hg, jhg = ds.data, jds.data
    assert hg.node_types == jhg.node_types and hg.edge_types == jhg.edge_types
    assert hg.num_node == jhg.num_node and ds.num_classes == jds.num_classes
    for et in hg.edge_types:
        assert np.array_equal(hg.edges[et].src, np.asarray(jhg.edges[et].src))
        assert np.array_equal(hg.edges[et].dst, np.asarray(jhg.edges[et].dst))
    for t in hg.node_types:  # institution averages the authors' own averages
        np.testing.assert_allclose(hg.nodes[t].x, np.asarray(jhg.nodes[t].x), rtol=1e-6, atol=1e-6, err_msg=t)
    assert np.array_equal(hg.nodes["paper"].y, np.asarray(jhg.nodes["paper"].y))
    for name in ("train_idx", "val_idx", "test_idx"):
        assert np.array_equal(getattr(ds, name), np.asarray(getattr(jds, name)))


# -- the native csv parser ----------------------------------------------------------

CSV_CASES = {
    "ints": ("1,2\n3,4\n-5,+6\n", np.int64),
    "floats": ("0.5,-1.25e-3,7\n1e2,2.5E+1,-0\n", np.float32),
    "spaces, CRLF, blank lines": (" 1 , 2\r\n\n3,\t4 \r\n\n", np.int64),
    "nan and inf": ("nan,1\ninf,-inf\n", np.float32),
    "one column, no final newline": ("7\n8\n9", np.int64),
    "long digits": ("0.123456789012345678901234,12345678901234567890123.5\n", np.float32),
}


@pytest.mark.parametrize("gz", [True, False], ids=["gz", "plain"])
@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_native_parser_equals_loadtxt(tmp_path, case, gz):
    text, dtype = CSV_CASES[case]
    path = str(tmp_path / ("t.csv.gz" if gz else "t.csv"))
    with (gzip.open(path, "wt") if gz else open(path, "w")) as f:
        f.write(text)
    got = native.load_csv_native(path, dtype)
    assert got is not None, "the native parser refused"
    want = U.read_csv_numpy(path, dtype)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(U.read_csv_gz(path, dtype), want)


def test_native_parser_on_many_chunks_equals_loadtxt(tmp_path):
    """More than one 32 MiB chunk: lines cut at chunk edges are carried."""
    rng = np.random.default_rng(2)
    e = rng.integers(0, 2**40, (3_000_000, 2))
    path = str(tmp_path / "big.csv.gz")
    with gzip.open(path, "wt", compresslevel=1) as f:
        np.savetxt(f, e, fmt="%d", delimiter=",")
    np.testing.assert_array_equal(native.load_csv_native(path, np.int64), e)


def test_native_parser_without_zlib(tmp_path, monkeypatch):
    """A build without zlib: Python inflates gzip data (a plain file passes
    unchanged, as gzread passes it), the parse stays native."""
    from sgl_tpu_torch.kernels import _build

    lib = native.ctypes.CDLL(str(_build.build_host(native.CSV_SOURCE)))
    assert lib.sgl_csv_has_zlib() == 0
    native._load_csv.cache_clear()
    real = native._load_csv()
    assert real is not None and real[1]  # this host has zlib
    for fn in ("sgl_csv_load", "sgl_csv_parse", "sgl_buf_free", "sgl_csv_has_zlib"):
        getattr(lib, fn).argtypes = getattr(real[0], fn).argtypes
        getattr(lib, fn).restype = getattr(real[0], fn).restype
    monkeypatch.setattr(native, "_load_csv", lambda: (lib, False))
    assert not native.csv_native_zlib() and native.csv_native_available()
    for name, (text, dtype) in CSV_CASES.items():
        for path, opener in ((tmp_path / f"{len(name)}.csv.gz", gzip.open), (tmp_path / f"{len(name)}.csv", open)):
            with opener(str(path), "wt") as f:
                f.write(text)
            np.testing.assert_array_equal(native.load_csv_native(str(path), dtype),
                                          U.read_csv_numpy(str(path), dtype), err_msg=name)
    out = [native.ctypes.c_void_p(), native.ctypes.c_int64(), native.ctypes.c_int64()]
    assert lib.sgl_csv_load(b"x", 0, *map(native.ctypes.byref, out)) == -5  # no zlib: no streaming


@pytest.mark.parametrize("text,dtype", [
    ("# a header comment\n1,2\n3,4\n", np.int64),  # numpy skips comments, the native parser refuses
    ("1,2\n3,x\n", np.float32),  # not numeric
    ("1.5,2\n", np.int64),  # a fraction in an integer file
])
def test_refused_input_falls_back_to_loadtxt(tmp_path, text, dtype):
    path = str(tmp_path / "odd.csv")
    with open(path, "w") as f:
        f.write(text)
    assert native.load_csv_native(path, dtype) is None
    try:
        want = U.read_csv_numpy(path, dtype)
    except ValueError:
        with pytest.raises(ValueError):
            U.read_csv_gz(path, dtype)
    else:
        np.testing.assert_array_equal(U.read_csv_gz(path, dtype), want)


def test_ragged_rows_and_unsupported_dtypes_are_refused(tmp_path):
    path = str(tmp_path / "ragged.csv")
    with open(path, "w") as f:
        f.write("1,2\n3\n")
    assert native.load_csv_native(path, np.int64) is None
    assert native.load_csv_native(path, np.float64) is None  # float32 and int64 only
    assert native.load_csv_native(str(tmp_path / "missing.csv"), np.int64) is None


def test_csv_parser_is_its_own_library():
    """A host without zlib keeps the graph builder: the csv parser is built
    apart from it."""
    assert native.csv_native_available() and native.native_available()
    assert native.CSV_SOURCE != native.SOURCE
    assert native._load_csv()[0]._name != native._load()._name


def test_read_npz_matches_sgl_tpu(tmp_path):
    import scipy.sparse as sp

    rng = np.random.default_rng(3)
    attr = sp.random(20, 9, density=0.3, random_state=4, format="csr")
    adj = sp.random(20, 20, density=0.15, random_state=5, format="csr")
    path = str(tmp_path / "g.npz")
    np.savez(path, attr_data=attr.data, attr_indices=attr.indices, attr_indptr=attr.indptr,
             attr_shape=attr.shape, adj_data=adj.data, adj_indices=adj.indices, adj_indptr=adj.indptr,
             adj_shape=adj.shape, labels=rng.integers(0, 3, 20))
    for got, want in zip(U.read_npz(path), j_read_npz(path)):
        assert np.array_equal(got, want)


# -- downloads ----------------------------------------------------------------------


def test_download_to_with_urlopen_mocked(tmp_path, monkeypatch):
    monkeypatch.setattr(urllib.request, "urlopen", lambda url, *a, **k: io.BytesIO(b"payload"))
    U.download_to("http://example.invalid/f.bin", str(tmp_path / "d" / "f.bin"))
    assert (tmp_path / "d" / "f.bin").read_bytes() == b"payload"


def test_ogbn_bootstraps_from_its_archive(tmp_path, monkeypatch):
    """raw_urls → download_to → _post_download: the archive's top-level
    directory becomes ``ogbn_arxiv/``, and the dataset loads from it."""
    d = _ogbn_fixture(tmp_path / "src")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for dirpath, _, files in os.walk(d):
            for fname in files:
                full = os.path.join(dirpath, fname)
                zf.write(full, os.path.join("arxiv", os.path.relpath(full, d)))
    fetched = []

    def fake_urlopen(url, *a, **k):
        fetched.append(url)
        return io.BytesIO(buf.getvalue())

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    root = str(tmp_path / "data") + "/"
    ds = Ogbn("arxiv", root=root)
    assert fetched == ["http://snap.stanford.edu/ogb/data/nodeproppred/arxiv.zip"]
    assert not os.path.exists(os.path.join(ds.raw_dir, "arxiv.zip"))  # unzipped, then removed
    _assert_same(ds, JOgbn("arxiv", root=str(tmp_path / "src") + "/"))


def test_offline_download_names_the_file(tmp_path, monkeypatch):
    def no_network(*a, **k):
        raise OSError("no network")

    monkeypatch.setattr(urllib.request, "urlopen", no_network)
    with pytest.raises(IOError, match=r"arxiv\.zip"):
        Ogbn("arxiv", root=str(tmp_path) + "/")
    with pytest.raises(IOError, match=r"mag\.zip"):
        OgbnMag(root=str(tmp_path) + "/")


def test_no_known_source_names_the_missing_files(tmp_path):
    from sgl_tpu_torch.datasets import Custom_Homo

    with pytest.raises(IOError, match=r"no download source.*adj_matrix\.npz"):
        Custom_Homo("mine", root=str(tmp_path) + "/")
