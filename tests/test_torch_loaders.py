"""The port's dataset loaders and SpMM backend switch against ``sgl_tpu``'s.

Each loader's raw files are written from a seed in its own format
(``sgl_tpu_torch.datasets.raw_files``), parsed by both packages, and the
features, labels, edges (in order), weights and splits compared exactly.
Reddit's zip and NELL's tarball come through ``urllib.request.urlopen``
mocked; nothing reaches the network."""

import io
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import sgl_tpu.datasets as J
import sgl_tpu.kernels.sparse as jsparse
import sgl_tpu_torch.datasets as T
from sgl_tpu.models.homo import SGC as JSGC
from sgl_tpu_torch import convert
from sgl_tpu_torch.datasets.raw_files import LOADERS, write_loader_files, write_nell_tarball, write_reddit
from sgl_tpu_torch.datasets.web_datasets import KARATE_EDGES
from sgl_tpu_torch.kernels import SparseAdj, get_default_backend, set_default_backend, spmm
from sgl_tpu_torch.models import SGC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = ("train_idx", "val_idx", "test_idx")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the tier-1 run keeps six workers on the
    cores, and torch's spinning thread pools, eight a worker, slow every
    worker many times over when they meet."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """No test reaches the network: a loader's fetch fails at once unless
    the test serves it."""
    import urllib.request

    def no_network(*a, **k):
        raise OSError("no network")

    monkeypatch.setattr(urllib.request, "urlopen", no_network)


def _assert_same_splits(ds, jds):
    for name in SPLITS:
        np.testing.assert_array_equal(np.asarray(getattr(ds, name)), np.asarray(getattr(jds, name)), name)


def _assert_same_graph(ds, jds):
    g, jg = ds.graph, jds.graph
    assert (g.num_nodes, g.num_edges) == (jg.num_nodes, jg.num_edges)
    for got, want, name in zip(g.edges(), jg.edges(), ("src", "dst", "val")):
        np.testing.assert_array_equal(got, np.asarray(want), name)
    np.testing.assert_array_equal(g.x, np.asarray(jg.x))
    np.testing.assert_array_equal(g.y, np.asarray(jg.y))
    assert (ds.num_features, ds.num_classes) == (jds.num_features, jds.num_classes)


def _assert_same_hetero(ds, jds):
    d, jd = ds.data, jds.data
    assert d.num_node == jd.num_node and d.node_types == jd.node_types and d.edge_types == jd.edge_types
    for t in d.node_types:
        np.testing.assert_array_equal(np.asarray(d[t].x), np.asarray(jd[t].x), t)
        if jd[t].y is not None:
            np.testing.assert_array_equal(np.asarray(d[t].y), np.asarray(jd[t].y), t)
    for et in d.edge_types:
        for name in ("src", "dst"):
            np.testing.assert_array_equal(getattr(d.edges[et], name), np.asarray(getattr(jd.edges[et], name)))
    assert ds.num_classes == jds.num_classes


@pytest.mark.parametrize("loader", LOADERS)
def test_loader_matches_sgl_tpu(tmp_path, loader):
    root = str(tmp_path) + "/"
    kw = write_loader_files(loader, root, seed=3)
    jds = getattr(J, loader)(root=root, **kw)
    ds = getattr(T, loader)(root=root, **kw)
    if loader == "Custom_Hetero":
        _assert_same_hetero(ds, jds)
    else:
        _assert_same_graph(ds, jds)
    _assert_same_splits(ds, jds)
    # a second construction reads the port's own cache and gives the same
    again = getattr(T, loader)(root=root, **kw)
    if loader != "Custom_Hetero":
        _assert_same_graph(again, jds)
    _assert_same_splits(again, jds)


@pytest.mark.parametrize("loader,kw", [
    ("Reddit", {"split": "random"}), ("Flickr", {"split": "random"}), ("Nell", {"split": "random"}),
    ("AmazonProduct", {"split": "official"}),
])
def test_split_modes_match_sgl_tpu(tmp_path, loader, kw):
    root = str(tmp_path) + "/"
    kw = {**write_loader_files(loader, root, seed=5), **kw}
    _assert_same_splits(getattr(T, loader)(root=root, **kw), getattr(J, loader)(root=root, **kw))


def test_twitch_ignores_its_split_argument_as_sgl_tpu_does(tmp_path):
    root = str(tmp_path) + "/"
    kw = write_loader_files("Twitch", root, seed=1)
    ds, jds = T.Twitch(root=root, split="official", **kw), J.Twitch(root=root, split="official", **kw)
    _assert_same_splits(ds, jds)
    np.testing.assert_array_equal(ds.train_idx, T.random_split(ds.num_node)[0])


def test_published_shapes_of_the_writers(tmp_path):
    """Reddit's writer at a small shape: the stored count, symmetry, no
    self loops, the split counts, homophily."""
    import scipy.sparse as sp

    raw = str(tmp_path / "reddit" / "reddit" / "raw")
    out = write_reddit(raw, num_nodes=2_000, nnz=60_000, num_features=12, num_classes=5, split=(1_300, 200, 500))
    adj = sp.load_npz(os.path.join(raw, "reddit_graph.npz"))
    assert adj.nnz == out["nnz"] == 60_000 and (adj != adj.T).nnz == 0 and adj.diagonal().sum() == 0
    ds = T.Reddit(root=str(tmp_path) + "/")
    assert [len(getattr(ds, s)) for s in SPLITS] == [1_300, 200, 500]
    assert ds.graph.num_edges == 60_000 and ds.num_features == 12 and ds.num_classes == 5
    # homophilous: most edges join two nodes of one class
    s, d, _ = ds.graph.edges()
    assert np.mean(ds.y[s] == ds.y[d]) > 0.6


def _serve(monkeypatch, served: dict, fetched: list):
    import urllib.request

    def fake_urlopen(url, *a, **k):
        fetched.append(url)
        if url not in served:
            raise OSError(f"unexpected URL {url}")
        return io.BytesIO(served[url])

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)


@pytest.mark.parametrize("loader", ["Reddit", "Nell"])
def test_archives_unpack_with_the_network_mocked(tmp_path, monkeypatch, loader):
    """Reddit's zip and NELL's tarball come off the (mocked) wire into
    each package's own root and unpack to the same dataset; the tarball's
    other label rate is left behind."""
    src = str(tmp_path / "server") + "/"
    kw = write_loader_files(loader, src, seed=2, downloaded=True)
    name, url = {
        "Reddit": ("reddit.zip", "https://data.dgl.ai/dataset/reddit.zip"),
        "Nell": ("nell_data.tar.gz", "http://www.cs.cmu.edu/~zhiliny/data/nell_data.tar.gz"),
    }[loader]
    sub = ("reddit", "reddit") if loader == "Reddit" else ("Nell", kw["name"])
    with open(os.path.join(src, *sub, "raw", name), "rb") as f:
        served = {url: f.read()}
    fetched = []
    _serve(monkeypatch, served, fetched)
    ds = getattr(T, loader)(root=str(tmp_path / "port") + "/", **kw)
    jds = getattr(J, loader)(root=str(tmp_path / "jax") + "/", **kw)
    assert fetched == [url, url]
    _assert_same_graph(ds, jds)
    _assert_same_splits(ds, jds)
    raw = os.listdir(os.path.join(str(tmp_path / "port"), *sub, "raw"))
    assert name not in raw and not any("other" in f for f in raw), raw
    # the files stayed: offline, the second load reads them
    _serve(monkeypatch, {}, fetched)
    _assert_same_graph(getattr(T, loader)(root=str(tmp_path / "port") + "/", **kw), jds)


def test_an_archive_placed_by_hand_unpacks_offline(tmp_path, monkeypatch):
    """An archive already in ``raw/`` is not fetched again: it unpacks."""
    fetched = []
    _serve(monkeypatch, {}, fetched)
    kw = write_loader_files("Reddit", str(tmp_path) + "/", seed=4, downloaded=True)
    assert T.Reddit(root=str(tmp_path) + "/", **kw).num_node == 300 and not fetched
    write_nell_tarball(str(tmp_path / "Nell" / "nell.0.001" / "raw"), num_nodes=1_600, num_features=8,
                       num_classes=3, num_edges=2_000)
    ds = T.Nell(root=str(tmp_path) + "/")
    assert ds.num_node == 1_600 and not fetched
    assert (len(ds.train_idx), len(ds.val_idx), len(ds.test_idx)) == (3, 500, 1000)


def test_offline_without_files_raises_naming_them(tmp_path, monkeypatch):
    _serve(monkeypatch, {}, [])
    with pytest.raises(IOError, match="reddit.zip"):
        T.Reddit(root=str(tmp_path) + "/")
    with pytest.raises(IOError, match="no download source"):
        T.Custom_Homo("mine", root=str(tmp_path) + "/")


def test_karate_club_is_networkx_graph(tmp_path):
    import networkx as nx

    assert list(KARATE_EDGES) == list(nx.karate_club_graph().edges())
    ds, jds = T.KarateClub(root=str(tmp_path) + "/"), J.KarateClub(root=str(tmp_path) + "/")
    _assert_same_graph(ds, jds)
    assert ds.num_node == 34 and ds.graph.num_edges == 2 * 78


def test_karate_club_loads_without_networkx(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['networkx'] = None\n"
        "from sgl_tpu_torch.datasets import KarateClub\n"
        f"ds = KarateClub(root={str(tmp_path) + '/'!r})\n"
        "assert ds.graph.num_edges == 156, ds.graph.num_edges\n"
        "assert 'networkx' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sgc_on_a_loaded_fixture_matches_sgl_tpu(tmp_path):
    """Flickr's format at a small size through both loaders, SGC(2): the
    propagated features and the logits from the same weights."""
    root = str(tmp_path) + "/"
    write_loader_files("Flickr", root, num_nodes=400, num_features=24, num_classes=5, seed=6)
    ds, jds = T.Flickr(root=root), J.Flickr(root=root)
    jm = JSGC(2, jds.num_features, jds.num_classes)
    m = SGC(2, ds.num_features, ds.num_classes)
    jm.preprocess(jds.graph, jds.x)
    m.preprocess(ds.graph, ds.x, device="cpu")
    np.testing.assert_allclose(m.processed_feature.numpy(), np.asarray(jm.processed_feature), rtol=1e-5, atol=1e-5)
    variables = jm.init(jax.random.PRNGKey(0))
    convert.load_flax_params(m, jax.tree_util.tree_map(np.asarray, jax.device_get(variables)))
    idx = np.asarray(ds.test_idx)
    want = np.asarray(jm.apply(variables, jax.numpy.asarray(idx), train=False))
    got = m.apply(torch.as_tensor(idx), train=False).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture
def restore_backend():
    before = get_default_backend()
    yield
    set_default_backend(before)
    jsparse.set_default_backend("auto")


def _adj_pair(n=200, e=1500, d=9, seed=0):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    jadj = jsparse.SparseAdj(jax.numpy.asarray(src, np.int32), jax.numpy.asarray(dst, np.int32),
                             jax.numpy.asarray(w), n)
    adj = SparseAdj(torch.as_tensor(src, dtype=torch.int32), torch.as_tensor(dst, dtype=torch.int32),
                    torch.as_tensor(w), n)
    return adj, jadj, x


def test_segment_backend_matches_sgl_tpu(restore_backend):
    from sgl_tpu_torch.kernels import prepare_csr

    adj, jadj, x = _adj_pair()
    want = np.asarray(jsparse.spmm(jadj, jax.numpy.asarray(x), backend="segment"))
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(spmm(adj, xt, backend="segment").numpy(), want, rtol=1e-5, atol=1e-6)
    set_default_backend("segment")
    jsparse.set_default_backend("segment")
    want_default = np.asarray(jsparse.spmm(jadj, jax.numpy.asarray(x)))
    np.testing.assert_allclose(spmm(adj, xt).numpy(), want_default, rtol=1e-5, atol=1e-6)
    # a CSR layout under "segment" runs the plain product on its edges
    np.testing.assert_allclose(spmm(prepare_csr(adj), xt).numpy(), want, rtol=1e-5, atol=1e-6)
    # and differentiates: dx = A^T g
    xg = xt.clone().requires_grad_(True)
    spmm(prepare_csr(adj), xg).sum().backward()
    g = jax.grad(lambda v: jsparse.spmm(jadj, v, backend="segment").sum())(jax.numpy.asarray(x))
    np.testing.assert_allclose(xg.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-6)


def test_backend_names_and_errors_match_sgl_tpu(restore_backend):
    adj, _, x = _adj_pair(n=20, e=60, d=3)
    xt = torch.as_tensor(x)
    for bad in ("cuda", "", "Segment"):
        with pytest.raises(ValueError) as got:
            set_default_backend(bad)
        with pytest.raises(ValueError) as want:
            jsparse.set_default_backend(bad)
        assert str(got.value) == str(want.value)
        if bad:  # an empty name means the default, as in sgl_tpu
            with pytest.raises(ValueError, match="unknown spmm backend"):
                spmm(adj, xt, backend=bad)
    assert get_default_backend() == "auto"
    with pytest.raises(ValueError, match="CUDA kernel"):
        spmm(adj, xt, backend="pallas")
    set_default_backend("pallas")
    with pytest.raises(ValueError, match="CUDA kernel"):
        spmm(adj, xt)
    set_default_backend("auto")  # the CPU's plain product again
    torch.testing.assert_close(spmm(adj, xt), spmm(adj, xt, backend="segment"))


def test_segment_backend_reaches_propagation(restore_backend):
    """``set_default_backend("segment")`` takes every hop of a graph op off
    the CSR route: the same hops through ``csr_edges``."""
    from sgl_tpu_torch.datasets import PlantedPartition
    from sgl_tpu_torch.kernels import sparse
    from sgl_tpu_torch.ops import LaplacianGraphOp

    ds = PlantedPartition(num_nodes=150, feat_dim=6, seed=2)
    auto = LaplacianGraphOp(2).propagate(ds.graph, ds.x, device="cpu")
    calls = []
    real = sparse.csr_edges
    sparse.csr_edges = lambda adj: calls.append(1) or real(adj)
    try:
        set_default_backend("segment")
        seg = LaplacianGraphOp(2).propagate(ds.graph, ds.x, device="cpu")
    finally:
        sparse.csr_edges = real
    assert len(calls) == 2
    torch.testing.assert_close(seg, auto, rtol=1e-5, atol=1e-6)


def test_unlabeled_nodes_train_as_sgl_tpu_does(tmp_path):
    """LINKX marks unlabeled nodes -1: the loss reads them as optax does
    (the last class), and SGC trains through them on LINKX's files."""
    import jax.numpy as jnp

    from sgl_tpu.tasks.utils import weighted_cross_entropy as j_loss
    from sgl_tpu_torch.tasks import NodeClassification
    from sgl_tpu_torch.tasks.utils import weighted_cross_entropy

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((12, 4)).astype(np.float32)
    labels = np.array([-1, 0, 3, -1, 2, 1, -1, 0, 1, 2, 3, -1])
    w = rng.random(12).astype(np.float32)
    got = weighted_cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels), torch.as_tensor(w))
    want = j_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(w))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    root = str(tmp_path) + "/"
    ds = T.LINKXDataset(root=root, **write_loader_files("LINKXDataset", root, seed=1))
    assert (ds.y[ds.train_idx] == -1).any()
    task = NodeClassification(ds, SGC(2, ds.num_features, ds.num_classes), lr=0.1, weight_decay=5e-5, epochs=3,
                              device="cpu", verbose=False)
    assert 0.0 <= task.test_acc <= 1.0
