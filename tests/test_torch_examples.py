"""The port's examples (``sgl_tpu_torch/examples``) on the CPU, against
``sgl_tpu`` on the same inputs: the six scripts' ``main``, the accuracy
reproduction with the network mocked (as ``tests/test_reproduce_accuracy.py``
drives ``examples/reproduce_accuracy.py``), and the papers100M pipeline's
``--data`` on an OGB-layout fixture."""

import importlib.util
import io
import os

import numpy as np
import pytest
import torch

import sgl_tpu.datasets as J
from chip_smoke import NAS_OGB, write_ogb_raw
from sgl_tpu.models.homo import GAMLP as JGAMLP
from sgl_tpu.models.homo import SGC as JSGC
from sgl_tpu.tasks import LinkPredictionNAFS as JLinkPredictionNAFS
from sgl_tpu.tasks import NodeClusteringNAFS as JNodeClusteringNAFS
from sgl_tpu_torch.datasets.planetoid import write_raw_files
from sgl_tpu_torch.examples import (
    gamlp_products,
    graph_classification,
    hetero_nars,
    nafs_link_predict,
    nafs_node_cluster,
    papers100m_pipeline,
    reproduce_accuracy,
    sgc_pubmed,
)
from tests.test_datasets import _fabricate_planetoid_raw
from tests.test_reproduce_accuracy import _fabricate_products_zip

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


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


def _jax_example(name):
    """``examples/<name>.py`` as a module, without running a script body
    (only ``reproduce_accuracy`` has a ``main``)."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max()), np.abs(got - want).max()


def test_sgc_pubmed_on_planetoid_files(tmp_path):
    """Pubmed-format files at a small shape: the port's hops equal
    ``sgl_tpu``'s SGC preprocess, ``TrainConfig`` flags reach the task."""
    write_raw_files(str(tmp_path / "Planetoid" / "pubmed" / "raw"), "pubmed", num_nodes=1_600,
                    num_features=300, num_edges=3_000, seed=1)
    out = sgc_pubmed.main([*CPU, "--root", str(tmp_path) + "/", "--epochs", "30", "--lr", "0.2"])
    assert out["device"] == torch.device("cpu") and 0.5 <= out["test_acc"] <= 1.0
    assert out["task"]._epochs == 30 and out["task"]._lr == 0.2
    jds = J.Planetoid("pubmed", str(tmp_path) + "/", "official")
    jm = JSGC(3, jds.num_features, jds.num_classes)
    jm.preprocess(jds.graph, jds.x)
    _close(out["model"].processed_feature.numpy(), jm.processed_feature)


def test_sgc_pubmed_falls_back_to_a_synthetic_graph(tmp_path, capsys):
    out = sgc_pubmed.main([*CPU, "--root", str(tmp_path) + "/", "--epochs", "5"])
    assert "synthetic planted partition" in capsys.readouterr().out
    assert out["task"]._dataset.num_node == 2000 and np.isfinite(out["test_acc"])


def test_gamlp_products_on_ogb_files(tmp_path):
    shape = dict(NAS_OGB, num_nodes=600, num_edges=2_400, feat_dim=12, num_classes=5, split=(300, 100, 200))
    write_ogb_raw(str(tmp_path), shape, name="products")
    out = gamlp_products.main([*CPU, "--root", str(tmp_path) + "/", "--epochs", "3"])
    assert out["device"] == torch.device("cpu") and 0.0 <= out["test_acc"] <= 1.0
    jds = J.Ogbn("products", str(tmp_path) + "/")
    jm = JGAMLP(3, jds.num_features, jds.num_classes, hidden_dim=512, num_layers=3)
    jm.preprocess(jds.graph, jds.x)
    _close(out["model"].processed_feature.numpy(), jm.processed_feature)


def test_hetero_nars_and_graph_classification_fall_back(tmp_path):
    out = hetero_nars.main([*CPU, "--root", str(tmp_path) + "/", "--epochs", "4"])
    assert out["device"] == torch.device("cpu") and 0.0 <= out["test_acc"] <= 1.0
    assert np.all(np.isfinite(np.asarray(out["subgraph_weight"]))) and len(out["subgraph_weight"]) == 2
    out = graph_classification.main([*CPU, "--epochs", "5", "--num-graphs", "60"])
    assert out["device"] == torch.device("cpu") and 0.0 <= out["test_acc"] <= 1.0


@pytest.mark.parametrize("name", ["nafs_link_predict", "nafs_node_cluster"])
def test_nafs_examples_match_sgl_tpu(tmp_path, name):
    """Training-free: on the fallback graph the port's metrics equal
    ``sgl_tpu``'s task on the same graph (four hops here)."""
    mod = {"nafs_link_predict": nafs_link_predict, "nafs_node_cluster": nafs_node_cluster}[name]
    out = mod.main([*CPU, "--root", str(tmp_path) + "/", "--hops", "4"])
    assert out["device"] == torch.device("cpu")
    jds = J.PlantedPartition(num_nodes=1000, feat_dim=64, num_classes=3)
    if name == "nafs_link_predict":
        jt = JLinkPredictionNAFS(jds, hops=4, method="mean", verbose=False)
        _close([out["test_roc_auc"], out["test_avg_prec"]], [jt.test_roc_auc, jt.test_avg_prec], 1e-6)
    else:
        jt = JNodeClusteringNAFS(jds, hops=4, method="mean", verbose=False)
        _close([out["acc"], out["nmi"], out["adjscore"]], [jt.acc, jt.nmi, jt.adjscore], 1e-6)


def test_examples_default_to_the_gpu():
    for mod in (sgc_pubmed, gamlp_products, hetero_nars, graph_classification, nafs_link_predict,
                nafs_node_cluster):
        with pytest.raises(RuntimeError, match="CUDA device"):
            mod.main([])


def test_reproduce_accuracy_tables_match_sgl_tpu():
    """The same workloads, metrics, bands and provenance, and the same NAS
    trial count."""
    ra = _jax_example("reproduce_accuracy")
    assert list(reproduce_accuracy.WORKLOADS) == list(ra.WORKLOADS)
    for name, (_, metric, band, provenance) in ra.WORKLOADS.items():
        assert reproduce_accuracy.WORKLOADS[name][1:] == (metric, band, provenance), name
    assert reproduce_accuracy.NAS_SMOKE_TRIALS == ra.NAS_SMOKE_TRIALS == 20


def test_reproduce_accuracy_full_flow_mocked_network(tmp_path, monkeypatch):
    """Fabricated pubmed, cora, citeseer and products archives come off a
    mocked ``urlopen``; all 12 workloads run on the CPU; a second run is
    offline."""
    import urllib.request

    base = "https://github.com/kimiyoung/planetoid/raw/master/data"
    served = {}
    for name in ("pubmed", "cora", "citeseer"):
        files, _ = _fabricate_planetoid_raw(name, n_train=12, n_test=10, d=8, c=3, n_all=40)
        served.update({f"{base}/{f}": data for f, data in files.items()})
    served["http://snap.stanford.edu/ogb/data/nodeproppred/products.zip"] = _fabricate_products_zip()
    fetched = []
    monkeypatch.setattr(reproduce_accuracy, "NAS_SMOKE_TRIALS", 3)

    def fake_urlopen(url, *a, **k):
        fetched.append(url)
        if url not in served:
            raise AssertionError(f"unexpected URL {url}")
        return io.BytesIO(served[url])

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    root = str(tmp_path) + "/"
    rows = reproduce_accuracy.main(workloads=list(reproduce_accuracy.WORKLOADS), root=root, epochs=3,
                                   split="random", check_bands=False, device="cpu")
    assert [r[0] for r in rows] == list(reproduce_accuracy.WORKLOADS)
    for name, metric, value, in_band in rows:
        assert np.isfinite(value) and 0.0 <= value <= 1.0, (name, value)
        assert in_band is None and metric == reproduce_accuracy.WORKLOADS[name][1]
    assert any("planetoid" in u for u in fetched) and any(u.endswith("products.zip") for u in fetched)
    assert not torch.distributed.is_initialized()  # the one-rank group of dist_sgc_pubmed is gone
    monkeypatch.setattr(urllib.request, "urlopen", lambda *a, **k: (_ for _ in ()).throw(OSError("offline")))
    rows2 = reproduce_accuracy.main(workloads=["sgc_pubmed"], root=root, epochs=3, split="random",
                                    check_bands=False, device="cpu")
    assert np.isfinite(rows2[0][2])


def test_reproduce_accuracy_reports_missing_data_and_bands(tmp_path, monkeypatch, capsys):
    root = str(tmp_path) + "/"
    assert reproduce_accuracy.main(workloads=["sgc_pubmed"], root=root, device="cpu") == [
        ("sgc_pubmed", "test acc", None, None)]
    assert "NO DATA" in capsys.readouterr().out
    assert reproduce_accuracy.cli(["--root", root, "--workloads", "sgc_pubmed", "--device", "cpu"]) == 1
    assert reproduce_accuracy.cli(["--root", root, "--workloads", "sgc_pubmed", "--device", "cpu",
                                   "--allow-missing"]) == 0


def test_papers100m_pipeline_reads_data(tmp_path):
    """``--data ROOT``: the dataset is ``Ogbn("papers100M", ROOT)``, as
    ``sgl_tpu`` reads it, and the stored hops are the in-core ones."""
    from sgl_tpu_torch.ops import LaplacianGraphOp

    shape = dict(NAS_OGB, num_nodes=2_000, num_edges=9_000, feat_dim=16, num_classes=6, split=(1_000, 400, 600))
    write_ogb_raw(str(tmp_path / "data"), shape, name="papers100M")
    out = papers100m_pipeline.main(["--data", str(tmp_path / "data"), "--store", str(tmp_path / "store"),
                                    "--epochs", "2", "--batch", "500", "--part-edges", "4096", "--src-blocks", "2"],
                                   device="cpu")
    ds = out["dataset"]
    jds = J.Ogbn("papers100M", root=str(tmp_path / "data"))
    for got, want in zip(ds.graph.edges(), jds.graph.edges()):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(ds.x, np.asarray(jds.x))
    np.testing.assert_array_equal(ds.test_idx, np.asarray(jds.test_idx))
    want = LaplacianGraphOp(3).propagate(ds.graph, ds.x, device="cpu").numpy()
    got = np.stack([np.load(out["sink"].path(k)) for k in range(4)])
    _close(got, want)
    assert np.isfinite(out["test_acc"]) and out["precompute_peak_bytes"] is None

