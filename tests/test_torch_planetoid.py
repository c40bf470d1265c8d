"""The port's Planetoid loader against ``sgl_tpu``'s on the same raw files.

The raw files are written from a seed in the kimiyoung/planetoid pickle
format (``sgl_tpu_torch.datasets.planetoid.write_raw_files``; nothing is
downloaded), parsed by both packages, and the graph, features, labels and
splits compared exactly.  Then the README's 3-line flow on the port:
Planetoid → SGC → NodeClassification, on the CPU."""

import os

import numpy as np
import pytest

from sgl_tpu.datasets.planetoid import Planetoid as JPlanetoid
from sgl_tpu.datasets.utils import random_split_dataset as j_random_split_dataset
from sgl_tpu.datasets.utils import row_normalize as j_row_normalize
from sgl_tpu.datasets.utils import undirect_and_clean as j_undirect_and_clean
from sgl_tpu_torch.datasets import Planetoid
from sgl_tpu_torch.datasets.planetoid import write_raw_files
from sgl_tpu_torch.datasets.utils import random_split_dataset, row_normalize, undirect_and_clean
from sgl_tpu_torch.models import SGC
from sgl_tpu_torch.tasks import NodeClassification


def _raw_dir(root, name):
    return os.path.join(str(root), "Planetoid", name, "raw")


def _assert_same(ds, jds):
    assert (ds.num_node, ds.num_features, ds.num_classes) == (jds.num_node, jds.num_features, jds.num_classes)
    for name in ("src", "dst", "val", "x", "y"):
        np.testing.assert_array_equal(getattr(ds.graph, name), np.asarray(getattr(jds.graph, name)), name)
    assert ds.graph.num_edges == jds.graph.num_edges
    for name in ("train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(ds, name), np.asarray(getattr(jds, name)), name)
    assert ds.adj is ds.graph and ds.data is ds.graph


@pytest.mark.parametrize("name,split,shape", [
    ("cora", "official", dict(num_nodes=1800, num_features=40, num_classes=7, num_edges=3000)),
    ("citeseer", "random", dict(num_nodes=400, num_features=30, num_classes=6, num_edges=700,
                                num_test=120)),
    ("pubmed", "official", {}),  # pubmed's shape: 19,717 nodes, 500 features, 3 classes
])
def test_parse_matches_sgl_tpu(tmp_path, name, split, shape):
    write_raw_files(_raw_dir(tmp_path, name), name, seed=3, **shape)
    ds = Planetoid(name, root=str(tmp_path) + "/", split=split)
    jds = JPlanetoid(name, root=str(tmp_path) + "/", split=split)
    _assert_same(ds, jds)
    sums = ds.x.sum(1)
    np.testing.assert_allclose(sums[sums > 0], 1.0, rtol=1e-5)  # row-normalized
    if name == "pubmed":
        assert (ds.num_node, ds.num_features, ds.num_classes) == (19_717, 500, 3)
        assert ds.graph.num_edges == 2 * 44_324
        assert (len(ds.train_idx), len(ds.val_idx), len(ds.test_idx)) == (60, 500, 1000)
    # a second construction reads the pickle cache and gives the same
    _assert_same(Planetoid(name, root=str(tmp_path) + "/", split=split), jds)


def test_missing_raw_files_raise_and_name_them(tmp_path, monkeypatch):
    import urllib.request

    def offline(*a, **k):
        raise OSError("no network")

    # a missing file is fetched from the loader's source: offline, the fetch fails
    monkeypatch.setattr(urllib.request, "urlopen", offline)
    raw = _raw_dir(tmp_path, "cora")
    write_raw_files(raw, "cora", num_nodes=300, num_features=10, num_classes=3, num_edges=400, num_test=50)
    os.remove(os.path.join(raw, "ind.cora.graph"))
    with pytest.raises(IOError, match=r"ind\.cora\.graph"):
        Planetoid("cora", root=str(tmp_path) + "/")
    with pytest.raises(ValueError):
        Planetoid("nell", root=str(tmp_path) + "/")


def test_helpers_match_sgl_tpu():
    import scipy.sparse as sp

    rng = np.random.default_rng(4)
    m = sp.random(30, 12, density=0.3, random_state=5, format="lil")
    m[3] = 0  # an empty row stays empty
    m = m.tocsr()
    np.testing.assert_allclose(row_normalize(m).toarray(), j_row_normalize(m).toarray())
    src, dst = rng.integers(0, 20, 80), rng.integers(0, 20, 80)
    for got, want in zip(undirect_and_clean(src, dst), j_undirect_and_clean(src, dst)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(random_split_dataset(101, seed=7), j_random_split_dataset(101, seed=7)):
        np.testing.assert_array_equal(got, want)


def test_readme_flow_on_the_port(tmp_path):
    write_raw_files(_raw_dir(tmp_path, "pubmed"), "pubmed", seed=0)
    dataset = Planetoid("pubmed", str(tmp_path) + "/", "official")
    model = SGC(prop_steps=3, feat_dim=dataset.num_features, output_dim=dataset.num_classes)
    task = NodeClassification(dataset, model, lr=0.2, weight_decay=5e-5, epochs=60, device="cpu",
                              verbose=False)
    assert 0.6 <= task.test_acc <= 1.0
