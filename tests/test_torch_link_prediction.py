"""The port's link prediction against ``sgl_tpu``'s on the CPU: the edge
split array for array, the metrics against scikit-learn (ties included),
``LinkPredictionNAFS``'s best hops and scores, and ``LinkPredictionGAE``
end to end."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import average_precision_score, roc_auc_score

import sgl_tpu.datasets.synthetic as jsyn
from sgl_tpu.tasks import LinkPredictionNAFS as JLinkPredictionNAFS
from sgl_tpu.tasks import mask_test_edges as j_mask_test_edges
from sgl_tpu.tasks.link_prediction import _auc_ap as j_auc_ap
from sgl_tpu.tasks.link_prediction import edge_scores as j_edge_scores
from sgl_tpu_torch.datasets import PlantedPartition
from sgl_tpu_torch.models import SGC
from sgl_tpu_torch.tasks import LinkPredictionGAE, LinkPredictionNAFS, mask_test_edges
from sgl_tpu_torch.tasks.link_prediction import _auc_ap, average_precision, edge_scores, roc_auc

DS_ARGS = dict(num_nodes=300, feat_dim=16, p_in=0.08, seed=3)  # tests/test_tasks.py's DS


@pytest.fixture(scope="module")
def datasets():
    return PlantedPartition(**DS_ARGS), jsyn.PlantedPartition(**DS_ARGS)


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_mask_test_edges_equals_sgl_tpu(datasets, seed):
    ds, jds = datasets
    got = mask_test_edges(ds.graph, seed=seed)
    want = j_mask_test_edges(jds.graph, seed=seed)
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype
        assert np.array_equal(a, b)
    tg, jtg = got[0], want[0]
    assert (tg.num_nodes, tg.num_edges) == (jtg.num_nodes, jtg.num_edges)
    for name in ("src", "dst", "val", "x", "y"):
        assert np.array_equal(getattr(tg, name), np.asarray(getattr(jtg, name))), name


def test_mask_test_edges_is_a_valid_split(datasets):
    """``tests/test_tasks.py::test_mask_test_edges_disjoint_and_valid``."""
    ds, _ = datasets
    g = ds.graph
    train_g, tr, trn, va, van, te, ten = mask_test_edges(g, seed=1)
    src, dst, _ = g.edges()
    real = set(zip(src.tolist(), dst.tolist()))
    for neg in (trn, van, ten):
        for a, b in neg.tolist():
            assert (a, b) not in real and (b, a) not in real and a != b
    ts, td, _ = train_g.edges()
    train_set = set(zip(ts.tolist(), td.tolist()))
    for a, b in np.concatenate([va, te]).tolist():
        assert (a, b) not in train_set and (b, a) not in train_set
    n_upper = int((src < dst).sum())
    assert len(te) == n_upper // 10 and len(va) == n_upper // 20


@pytest.mark.parametrize("decimals", [1, 2, 6])
@pytest.mark.parametrize("seed", [0, 1])
def test_auc_and_ap_match_sklearn_with_ties(decimals, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, 500)
    scores = np.round(rng.random(500) + 0.3 * labels, decimals).astype(np.float32)
    np.testing.assert_allclose(roc_auc(labels, scores), roc_auc_score(labels, scores), rtol=1e-12)
    np.testing.assert_allclose(average_precision(labels, scores), average_precision_score(labels, scores),
                               rtol=1e-12)


def test_edge_scores_and_metrics_match_sgl_tpu(datasets):
    ds, jds = datasets
    _, _, _, _, _, te, ten = mask_test_edges(ds.graph, seed=0)
    z = np.random.default_rng(4).normal(size=(ds.num_node, 8)).astype(np.float32)
    want = np.asarray(j_edge_scores(jnp.asarray(z), te))
    for edges in (te, torch.as_tensor(te)):  # the GAE passes its edges as a tensor
        np.testing.assert_allclose(edge_scores(torch.as_tensor(z), edges).numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_auc_ap(torch.as_tensor(z), te, ten), j_auc_ap(jnp.asarray(z), te, ten),
                               rtol=1e-6)


@pytest.mark.parametrize("method", ["mean", "concat"])
def test_link_prediction_nafs_matches_sgl_tpu(datasets, method):
    ds, jds = datasets
    kw = dict(hops=[0, 2, 3], method=method, r_list=[0.5, 0.3], verbose=False)
    got = LinkPredictionNAFS(ds, device="cpu", **kw)
    want = JLinkPredictionNAFS(jds, **kw)
    assert (got.best_hop_roc_auc, got.best_hop_avg_prec) == (want.best_hop_roc_auc, want.best_hop_avg_prec)
    np.testing.assert_allclose(got.test_roc_auc, want.test_roc_auc, rtol=1e-6)
    np.testing.assert_allclose(got.test_avg_prec, want.test_avg_prec, rtol=1e-6)
    assert got.test_roc_auc > 0.7, got.test_roc_auc
    assert got.split_seconds > 0


def test_link_prediction_gae_end_to_end(datasets):
    ds, _ = datasets
    task = LinkPredictionGAE(ds, SGC(2, ds.num_features, 16), lr=0.01, weight_decay=5e-5, epochs=20,
                             verbose=False, device="cpu")
    assert task.test_roc_auc > 0.7, task.test_roc_auc
    assert 0.0 < task.test_avg_prec <= 1.0
