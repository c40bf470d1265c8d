"""The port's clustering against ``sgl_tpu`` and scikit-learn on the CPU:
the metrics, KMeans from given centers, the cluster loss, NAFS smoothing
(single shot and the sweep, hop by hop) and both clustering tasks end to
end."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn import metrics
from sklearn.cluster import KMeans as SkKMeans

import sgl_tpu.datasets.synthetic as jsyn
from sgl_tpu.tasks import nafs_smooth_features as j_nafs_smooth_features
from sgl_tpu.tasks import nafs_smooth_sweep as j_nafs_smooth_sweep
from sgl_tpu.tasks.clustering_metrics import clustering_metrics as j_clustering_metrics
from sgl_tpu.tasks.node_clustering import NodeClusteringNAFS as JNodeClusteringNAFS
from sgl_tpu.tasks.node_clustering import cluster_loss as j_cluster_loss
from sgl_tpu_torch.datasets import PlantedPartition
from sgl_tpu_torch.models import NAFS, SIGN
from sgl_tpu_torch.tasks import KMeans, NodeClustering, NodeClusteringNAFS, nafs_smooth_features, nafs_smooth_sweep
from sgl_tpu_torch.tasks.clustering_metrics import clustering_metrics
from sgl_tpu_torch.tasks.node_clustering import cluster_loss
from tests.conftest import random_graph
from tests.test_torch_graph import to_port_graph

CPU = torch.device("cpu")
DS_ARGS = dict(num_nodes=300, feat_dim=16, p_in=0.08, seed=3)  # tests/test_tasks.py's DS
R_LIST = (0.5, 0.2)


def _labelings(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    k = 5
    true = rng.integers(0, k, 400)
    if kind == "random":
        return true, rng.integers(0, k, 400)
    if kind == "permuted":  # the same partition under other names: scores of 1
        return true, rng.permutation(k)[true] + 10
    if kind == "noisy":
        pred = true.copy()
        flip = rng.random(400) < 0.3
        pred[flip] = rng.integers(0, k, int(flip.sum()))
        return true, pred
    return true, rng.integers(0, k - 1, 400)  # "fewer": another count of clusters


@pytest.mark.parametrize("kind", ["random", "permuted", "noisy", "fewer"])
@pytest.mark.parametrize("seed", [0, 1])
def test_clustering_metrics_match_sklearn(kind, seed):
    true, pred = _labelings(kind, seed)
    acc, nmi, ari = clustering_metrics(true, pred).evaluationClusterModelFromLabel()
    np.testing.assert_allclose(nmi, metrics.normalized_mutual_info_score(true, pred), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(ari, metrics.adjusted_rand_score(true, pred), rtol=1e-12, atol=1e-15)
    want = j_clustering_metrics(true, pred).clusteringAcc()
    np.testing.assert_allclose(clustering_metrics(true, pred).clusteringAcc(), want, rtol=1e-12)
    assert acc == want[0]
    if kind == "permuted":
        assert (acc, nmi, ari) == (1.0, 1.0, 1.0)


def test_clustering_metrics_single_cluster_cases():
    one = np.zeros(10, int)
    two = np.arange(10) % 2
    for a, b in ((one, one), (one, two), (two, one)):
        _, nmi, ari = clustering_metrics(a, b).evaluationClusterModelFromLabel()
        assert nmi == metrics.normalized_mutual_info_score(a, b)
        assert ari == metrics.adjusted_rand_score(a, b)


def _blobs(seed: int, n: int = 400, k: int = 5, d: int = 8):
    rng = np.random.default_rng(seed)
    centers = 3 * rng.normal(size=(k, d))
    x = (centers[rng.integers(0, k, n)] + rng.normal(size=(n, d))).astype(np.float32)
    return x, rng


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_from_given_centers_matches_sklearn(seed):
    x, rng = _blobs(seed)
    init = x[rng.choice(x.shape[0], 5, replace=False)]
    want = SkKMeans(5, init=init, n_init=1, algorithm="lloyd").fit(x)
    got = KMeans(5).fit(torch.as_tensor(x), init=torch.as_tensor(init))
    np.testing.assert_array_equal(got.labels_.numpy(), want.labels_)
    np.testing.assert_allclose(got.cluster_centers_.numpy(), want.cluster_centers_, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.inertia_, want.inertia_, rtol=1e-5)
    assert got.n_iter_ == want.n_iter_


def test_kmeans_relocates_an_empty_cluster_as_sklearn_does():
    x, _ = _blobs(4)
    init = np.stack([x[0], x[0], x[1], x[2]])  # two equal centers: one cluster starts empty
    want = SkKMeans(4, init=init, n_init=1, algorithm="lloyd").fit(x)
    got = KMeans(4).fit(torch.as_tensor(x), init=torch.as_tensor(init))
    np.testing.assert_array_equal(got.labels_.numpy(), want.labels_)
    np.testing.assert_allclose(got.inertia_, want.inertia_, rtol=1e-5)


def test_kmeans_seeding_is_repeatable_and_keeps_the_lowest_inertia():
    x, _ = _blobs(5)
    xt = torch.as_tensor(x)
    a = KMeans(5, n_init=4, random_state=7).fit(xt)
    b = KMeans(5, n_init=4, random_state=7).fit(xt)
    assert torch.equal(a.labels_, b.labels_) and a.inertia_ == b.inertia_
    singles = [KMeans(5, n_init=1, generator=g).fit(xt).inertia_
               for g in [torch.Generator().manual_seed(7)] * 4]
    assert a.inertia_ == min(singles)
    # the blobs are found: as good as scikit-learn's own seeding
    sk = SkKMeans(5, n_init=4, random_state=7).fit(x)
    assert a.inertia_ <= sk.inertia_ * 1.01
    assert metrics.adjusted_rand_score(sk.labels_, a.labels_.numpy()) > 0.95


def test_cluster_loss_matches_sgl_tpu():
    rng = np.random.default_rng(9)
    out = rng.normal(size=(60, 6)).astype(np.float32)
    centers = rng.normal(size=(4, 6)).astype(np.float32)
    y = rng.integers(0, 4, 60)
    want = j_cluster_loss(jnp.asarray(out), jnp.asarray(y), jnp.asarray(centers))
    got = cluster_loss(torch.as_tensor(out), torch.as_tensor(y), torch.as_tensor(centers))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.fixture(scope="module")
def graphs():
    jg = random_graph(n=120, avg_deg=6, d=8, seed=4)
    return jg, to_port_graph(jg)


@pytest.mark.parametrize("method", ["mean", "max", "concat", "simple"])
def test_nafs_smooth_features_match_sgl_tpu(graphs, method):
    jg, g = graphs
    want = np.asarray(j_nafs_smooth_features(jg, jg.x, 5, R_LIST, method))
    got = nafs_smooth_features(g, g.x, 5, R_LIST, method, device=CPU)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", ["mean", "concat", "simple"])
def test_nafs_smooth_sweep_matches_sgl_tpu_hop_by_hop(graphs, method):
    jg, g = graphs
    want = list(j_nafs_smooth_sweep(jg, jg.x, [4, 0, 2], R_LIST, method))
    got = list(nafs_smooth_sweep(g, g.x, [4, 0, 2], R_LIST, method, device=CPU))
    assert [h for h, _ in got] == [h for h, _ in want] == [0, 2, 4]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    # each emission equals the single shot of its hop count
    for hop, feats in got:
        torch.testing.assert_close(feats, nafs_smooth_features(g, g.x, hop, R_LIST, method, device=CPU))


@pytest.fixture(scope="module")
def datasets():
    return PlantedPartition(**DS_ARGS), jsyn.PlantedPartition(**DS_ARGS)


def test_node_clustering_trainable(datasets):
    ds, _ = datasets
    model = SIGN(2, ds.num_features, ds.num_classes, hidden_dim=16, num_layers=2)
    task = NodeClustering(ds, model, lr=0.01, weight_decay=5e-5, epochs=3, n_init=4, verbose=False,
                          device="cpu")
    assert 0.0 <= task.acc <= 1.0
    assert 0.0 <= task.nmi <= 1.0 and 0.0 <= task.adjscore <= 1.0


def test_node_clustering_training_free_model(datasets):
    ds, _ = datasets
    task = NodeClustering(ds, NAFS(3, ds.num_features, ds.num_features), lr=0.01, weight_decay=5e-5,
                          epochs=2, n_init=4, verbose=False, device="cpu")
    assert task.nmi > 0.3, task.nmi


def test_node_clustering_nafs_end_to_end(datasets):
    ds, jds = datasets
    kw = dict(hops=[2, 3], method="mean", n_init=4, r_list=[0.5, 0.3], verbose=False)
    task = NodeClusteringNAFS(ds, device="cpu", **kw)
    assert task.nmi > 0.3, task.nmi
    assert len(task.kmeans_seconds) == 2
    # the seeding differs from scikit-learn's by design; on this easy graph
    # both find the communities
    want = JNodeClusteringNAFS(jds, **kw)
    assert abs(task.nmi - want.nmi) <= 0.05, (task.nmi, want.nmi)
    with pytest.raises(ValueError):
        NodeClusteringNAFS(ds, method="sum", device="cpu")
