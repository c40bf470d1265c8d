"""Graph classification in the PyTorch port against ``sgl_tpu``, on the CPU:
block-diagonal batching (one case above 1,000,000 edges), the per-graph
readouts (an empty graph included), GraphSGC (f32 and bf16 precompute),
GraphSIGN and a learnable hop weighting (preprocess, forward and one Adam
step with the Flax parameters carried across by ``sgl_tpu_torch.convert``,
dropout 0), ``SyntheticGraphClassification``, ``GraphClassification`` end
to end and the TU loader on fixture files.  Tolerances: features and
forward rtol 1e-5 (atol 1e-5), bf16 features 1e-2 of max|y|; after one
step, loss rtol 1e-4 and every parameter rtol 1e-4 (atol 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgl_tpu.datasets.synthetic as jsyn
import sgl_tpu.models.graph_level as JG
from sgl_tpu.datasets.tu_dataset import TUDataset as JTUDataset
from sgl_tpu.graph.batch import batch_graphs as j_batch_graphs
from sgl_tpu.models.blocks import LogisticRegression as JLogisticRegression
from sgl_tpu.ops import LaplacianGraphOp as JLaplacianGraphOp
from sgl_tpu.ops import LearnableWeightedMessageOp as JLearnableWeightedMessageOp
from sgl_tpu.tasks.utils import adam_l2 as j_adam_l2
from sgl_tpu.tasks.utils import init_train_state, make_train_step as j_make_train_step
from sgl_tpu_torch import convert
from sgl_tpu_torch.datasets import SyntheticGraphClassification, TUDataset
from sgl_tpu_torch.datasets.utils import read_csv_gz, read_index_csv_gz
from sgl_tpu_torch.graph import batch_graphs
from sgl_tpu_torch.graph.graph import NATIVE_SORT_EDGES
from sgl_tpu_torch.models import graph_level as PG
from sgl_tpu_torch.models.blocks import LogisticRegression
from sgl_tpu_torch.ops import LaplacianGraphOp, LearnableWeightedMessageOp
from sgl_tpu_torch.tasks import GraphClassification
from sgl_tpu_torch.tasks.utils import adam_l2, make_train_step
from tests.conftest import random_graph
from tests.test_torch_graph import assert_graphs_equal, to_port_graph

CPU = torch.device("cpu")
K = 2
DS_J = jsyn.SyntheticGraphClassification(num_graphs=60, feat_dim=6, seed=2)
DS = SyntheticGraphClassification(num_graphs=60, feat_dim=6, seed=2)


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(variables))


def _graphs(k=4, seed=0):
    return [random_graph(n=30 + 7 * i, avg_deg=5, d=6, seed=seed + i) for i in range(k)]


def _assert_batches_equal(batch, jbatch):
    assert_graphs_equal(batch.graph, jbatch.graph)
    assert np.array_equal(batch.graph_ids, jbatch.graph_ids) and batch.graph_ids.dtype == np.int32
    assert np.array_equal(batch.node_counts, jbatch.node_counts)
    assert batch.num_graphs == jbatch.num_graphs
    assert (batch.y is None and jbatch.y is None) or np.array_equal(batch.y, jbatch.y)


def test_batch_graphs_matches():
    jgraphs = _graphs()
    y = np.arange(4)
    _assert_batches_equal(batch_graphs([to_port_graph(g) for g in jgraphs], y=y), j_batch_graphs(jgraphs, y=y))


def test_batch_graphs_above_one_million_edges_matches():
    jgraphs = [random_graph(n=12_000, avg_deg=40, d=2, seed=s) for s in range(3)]
    batch = batch_graphs([to_port_graph(g) for g in jgraphs])
    assert batch.graph.num_edges > NATIVE_SORT_EDGES
    _assert_batches_equal(batch, j_batch_graphs(jgraphs))


def test_batch_graphs_validates():
    graphs = [to_port_graph(g) for g in _graphs(2)]
    with pytest.raises(ValueError, match="at least one"):
        batch_graphs([])
    with pytest.raises(ValueError, match="all graphs have features"):
        batch_graphs([graphs[0], graphs[1].replace(x=None)])


def test_synthetic_graph_classification_matches():
    assert DS.num_graphs == DS_J.num_graphs and DS.num_classes == DS_J.num_classes
    assert np.array_equal(DS.y, DS_J.y)
    for g, jg in zip(DS.graphs, DS_J.graphs):
        assert_graphs_equal(g, jg)
    for split in ("train_idx", "val_idx", "test_idx"):
        assert np.array_equal(getattr(DS, split), getattr(DS_J, split))
    _assert_batches_equal(DS.batch(), DS_J.batch())
    assert DS.batch() is DS.batch()  # built once


@pytest.mark.parametrize("kind", ["mean", "sum", "max"])
def test_segment_readout_matches_with_an_empty_graph(kind):
    counts = np.array([3, 0, 4, 1], np.int32)  # graph 1 has no node
    gids = np.repeat(np.arange(4, dtype=np.int32), counts)
    h = np.random.default_rng(0).normal(size=(gids.shape[0], 5)).astype(np.float32)
    want = np.asarray(JG.segment_readout(jnp.asarray(h), jnp.asarray(gids), 4, jnp.asarray(counts), kind))
    got = PG.segment_readout(torch.as_tensor(h), torch.as_tensor(gids), 4, torch.as_tensor(counts), kind)
    assert got.dtype == torch.float32 and got.shape == (4, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    empty = {"mean": 0.0, "sum": 0.0, "max": -np.inf}[kind]
    assert np.all(got[1].numpy() == empty)


def test_segment_readout_rejects_unknown_kinds():
    with pytest.raises(ValueError, match="unknown readout"):
        PG.segment_readout(torch.zeros(2, 1), torch.zeros(2, dtype=torch.int32), 1, torch.ones(1), "median")
    with pytest.raises(ValueError, match="unknown readout"):
        PG.GraphSGC(2, 4, 2, readout="median")


def _learnable(package):
    lap, lw, lr_cls = ((JLaplacianGraphOp, JLearnableWeightedMessageOp, JLogisticRegression) if package == "jax"
                       else (LaplacianGraphOp, LearnableWeightedMessageOp, LogisticRegression))
    kw = dict(start=0, end=K + 1, combination_type="simple", prop_steps=K)
    base = lr_cls(output_dim=DS.num_classes) if package == "jax" else lr_cls(DS.num_features, DS.num_classes)
    mod = JG if package == "jax" else PG
    return mod.GraphLevelSGAPModel(K, DS.num_features, DS.num_classes, readout="max",
                                   pre_graph_op=lap(K, r=0.5), pre_msg_op=lw(**kw), base_model=base)


MODELS = {
    "GraphSGC-mean": lambda mod: mod.GraphSGC(K, DS.num_features, DS.num_classes),
    "GraphSGC-max": lambda mod: mod.GraphSGC(K, DS.num_features, DS.num_classes, readout="max"),
    "GraphSIGN-sum": lambda mod: mod.GraphSIGN(K, DS.num_features, DS.num_classes, hidden_dim=16, readout="sum"),
    "GraphSIGN-max": lambda mod: mod.GraphSIGN(K, DS.num_features, DS.num_classes, hidden_dim=16, readout="max"),
    "learnable-max": lambda mod: _learnable("jax" if mod is JG else "port"),
}


def _pair(name, dtype=None):
    jm, m = MODELS[name](JG), MODELS[name](PG)
    if hasattr(jm.base_model, "dropout"):
        jm.base_model = jm.base_model.clone(dropout=0.0)
        m.base_model.dropout.rate = 0.0
    jm.preprocess(DS_J.batch(), dtype=None if dtype is None else jnp.bfloat16)
    m.preprocess(DS.batch(), dtype=dtype, device=CPU)
    variables = jm.init(jax.random.PRNGKey(0))
    convert.load_flax_params(m, _np_tree(variables))
    return jm, m, variables


def _forward(jm, m, variables):
    feats, gids, counts = jm.net_inputs()
    want = jm.net.apply(variables, feats, gids, counts, train=False)
    pf, pg, pc = m.net_inputs()
    got = m.net(pf, pg, pc, train=False)
    return got.detach().numpy(), np.asarray(want)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_preprocess_and_forward_match(name):
    jm, m, variables = _pair(name)
    want = np.asarray(jm.processed_feature)
    assert tuple(m.processed_feature.shape) == want.shape
    np.testing.assert_allclose(m.processed_feature.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(*_forward(jm, m, variables), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["GraphSGC-max", "GraphSIGN-max"])
def test_bf16_precompute_matches(name):
    jm, m, variables = _pair(name, dtype=torch.bfloat16)
    assert m.processed_feature.dtype == torch.bfloat16
    want = np.asarray(jm.processed_feature.astype(jnp.float32))
    got = m.processed_feature.float().numpy()
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    got, want = _forward(jm, m, variables)
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_one_train_step_matches(name):
    jm, m, variables = _pair(name)
    labels = np.asarray(DS.y).astype(np.int32)
    w = np.zeros(DS.num_graphs, np.float32)
    w[np.asarray(DS.train_idx)] = 1.0
    lr, wd = 0.05, 5e-4

    feats, gids, counts = jm.net_inputs()
    net = jm.net
    tx = j_adam_l2(lr, wd)
    jstep = j_make_train_step(lambda p, f, train, rngs: net.apply(p, f, gids, counts, train=train, rngs=rngs), tx)
    state = init_train_state(jax.random.PRNGKey(0), variables, tx)
    state, jloss, jacc = jstep(state, feats, jnp.asarray(labels), jnp.asarray(w))

    pnet = m.net
    pf, pg, pc = m.net_inputs()
    step = make_train_step(lambda f, train, generator: pnet(f, pg, pc, train=train, generator=generator),
                           adam_l2(pnet.parameters(), lr, wd))
    loss, acc = step(pf, torch.as_tensor(labels).long(), torch.as_tensor(w))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert float(acc) == pytest.approx(float(jacc))

    want_model = _pair(name)[1]
    convert.load_flax_params(want_model, _np_tree(state.params))
    want = want_model.net.state_dict()
    for key, value in pnet.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=1e-4, atol=1e-6, err_msg=key)


def test_graph_classification_structural_signal():
    """Classes differ only in structure; with zero hops the same pipeline
    does worse (``tests/test_graph_level.py``'s check, on the port)."""
    ds = SyntheticGraphClassification(num_graphs=120, seed=3)
    accs = {}
    for k in (2, 0):
        model = PG.GraphSGC(k, ds.num_features, ds.num_classes, readout="max")
        task = GraphClassification(ds, model, lr=0.1, weight_decay=5e-5, epochs=60, verbose=False, device="cpu")
        accs[k] = task.test_acc
        assert len(task.epoch_seconds) == 60 and task.preprocess_seconds > 0
    assert accs[2] > 0.8 and accs[0] < accs[2], accs


@pytest.mark.parametrize("name,dtype", [("GraphSIGN-max", None), ("learnable-max", None),
                                        ("GraphSGC-max", torch.bfloat16)])
def test_graph_classification_end_to_end(name, dtype):
    model = MODELS[name](PG)
    task = GraphClassification(DS, model, lr=0.05, weight_decay=5e-5, epochs=20, verbose=False, device="cpu",
                               precompute_dtype=dtype)
    assert 0.0 <= task.test_acc <= 1.0
    assert model.processed_feature.dtype == (dtype or torch.float32)


def test_graph_task_needs_a_device_it_can_use():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphClassification(DS, PG.GraphSGC(1, DS.num_features, 2), lr=0.1, weight_decay=0.0, epochs=1,
                            verbose=False)


def _write_tu_fixture(raw):
    """Two triangles and a 2-path (1-based, both directions), labels 1, -1,
    1, node labels and attributes."""
    raw.mkdir(parents=True)
    edges = [(1, 2), (2, 1), (2, 3), (3, 2), (1, 3), (3, 1),
             (4, 5), (5, 4), (5, 6), (6, 5), (4, 6), (6, 4),
             (7, 8), (8, 7)]
    (raw / "TOY_A.txt").write_text("\n".join(f"{a}, {b}" for a, b in edges))
    (raw / "TOY_graph_indicator.txt").write_text("\n".join(["1"] * 3 + ["2"] * 3 + ["3"] * 2))
    (raw / "TOY_graph_labels.txt").write_text("1\n-1\n1\n")
    (raw / "TOY_node_labels.txt").write_text("\n".join("01201201"))
    (raw / "TOY_node_attributes.txt").write_text("\n".join(f"{i}.5, {-i}.25" for i in range(8)))


def test_tu_dataset_matches_on_a_fixture(tmp_path):
    _write_tu_fixture(tmp_path / "TOY" / "raw")
    ds = TUDataset("TOY", root=str(tmp_path) + "/", use_cache=False)
    jds = JTUDataset("TOY", root=str(tmp_path) + "/", use_cache=False)
    assert (ds.num_graphs, ds.num_classes, ds.num_features) == (3, 2, 5)
    np.testing.assert_array_equal(ds.y, [1, 0, 1])
    np.testing.assert_array_equal(ds.y, jds.y)
    for g, jg in zip(ds.graphs, jds.graphs):
        assert_graphs_equal(g, jg)
    for split in ("train_idx", "val_idx", "test_idx"):
        assert np.array_equal(getattr(ds, split), getattr(jds, split))
    _assert_batches_equal(ds.batch(), jds.batch())
    task = GraphClassification(ds, PG.GraphSGC(1, ds.num_features, ds.num_classes), lr=0.1, weight_decay=0.0,
                               epochs=3, verbose=False, device="cpu")
    assert 0.0 <= task.test_acc <= 1.0


def test_tu_dataset_caches_and_names_missing_files(tmp_path):
    _write_tu_fixture(tmp_path / "TOY" / "raw")
    first = TUDataset("TOY", root=str(tmp_path) + "/")
    assert first.processed_path.endswith("TOY.torchgraphs.pkl")
    (tmp_path / "TOY" / "raw" / "TOY_A.txt").unlink()  # the cache answers now
    again = TUDataset("TOY", root=str(tmp_path) + "/")
    np.testing.assert_array_equal(again.y, first.y)
    assert [g.num_edges for g in again.graphs] == [6, 6, 2]
    with pytest.raises(IOError, match="MISSING_A.txt"):
        TUDataset("MISSING", root=str(tmp_path) + "/")


def test_csv_readers_match_sgl_tpu(tmp_path):
    import gzip

    from sgl_tpu.datasets.utils import read_csv_gz as j_read_csv_gz
    from sgl_tpu.datasets.utils import read_index_csv_gz as j_read_index_csv_gz

    plain, packed = tmp_path / "a.csv", tmp_path / "b.csv.gz"
    plain.write_text("1, 2\n3,4\n5 ,6\n")
    with gzip.open(packed, "wt") as f:
        f.write("0.5,1.25\n-2,3e-1\n")
    for path, dtype in ((plain, np.int64), (packed, np.float32)):
        got, want = read_csv_gz(str(path), dtype), j_read_csv_gz(str(path), dtype)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    np.testing.assert_array_equal(read_index_csv_gz(str(plain)), j_read_index_csv_gz(str(plain)))
