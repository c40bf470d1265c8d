"""The NARS heterogeneous path of the PyTorch port against ``sgl_tpu``'s, on
the CPU: ``HeteroGraph``, relation-subset sampling (one case above
1,000,000 edges), the relation-subset chooser, metapaths,
``nars_preprocess``, the NARS aggregators' initialization, ``NARS_SIGN``
and Fast NARS (preprocess, forward and one Adam step with the Flax
parameters carried across by ``sgl_tpu_torch.convert``, dropout 0), the
task end to end, the HGB loaders on fixture files and the NARS studies.
Tolerances: features and forward rtol 1e-5 (atol 1e-5); after one step,
loss rtol 1e-4 and every parameter rtol 1e-4 (atol 1e-6); the arrays of
graphs, subgraphs and batches are equal."""

import functools
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgl_tpu.datasets.hetero_datasets as JHGB
import sgl_tpu.datasets.synthetic as jsyn
import sgl_tpu.models.blocks as JB
import sgl_tpu.models.hetero as JH
from sgl_tpu.datasets.choose_edge_type import choose_edge_type as j_choose_edge_type
from sgl_tpu.datasets.choose_edge_type import choose_multi_subgraphs as j_choose_multi
from sgl_tpu.graph.batch import batch_graphs as j_batch_graphs
from sgl_tpu.tasks.utils import adam_l2 as j_adam_l2
from sgl_tpu.tasks.utils import init_train_state, make_train_step as j_make_train_step
from sgl_tpu_torch import convert
from sgl_tpu_torch.datasets import (
    SyntheticHeteroDataset,
    choose_edge_type,
    choose_multi_subgraphs,
    hetero_datasets as PHGB,
    remove_duplicate_edge_types,
    synthetic_hetero,
)
from sgl_tpu_torch.graph import batch_graphs
from sgl_tpu_torch.graph.graph import NATIVE_SORT_EDGES
from sgl_tpu_torch.models import blocks as PB
from sgl_tpu_torch.models import hetero as PH
from sgl_tpu_torch.tasks import HeteroNodeClassification
from sgl_tpu_torch.tasks.utils import adam_l2, make_train_step
from tests.test_torch_graph import assert_graphs_equal

CPU = torch.device("cpu")
K, F, HID, LAYERS = 2, 16, 24, 2
DS_J = jsyn.SyntheticHeteroDataset(seed=1)
DS = SyntheticHeteroDataset(seed=1)
# ACM's relation schema (HGB): eight relation types over four node types
ACM_TYPES = [f"{s}__{r}__{d}" for s, r, d in PHGB.Acm.EDGE_TYPES_TUPLE]
SUBSETS = [
    ("paper__cite__paper",), ("author__writes__paper",), ("paper__has__subject",),
    ("author__writes__paper", "paper__cite__paper"), ("paper__cite__paper", "paper__has__subject"),
    ("author__writes__paper", "paper__cite__paper", "paper__has__subject"),
]


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(variables))


def _assert_subgraphs_equal(got, want):
    (g, f, node_id), (jg, jf, jnode_id) = got, want
    assert_graphs_equal(g, jg)
    assert np.array_equal(node_id, jnode_id)
    assert np.array_equal(f, jf)


def test_hetero_graph_build_matches():
    hg, jhg = DS.data, DS_J.data
    assert hg.node_types == jhg.node_types and hg.edge_types == jhg.edge_types
    assert hg.offset == jhg.offset and hg.num_node == jhg.num_node
    assert hg.total_num_nodes == jhg.total_num_nodes
    for t in hg.node_types:
        assert np.array_equal(hg.node_id_dict[t], jhg.node_id_dict[t])
        assert np.array_equal(hg[t].x, jhg[t].x)
        assert (hg[t].y is None) == (jhg[t].y is None)
    assert np.array_equal(hg["paper"].y, jhg["paper"].y)
    for et in hg.edge_types:
        assert hg.edge_type_parts(et) == jhg.edge_type_parts(et)
        for name in ("src", "dst", "val"):
            assert np.array_equal(getattr(hg.edges[et], name), getattr(jhg.edges[et], name)), (et, name)
    assert (DS.train_idx.tolist(), DS.val_idx.tolist()) == (DS_J.train_idx.tolist(), DS_J.val_idx.tolist())
    assert DS.num_classes == DS_J.num_classes


def test_hetero_graph_build_shifts_local_ids_and_keeps_values():
    from sgl_tpu.graph import HeteroGraph as JHeteroGraph
    from sgl_tpu_torch.graph import HeteroGraph

    counts = {"a": 3, "b": 4}
    edges = {("a", "r", "b"): (np.array([0, 2]), np.array([3, 1]))}
    vals = {("a", "r", "b"): np.array([0.5, 2.0], np.float32)}
    hg = HeteroGraph.build(counts, edges, edge_val_dict=vals)
    jhg = JHeteroGraph.build(counts, edges, edge_val_dict=vals)
    e, je = hg.edges["a__r__b"], jhg.edges["a__r__b"]
    assert e.src.tolist() == je.src.tolist() == [0, 2]
    assert e.dst.tolist() == je.dst.tolist() == [6, 4]
    assert e.val.tolist() == je.val.tolist() == [0.5, 2.0]
    assert e.num_edges == 2 and hg["b"].num_nodes == 4 and hg["a"].x is None


@pytest.mark.parametrize("subset", SUBSETS, ids=lambda s: "+".join(t.split("__")[1] for t in s))
def test_sample_by_edge_type_matches(subset):
    _assert_subgraphs_equal(DS.sample_by_edge_type(subset), DS_J.sample_by_edge_type(subset))


def test_sample_by_edge_type_and_batch_above_one_million_edges_match():
    """Above ``NATIVE_SORT_EDGES`` the subgraph's and the batch's edges are
    sorted by dst with the input order kept within a row; both packages
    must give the same arrays."""
    kw = dict(counts={"paper": 40_000, "author": 60_000, "subject": 2_000}, avg_degree=10, feat_dim=4, seed=3)
    hg, jhg = synthetic_hetero(**kw), jsyn.synthetic_hetero(**kw)
    subsets = [("author__writes__paper", "paper__cite__paper"), ("paper__has__subject",)]
    parts, jparts = [], []
    for subset in subsets:
        (g, node_id), (jg, jnode_id) = hg.sample_by_edge_type(subset), jhg.sample_by_edge_type(subset)
        assert_graphs_equal(g, jg)
        assert np.array_equal(node_id, jnode_id)
        parts.append(g)
        jparts.append(jg)
    assert parts[0].num_edges > NATIVE_SORT_EDGES
    batch, jbatch = batch_graphs(parts), j_batch_graphs(jparts)
    assert batch.graph.num_edges > NATIVE_SORT_EDGES
    assert_graphs_equal(batch.graph, jbatch.graph)
    assert np.array_equal(batch.graph_ids, jbatch.graph_ids)
    assert np.array_equal(batch.node_counts, jbatch.node_counts)


def test_remove_duplicate_edge_types_matches():
    from sgl_tpu.datasets.choose_edge_type import remove_duplicate_edge_types as j_remove

    assert remove_duplicate_edge_types(ACM_TYPES) == j_remove(ACM_TYPES)
    assert remove_duplicate_edge_types(ACM_TYPES) == [
        "paper__cite__paper", "paper__to__author", "paper__to__subject", "paper__to__term"]


@pytest.mark.parametrize("edge_types,predict_class", [(ACM_TYPES, "paper"), (DS.edge_types, "paper"),
                                                      (ACM_TYPES, "author")], ids=["acm", "synthetic", "acm-author"])
@pytest.mark.parametrize("edge_type_num", [1, 2, 3])
def test_chooser_draws_the_same_subsets(edge_types, predict_class, edge_type_num):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for seed in range(6):
            rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
            unique = remove_duplicate_edge_types(edge_types)
            assert choose_edge_type(edge_type_num, unique, predict_class, rng) == j_choose_edge_type(
                edge_type_num, unique, predict_class, jrng)
            for n in (1, 3, 8):
                got = choose_multi_subgraphs(n, edge_type_num, edge_types, predict_class, seed=seed)
                assert got == j_choose_multi(n, edge_type_num, edge_types, predict_class, seed=seed)
                assert len(got) == len(set(got)) and all(len(c) <= edge_type_num for c in got)


def test_chooser_warns_and_returns_fewer_when_the_schema_runs_out():
    # three relation pairs hold one subset of three
    with pytest.warns(UserWarning, match="subgraphs"):
        got = choose_multi_subgraphs(3, 3, DS.edge_types, "paper", seed=0)
    with pytest.warns(UserWarning, match="subgraphs"):
        want = j_choose_multi(3, 3, DS.edge_types, "paper", seed=0)
    assert got == want and len(got) == 1
    assert choose_multi_subgraphs(2, 4, DS.edge_types, "paper") == [] == j_choose_multi(2, 4, DS.edge_types, "paper")


def test_sample_by_meta_path_matches():
    path = ["author__writes__paper", "paper__has__subject"]
    got, want = DS.sample_by_meta_path(path), DS_J.sample_by_meta_path(path)
    assert got.shape == want.shape == (DS.data.num_node["author"], DS.data.num_node["subject"])
    assert got.nnz > 0 and (got != want).nnz == 0


def test_nars_preprocess_matches():
    got = DS.nars_preprocess(DS.edge_types, "paper", 3, 2, seed=7)
    want = DS_J.nars_preprocess(DS_J.edge_types, "paper", 3, 2, seed=7)
    assert list(got) == list(want) and len(got) == 3
    for key in got:
        _assert_subgraphs_equal(got[key], want[key])


@pytest.mark.parametrize("name,shape", [("OneDimConvolution", (4, 64, 3)),
                                        ("OneDimConvolutionWeightSharedAcrossFeatures", (4, 1, 3))])
def test_aggregator_init_uses_flax_fan_rule(name, shape):
    """``variance_scaling(1, fan_avg, uniform)`` on ``(K, D, S)``:
    ``fan_in = D·K``, ``fan_out = S·K``, bound ``sqrt(6 / (fan_in +
    fan_out))``, for the port and for Flax."""
    k, d, s = shape
    assert PB.flax_fans(shape) == (d * k, s * k)
    limit = math.sqrt(6.0 / (d * k + s * k))
    args = (s, k, d) if d > 1 else (s, k)
    port = getattr(PB, name)(*args)
    port.reset_parameters(torch.Generator().manual_seed(0))
    flax_mod = getattr(JB, name)(*args)
    feats = jnp.zeros((k, 2, 64, s))
    flax_w = np.asarray(flax_mod.init(jax.random.PRNGKey(0), feats)["params"]["weight"])
    assert tuple(port.weight.shape) == flax_w.shape == shape
    for w in (port.weight.detach().numpy(), flax_w):
        assert np.abs(w).max() <= limit
        if w.size > 100:  # a uniform draw of that many fills the interval
            assert np.abs(w).max() > 0.9 * limit
            assert abs(w.var() - limit ** 2 / 3) < 0.15 * limit ** 2 / 3


def test_fast_aggregator_starts_from_ones_and_sums_subgraph_weights():
    agg = PB.FastOneDimConvolution(num_subgraphs=3, prop_steps=4)
    with torch.no_grad():
        agg.weight.mul_(torch.arange(12.0)[:, None])
    agg.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(agg.weight, torch.ones(12, 1))
    with torch.no_grad():
        agg.weight.copy_(torch.arange(12.0)[:, None])
    want = JB.FastOneDimConvolution.subgraph_weight({"weight": jnp.arange(12.0)[:, None]}, 3, 4)
    np.testing.assert_array_equal(agg.subgraph_weight().numpy(), np.asarray(want))  # subgraph-major


def _pair(name, s=2, n_et=2, monkeypatch=None):
    """The same NARS model in both packages, dropout 0, preprocessed on the
    same dataset, the Flax parameters copied into the port."""
    args = (K, F, DS.num_classes, HID, LAYERS, s)
    jm, m = getattr(JH, name)(*args), getattr(PH, name)(*args)
    jm.base_model = jm.base_model.clone(dropout=0.0)
    if monkeypatch is not None:  # ProjectedConcat builds its MLPs inside: dropout 0 there too
        monkeypatch.setattr(JB, "MultiLayerPerceptron", functools.partial(JB.MultiLayerPerceptron, dropout=0.0))
    for mod in m.net.modules():
        if isinstance(mod, PB.FastDropout):
            mod.rate = 0.0
    kw = dict(random_subgraph_num=s, subgraph_edge_type_num=n_et)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm.preprocess(DS_J, "paper", **kw)
        m.preprocess(DS, "paper", device=CPU, **kw)
    variables = jm.init(jax.random.PRNGKey(0))
    convert.load_flax_params(m, _np_tree(variables))
    return jm, m, variables


MODELS = ["NARS_SIGN", "Fast_NARS_SGC_WithLearnableWeights"]


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("s", [2, 3])
def test_preprocess_and_forward_match(name, s):
    jm, m, variables = _pair(name, s=s)
    got, want = m.processed_feature, np.asarray(jm.processed_feature)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    idx = np.arange(0, DS.data.num_node["paper"], 3)
    want = jm.net.apply(variables, jm.batch_input(jnp.asarray(idx)), train=False)
    got = m.apply(torch.as_tensor(idx), train=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_packed_layout_is_subgraph_major():
    _, m, _ = _pair("Fast_NARS_SGC_WithLearnableWeights", s=3)
    jm, unpacked, _ = _pair("NARS_SIGN", s=3)
    hops = unpacked.processed_feature  # (K+1, S, N, D)
    packed = m.processed_feature  # (N, D, S*(K+1))
    assert m.num_subgraphs == 3
    for s in range(3):
        for k in range(K + 1):
            assert torch.equal(packed[:, :, s * (K + 1) + k], hops[k, s])


@pytest.mark.parametrize("name", MODELS)
def test_one_train_step_and_subgraph_weight_match(name, monkeypatch):
    jm, m, variables = _pair(name, monkeypatch=monkeypatch)
    idx = np.asarray(DS.train_idx)
    labels = np.asarray(DS.data["paper"].y)[idx].astype(np.int32)
    w = np.ones(idx.shape[0], np.float32)
    lr, wd = 0.05, 5e-5

    tx = j_adam_l2(lr, wd)
    net = jm.net
    jstep = j_make_train_step(lambda p, f, train, rngs: net.apply(p, f, train=train, rngs=rngs), tx)
    state = init_train_state(jax.random.PRNGKey(0), variables, tx)
    state, jloss, jacc = jstep(state, jm.batch_input(jnp.asarray(idx)), jnp.asarray(labels), jnp.asarray(w))

    pnet = m.net
    step = make_train_step(pnet, adam_l2(pnet.parameters(), lr, wd))
    loss, acc = step(m.batch_input(torch.as_tensor(idx)), torch.as_tensor(labels).long(), torch.as_tensor(w))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert float(acc) == pytest.approx(float(jacc))

    want_model = _pair(name)[1]
    convert.load_flax_params(want_model, _np_tree(state.params))
    want = want_model.net.state_dict()
    for key, value in pnet.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=1e-4, atol=1e-6, err_msg=key)
    if name.startswith("Fast"):
        np.testing.assert_allclose(m.subgraph_weight(), np.asarray(jm.subgraph_weight(state.params)),
                                   rtol=1e-4, atol=1e-6)


def test_fewer_subsets_than_the_aggregator_holds_behave_alike():
    """Three relation pairs hold one subset of three relations: the chooser
    warns and returns one.  Fast NARS's matmul then fails in both packages;
    NARS_SIGN's broadcast of one subgraph over three weights computes, the
    same in both."""
    with pytest.raises(TypeError):
        _pair("Fast_NARS_SGC_WithLearnableWeights", s=3, n_et=3)
    args = (K, F, DS.num_classes, HID, LAYERS, 3)
    with pytest.raises(RuntimeError):
        m = PH.Fast_NARS_SGC_WithLearnableWeights(*args)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m.preprocess(DS, "paper", random_subgraph_num=3, subgraph_edge_type_num=3, device=CPU)
        m.apply(torch.arange(4))
    jm, m, variables = _pair("NARS_SIGN", s=3, n_et=3)
    assert m.processed_feature.shape[1] == 1
    idx = np.arange(10)
    want = jm.net.apply(variables, jm.batch_input(jnp.asarray(idx)), train=False)
    np.testing.assert_allclose(m.apply(torch.as_tensor(idx)).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_subgraph_list_and_argument_checks():
    m = PH.NARS_SIGN(*(K, F, DS.num_classes, HID, LAYERS, 2))
    with pytest.raises(ValueError, match="Either subgraph_list"):
        m.preprocess(DS, "paper", device=CPU)
    with pytest.raises(ValueError, match="will be ignored"):
        m.preprocess(DS, "paper", subgraph_list=[], random_subgraph_num=2, device=CPU)
    with pytest.raises(ValueError, match="valid node class"):
        m.preprocess(DS, "venue", random_subgraph_num=2, subgraph_edge_type_num=2, device=CPU)
    with pytest.raises(ValueError, match="touches the predict class"):
        sub = DS.nars_preprocess(DS.edge_types, "paper", 1, 1, seed=0)
        m.preprocess(DS, "paper", subgraph_list=[(("author__x__subject",), v) for v in sub.values()], device=CPU)
    # a given list skips the chooser; the subgraph rows come out the same
    sub = list(DS.nars_preprocess(DS.edge_types, "paper", 2, 2, seed=42).items())
    m.preprocess(DS, "paper", subgraph_list=sub, device=CPU)
    direct = m.processed_feature
    m.preprocess(DS, "paper", random_subgraph_num=2, subgraph_edge_type_num=2, device=CPU)
    assert torch.equal(direct, m.processed_feature)


@pytest.mark.parametrize("name", MODELS)
def test_hetero_node_classification_end_to_end(name):
    model = getattr(PH, name)(K, F, DS.num_classes, 16, 2, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        task = HeteroNodeClassification(
            DS, "paper", model, lr=0.05, weight_decay=5e-5, epochs=20, device="cpu", train_batch_size=32,
            random_subgraph_num=2, subgraph_edge_type_num=2,
            record_subgraph_weight=name.startswith("Fast"), verbose=False,
        )
    assert task.test_acc > 0.5, task.test_acc  # 3 classes, chance = 1/3
    assert len(task.epoch_seconds) == 20 and task.preprocess_seconds > 0
    assert model.sampling_seconds > 0 and len(model.subgraph_keys) == 2
    if name.startswith("Fast"):
        assert task.subgraph_weight.shape == (2,)
    else:
        assert task.subgraph_weight is None


def test_hetero_task_needs_a_device_it_can_use():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HeteroNodeClassification(DS, "paper", PH.NARS_SIGN(K, F, 3, 8, 2, 2), lr=0.1, weight_decay=0.0,
                                 epochs=1, random_subgraph_num=2, subgraph_edge_type_num=2, verbose=False)


def test_nars_studies_run_on_the_cpu():
    from sgl_tpu_torch.etc import hetero_search, select_top_subgraphs, subgraph_weight_stability

    kw = dict(random_subgraph_num=3, subgraph_edge_type_num=2, top_k=2, feat_dim=F,
              output_dim=DS.num_classes, probe_epochs=3, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        combos, weights = select_top_subgraphs(DS, "paper", **kw)
        stab = subgraph_weight_stability(DS, "paper", runs=2, **kw)
        res = hetero_search(DS, "paper", [(2, 2), (1, 2)], feat_dim=F, output_dim=DS.num_classes, epochs=3,
                            device="cpu")
    assert set(combos) <= set(DS.nars_preprocess(DS.edge_types, "paper", 3, 2, seed=42))
    assert len(combos) == 2 and weights.shape == (2,) and weights[0] >= weights[1]
    assert stab.shape == (2, 2)
    assert set(res) == {(2, 2), (1, 2)} and all(0.0 <= v <= 1.0 for v in res.values())


# -- the HGB loaders on fixture files --------------------------------------------

LOADERS = ["Acm", "Dblp", "DblpOriginal", "Imdb", "Aminer"]
HGB_NAMES = {"Acm": "acm", "Dblp": "dblp", "DblpOriginal": "dblp_original", "Imdb": "imdb", "Aminer": "aminer"}


def _write_hgb_fixture(root, cls, seed=0):
    """A PyG-layout dict for ``cls``'s schema: the first node type has
    features (8 wide), the predict type labels and masks, the others only
    ``num_nodes``; the last relation type has no edges, so a type that has
    only it as out-relation gets random normals."""
    rng = np.random.default_rng(seed)
    pred = cls.TYPE_OF_NODE_TO_PREDICT
    pred = pred[0] if isinstance(pred, list) else pred
    counts = {t: int(rng.integers(6, 12)) for t in cls.NODE_TYPES}
    obj = {}
    for i, t in enumerate(cls.NODE_TYPES):
        store = {"num_nodes": counts[t]}
        if i == 0:
            store["x"] = torch.as_tensor(rng.normal(size=(counts[t], 8)).astype(np.float32))
        if t == pred:
            store["y"] = torch.as_tensor(rng.integers(0, 3, counts[t]))
            mask = rng.random(counts[t]) < 0.6
            store["train_mask"] = torch.as_tensor(mask)
            store["test_mask"] = torch.as_tensor(~mask)
        obj[t] = store
    for j, (st, rel, dt) in enumerate(cls.EDGE_TYPES_TUPLE):
        e = 0 if j == len(cls.EDGE_TYPES_TUPLE) - 1 else 3 * counts[st]
        ei = np.stack([rng.integers(0, counts[st], e), rng.integers(0, counts[dt], e)])
        obj[(st, rel, dt)] = {"edge_index": torch.as_tensor(ei)}
    path = root / "hgb" / HGB_NAMES[cls.__name__] / "raw" / f"hgb_{HGB_NAMES[cls.__name__]}" / "raw"
    path.mkdir(parents=True)
    torch.save(obj, path / "geometric_data_processed.pt")


@pytest.mark.parametrize("name", LOADERS)
def test_hgb_loader_matches_on_a_fixture(tmp_path, name):
    _write_hgb_fixture(tmp_path, getattr(PHGB, name))
    ds = getattr(PHGB, name)(root=str(tmp_path) + "/")
    jds = getattr(JHGB, name)(root=str(tmp_path) + "/")
    hg, jhg = ds.data, jds.data
    assert hg.node_types == jhg.node_types and hg.edge_types == jhg.edge_types
    for t in hg.node_types:
        assert hg[t].x is not None
        np.testing.assert_array_equal(hg[t].x, jhg[t].x, err_msg=t)
    for et in hg.edge_types:
        assert np.array_equal(hg.edges[et].src, jhg.edges[et].src)
        assert np.array_equal(hg.edges[et].dst, jhg.edges[et].dst)
    for split in ("train_idx", "val_idx", "test_idx"):
        assert np.array_equal(getattr(ds, split), getattr(jds, split)), split
    assert ds.num_classes == jds.num_classes
    # the processed cache is the port's own file, and it reloads the same
    again = getattr(PHGB, name)(root=str(tmp_path) + "/")
    assert ds.processed_path.endswith(".torchhgraph.pkl")
    assert np.array_equal(again.data[hg.node_types[-1]].x, hg[hg.node_types[-1]].x)


def test_hgb_loader_without_raw_files_names_them(tmp_path):
    with pytest.raises(IOError, match="geometric_data_processed.pt"):
        PHGB.Acm(root=str(tmp_path) + "/")
