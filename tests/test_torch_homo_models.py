"""The homogeneous model zoo of the PyTorch port against ``sgl_tpu``'s, on
the CPU: SIGN, SSGC, GBP, GAMLPRecursive, NAFS and PASCA_V1–V3.  The same
graph goes through both packages' ``preprocess``; the Flax parameters are
carried into the port (``sgl_tpu_torch.convert``), dropout set to 0; then a
forward pass and one Adam step are compared, in the pattern of
``tests/test_torch_models.py``.  Also the batch norm of both MLPs in train
and eval mode, the residual MLP, PASCA_V3's post-processing and
``NodeClassification`` end to end.  Tolerances: preprocessed features and
forward rtol 1e-5 (atol 1e-5); after one step, loss rtol 1e-4 and every
parameter rtol 1e-4 (atol 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgl_tpu.datasets.synthetic as jsyn
import sgl_tpu.models.blocks as JB
import sgl_tpu.models.homo as JH
from sgl_tpu.tasks.node_classification import NodeClassification as JNodeClassification
from sgl_tpu.tasks.utils import adam_l2 as j_adam_l2
from sgl_tpu.tasks.utils import init_train_state, make_train_step as j_make_train_step
from sgl_tpu_torch import convert
from sgl_tpu_torch.datasets import PlantedPartition
from sgl_tpu_torch.models import blocks as PB
from sgl_tpu_torch.models import homo as PH
from sgl_tpu_torch.tasks import NodeClassification
from sgl_tpu_torch.tasks.utils import adam_l2, make_train_step
from tests.conftest import random_graph
from tests.test_torch_graph import to_port_graph

CPU = torch.device("cpu")
K, D = 3, 16
HID, LAYERS = 24, 3

# name -> constructor arguments after (prop_steps, feat_dim, output_dim)
ZOO = {
    "SIGN": lambda d, c: ((K, d, c, HID, LAYERS), {}),
    "SSGC": lambda d, c: ((K, d, c), {}),
    "GBP": lambda d, c: ((K, d, c, HID, LAYERS), {"alpha": 0.6}),
    "GAMLPRecursive": lambda d, c: ((K, d, c, HID, LAYERS), {}),
    "NAFS": lambda d, c: ((K, d, c), {}),
    "PASCA_V1": lambda d, c: ((K, d, c, HID, LAYERS), {}),
    "PASCA_V2": lambda d, c: ((K, d, c, HID, LAYERS), {}),
    "PASCA_V3": lambda d, c: ((K, 2, d, c, HID, LAYERS), {}),
}
TRAINED = sorted(set(ZOO) - {"NAFS"})


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(variables))


def _pair(name, jg, node_major=False):
    """The same model in both packages, dropout 0, preprocessed on the same
    graph, with the Flax parameters copied into the port."""
    d, c = jg.x.shape[1], int(np.asarray(jg.y).max()) + 1
    args, kw = ZOO[name](d, c)
    jm, m = getattr(JH, name)(*args, **kw), getattr(PH, name)(*args, **kw)
    if hasattr(jm.base_model, "dropout"):
        jm.base_model = jm.base_model.clone(dropout=0.0)
        m.base_model.dropout.rate = 0.0
    jm.node_major = m.node_major = node_major
    jm.preprocess(jg, jg.x)
    m.preprocess(to_port_graph(jg), jg.x, device=CPU)
    variables = jm.init(jax.random.PRNGKey(0))
    convert.load_flax_params(m, _np_tree(variables))
    return jm, m, variables


@pytest.mark.parametrize("name", sorted(ZOO))
def test_preprocess_and_forward_match(name):
    jg = random_graph(n=120, d=D, seed=21)
    jm, m, variables = _pair(name, jg)
    np.testing.assert_allclose(m.processed_feature.numpy(), np.asarray(jm.processed_feature),
                               rtol=1e-5, atol=1e-5)
    idx = np.arange(0, 120, 3)
    want = jm.apply(variables, jnp.asarray(idx), train=False)
    got = m.apply(torch.as_tensor(idx), train=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["GAMLPRecursive", "PASCA_V1", "PASCA_V2"])
def test_node_major_forward_matches(name):
    jg = random_graph(n=90, d=D, seed=22)
    jm, m, variables = _pair(name, jg, node_major=True)
    assert m.processed_feature.shape == (90, K + 1, D)
    idx = np.arange(0, 90, 2)
    want = jm.apply(variables, jnp.asarray(idx), train=False)
    got = m.apply(torch.as_tensor(idx), train=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", TRAINED)
def test_one_train_step_matches(name):
    jg = random_graph(n=150, d=D, seed=23)
    jm, m, variables = _pair(name, jg)
    idx = np.arange(0, 150, 2)
    labels = np.asarray(jg.y)[idx].astype(np.int32)
    w = np.ones(idx.shape[0], np.float32)
    lr, wd = 0.01, 5e-4

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

    want_model = _pair(name, jg)[1]
    convert.load_flax_params(want_model, _np_tree(state.params))
    want = want_model.net.state_dict()
    for key, value in pnet.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=1e-4, atol=1e-6, err_msg=key)


def test_pasca_v3_postprocess_matches():
    jg = random_graph(n=100, d=D, seed=24)
    jm, m, _ = _pair("PASCA_V3", jg)
    logits = np.random.default_rng(6).normal(size=(100, 4)).astype(np.float32)
    want = jm.postprocess(jg, jnp.asarray(logits))
    got = m.postprocess(to_port_graph(jg), torch.as_tensor(logits))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert m.post_graph_op.alpha == 0.3 and m.post_graph_op.prop_steps == 2


def test_constructor_quirks_match():
    gbp, jgbp = PH.GBP(K, D, 3, HID, LAYERS, r=0.2), JH.GBP(K, D, 3, HID, LAYERS, r=0.2)
    assert gbp.pre_graph_op.r == jgbp.pre_graph_op.r == 0.5  # r is accepted, not used
    v1, jv1 = PH.PASCA_V1(K, D, 3, HID, LAYERS), JH.PASCA_V1(K, D, 3, HID, LAYERS)
    assert v1.pre_msg_op.prop_steps == jv1.pre_msg_op.prop_steps == K
    assert v1.pre_graph_op.alpha == jv1.pre_graph_op.alpha == 0.1
    assert v1.base_model.dropout.rate == jv1.base_model.dropout == 0.8
    assert PH.SGCDist is PH.SGC and PH.GAMLPDist is PH.GAMLP


def _mlp_pair(kind, d_in, dtype=None):
    if kind == "mlp":
        jmod = JB.MultiLayerPerceptron(HID, LAYERS, 5, dropout=0.0, bn=True, compute_dtype=dtype)
        pmod = PB.MultiLayerPerceptron(d_in, HID, LAYERS, 5, dropout=0.0, bn=True,
                                       compute_dtype=torch.bfloat16 if dtype else None)
    else:
        jmod = JB.ResMultiLayerPerceptron(HID, 4, 5, dropout=0.0, bn=True)
        pmod = PB.ResMultiLayerPerceptron(d_in, HID, 4, 5, dropout=0.0, bn=True)
    return jmod, pmod


@pytest.mark.parametrize("kind", ["mlp", "res_mlp"])
def test_batch_norm_train_and_eval_match(kind):
    rng = np.random.default_rng(7)
    x = (2.0 * rng.normal(size=(64, D)) + 0.5).astype(np.float32)
    jmod, pmod = _mlp_pair(kind, D)
    variables = jmod.init(jax.random.PRNGKey(8), jnp.asarray(x))
    tree = _np_tree(variables)
    convert._load_mlp(pmod, tree["params"], tree["batch_stats"], "base_model")

    # train mode: batch statistics, running statistics moved (momentum 0.99)
    want, updated = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = pmod(torch.as_tensor(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    stats = _np_tree(updated)["batch_stats"]
    for i, bn in enumerate(pmod.bns):
        np.testing.assert_allclose(bn.running_mean.numpy(), stats[f"BatchNorm_{i}"]["mean"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), stats[f"BatchNorm_{i}"]["var"], rtol=1e-5, atol=1e-6)

    # eval mode: the running statistics normalize
    moved = dict(variables, batch_stats=updated["batch_stats"])
    want = jmod.apply(moved, jnp.asarray(x[:10]), train=False)
    got = pmod(torch.as_tensor(x[:10]), train=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_batch_norm_bf16_compute_matches():
    x = np.random.default_rng(9).normal(size=(48, D)).astype(np.float32)
    jmod, pmod = _mlp_pair("mlp", D, jnp.bfloat16)
    variables = jmod.init(jax.random.PRNGKey(10), jnp.asarray(x))
    tree = _np_tree(variables)
    convert._load_mlp(pmod, tree["params"], tree["batch_stats"], "base_model")
    want, _ = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = pmod(torch.as_tensor(x), train=True)
    assert got.dtype == torch.float32
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= 3e-2 * np.abs(np.asarray(want)).max()


def test_res_mlp_with_dropout_keeps_shapes_and_drops():
    pmod = PB.ResMultiLayerPerceptron(D, HID, 3, 5)
    assert pmod.dropout.rate == 0.8
    x = torch.randn(30, D, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    a, b = pmod(x, train=True, generator=gen), pmod(x, train=True, generator=gen)
    assert a.shape == (30, 5) and not torch.equal(a, b)
    assert torch.equal(pmod(x), pmod(x))


@pytest.fixture(scope="module")
def planted():
    return PlantedPartition(), jsyn.PlantedPartition()


@pytest.mark.parametrize("name", ["SIGN", "PASCA_V3"])
def test_node_classification_end_to_end(planted, name):
    """Mean test accuracy over two seeds within 0.05 of ``sgl_tpu``'s (the
    random streams differ per framework), each at least 0.8."""
    ds, jds = planted
    d, c = ds.num_features, ds.num_classes
    args, kw = ZOO[name](d, c)
    args = args[:-2] + (32, 2)  # hidden 32, 2 layers
    run = dict(lr=0.01, weight_decay=5e-4, epochs=40, verbose=False)
    got = [NodeClassification(ds, getattr(PH, name)(*args, **kw), seed=s, device="cpu", **run).test_acc
           for s in (42, 7)]
    want = [JNodeClassification(jds, getattr(JH, name)(*args, **kw), seed=s, **run).test_acc
            for s in (42, 7)]
    assert min(got) >= 0.8, got
    assert abs(np.mean(got) - np.mean(want)) <= 0.05, (got, want)
