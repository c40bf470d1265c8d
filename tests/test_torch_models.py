"""Models of the PyTorch port against ``sgl_tpu`` with the same parameters
(carried across by ``sgl_tpu_torch.convert``): message ops, SGC and GAMLP
forward, one training step, and post-processing, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_tpu.models.base import SGAPModel as JSGAPModel
from sgl_tpu.models.homo import GAMLP as JGAMLP
from sgl_tpu.models.homo import SGC as JSGC
from sgl_tpu.ops.graph_ops import PprGraphOp as JPprGraphOp
from sgl_tpu.ops.message_ops import LastMessageOp as JLastMessageOp
from sgl_tpu.ops.message_ops import LearnableWeightedMessageOp as JLearnableWeighted
from sgl_tpu.tasks.utils import adam_l2 as j_adam_l2
from sgl_tpu.tasks.utils import init_train_state, make_train_step as j_make_train_step
from sgl_tpu_torch import convert
from sgl_tpu_torch.models import GAMLP, SGC, FastDropout, SGAPModel
from sgl_tpu_torch.ops import LastMessageOp, LearnableWeightedMessageOp, PprGraphOp
from sgl_tpu_torch.tasks.utils import adam_l2, make_train_step
from tests.conftest import random_graph
from tests.test_torch_graph import to_port_graph

CPU = torch.device("cpu")
K, N, D, C = 3, 60, 16, 4


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


@pytest.mark.parametrize(
    "ct,start", [("simple", 0), ("simple", 1), ("simple_allow_neg", 0), ("gate", 0),
                 ("ori_ref", 1), ("jk", 0)],
)
def test_learnable_weighted_message_op_matches(ct, start):
    hops = np.random.default_rng(3).normal(size=(K + 1, N, D)).astype(np.float32)
    jop = JLearnableWeighted(start=start, end=K + 1, combination_type=ct, prop_steps=K, feat_dim=D)
    params = jop.init(jax.random.PRNGKey(1), jnp.asarray(hops))
    want = jop.apply(params, jnp.asarray(hops))
    op = LearnableWeightedMessageOp(start=start, end=K + 1, combination_type=ct, prop_steps=K, feat_dim=D)
    convert._load_msg_op(op, _np_tree(params)["params"])
    got = op(torch.as_tensor(hops))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _pair(kind, jg, **kw):
    """The same model in both packages, preprocessed on the same graph, with
    the Flax parameters copied into the port."""
    d, c = jg.x.shape[1], int(np.asarray(jg.y).max()) + 1
    if kind == "sgc":
        jm, m = JSGC(K, d, c), SGC(K, d, c)
    else:
        jm = JGAMLP(K, d, c, hidden_dim=32, num_layers=3, **kw)
        m = GAMLP(K, d, c, hidden_dim=32, num_layers=3,
                  **{k: (torch.bfloat16 if v is jnp.bfloat16 else v) for k, v in kw.items()})
    jm.preprocess(jg, jg.x)
    m.preprocess(to_port_graph(jg), jg.x, device=CPU)
    params = jm.init(jax.random.PRNGKey(0))
    convert.load_flax_params(m, _np_tree(params))
    return jm, m, params


@pytest.mark.parametrize("kind", ["sgc", "gamlp"])
def test_forward_matches(kind):
    jg = random_graph(n=120, d=D, seed=12)
    jm, m, params = _pair(kind, jg)
    idx = np.arange(0, 120, 3)
    want = jm.apply(params, jnp.asarray(idx), train=False)
    got = m.apply(torch.as_tensor(idx), train=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_gamlp_bf16_compute_forward_matches():
    jg = random_graph(n=120, d=D, seed=13)
    jm, m, params = _pair("gamlp", jg, compute_dtype=jnp.bfloat16)
    idx = np.arange(120)
    want = np.asarray(jm.apply(params, jnp.asarray(idx), train=False))
    got = m.apply(torch.as_tensor(idx), train=False)
    assert got.dtype == torch.float32
    assert np.abs(got.detach().numpy() - want).max() <= 3e-2 * np.abs(want).max()


@pytest.mark.parametrize("kind", ["sgc", "gamlp"])
def test_one_train_step_matches(kind):
    jg = random_graph(n=150, d=D, seed=14)
    kw = {} if kind == "sgc" else {"dropout": 0.0}
    jm, m, params = _pair(kind, jg, **kw)
    idx = np.arange(0, 150, 2)
    labels = np.asarray(jg.y)[idx].astype(np.int32)
    w = np.ones(idx.shape[0], np.float32)
    lr, wd = 0.1, 5e-5

    tx = j_adam_l2(lr, wd)
    net = jm.net
    jstep = j_make_train_step(lambda p, f, train, rngs: net.apply(p, f, train=train, rngs=rngs), tx)
    state = init_train_state(jax.random.PRNGKey(0), params, tx)
    state, jloss, jacc = jstep(state, jm.batch_input(jnp.asarray(idx)), jnp.asarray(labels), jnp.asarray(w))

    pnet = m.net
    step = make_train_step(pnet, adam_l2(pnet.parameters(), lr, wd))
    loss, acc = step(m.batch_input(torch.as_tensor(idx)), torch.as_tensor(labels).long(), torch.as_tensor(w))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert float(acc) == pytest.approx(float(jacc))

    # the updated parameters, carried across, equal the port's after its step
    want_model = _pair(kind, jg, **kw)[1]
    convert.load_flax_params(want_model, _np_tree(state.params))
    want = want_model.net.state_dict()
    for name, value in pnet.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6, err_msg=name)


def test_postprocess_ppr_last_matches():
    jg = random_graph(n=100, d=D, seed=15)
    logits = np.random.default_rng(5).normal(size=(100, C)).astype(np.float32)
    jm = JSGAPModel(K, D, C, post_graph_op=JPprGraphOp(K), post_msg_op=JLastMessageOp())
    m = SGAPModel(K, D, C, post_graph_op=PprGraphOp(K), post_msg_op=LastMessageOp())
    want = jm.postprocess(jg, jnp.asarray(logits))
    got = m.postprocess(to_port_graph(jg), torch.as_tensor(logits))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_fast_dropout_keeps_the_expectation():
    drop = FastDropout(0.5)
    x = torch.ones(200, 500)
    gen = torch.Generator().manual_seed(0)
    y = drop(x, train=True, generator=gen)
    assert abs(float((y == 0).float().mean()) - 0.5) < 0.01
    assert abs(float(y.mean()) - 1.0) < 0.02
    assert drop(x, train=False) is x
