"""The message ops of the PyTorch port against ``sgl_tpu``'s on the same
hop stacks, on the CPU: every op hop-major, the two attention ops also
node-major, learnable ones with the Flax parameters carried across by
``sgl_tpu_torch.convert``.  Tolerance: rtol 1e-5 (atol 1e-6) for f32 hops;
for bf16 hops, a max error of 1e-2 of max|want| (one bf16 rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_tpu.ops import message_ops as J
from sgl_tpu_torch import convert
from sgl_tpu_torch.ops import message_ops as P

K, N, D = 3, 40, 12


def _hops(seed=0, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=(K + 1, N, D)).astype(dtype)


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(variables))


def _assert_close(got: torch.Tensor, want, bf16: bool = False):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    if bf16:
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# (port op, sgl_tpu op) pairs of the parameter-free ops, by constructor kwargs
FIXED = {
    "sum": (P.SumMessageOp, J.SumMessageOp, dict(start=0, end=K + 1)),
    "sum_1": (P.SumMessageOp, J.SumMessageOp, dict(start=1, end=K + 1)),
    "mean": (P.MeanMessageOp, J.MeanMessageOp, dict(start=0, end=K + 1)),
    "mean_1": (P.MeanMessageOp, J.MeanMessageOp, dict(start=1, end=K)),
    "max": (P.MaxMessageOp, J.MaxMessageOp, dict(start=0, end=K + 1)),
    "min": (P.MinMessageOp, J.MinMessageOp, dict(start=1, end=K + 1)),
    "concat": (P.ConcatMessageOp, J.ConcatMessageOp, dict(start=0, end=K + 1)),
    "alpha": (P.SimpleWeightedMessageOp, J.SimpleWeightedMessageOp,
              dict(start=0, end=K + 1, combination_type="alpha", alpha=0.85)),
    "alpha_1": (P.SimpleWeightedMessageOp, J.SimpleWeightedMessageOp,
                dict(start=1, end=K + 1, combination_type="alpha", alpha=0.3)),
    "hand_crafted": (P.SimpleWeightedMessageOp, J.SimpleWeightedMessageOp,
                     dict(start=1, end=K + 1, combination_type="hand_crafted",
                          weight_list=[0.5, 0.3, 0.2])),
    "over_smooth": (P.OverSmoothDistanceWeightedOp, J.OverSmoothDistanceWeightedOp, {}),
}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(FIXED))
def test_fixed_op_matches(name, bf16):
    port_cls, jax_cls, kw = FIXED[name]
    hops = _hops(1)
    jh = jnp.asarray(hops, jnp.bfloat16 if bf16 else jnp.float32)
    want = jax_cls(**kw).apply({}, jh)
    got = port_cls(**kw)(torch.as_tensor(hops).to(torch.bfloat16 if bf16 else torch.float32))
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    _assert_close(got, want, bf16)


@pytest.mark.parametrize("name", sorted(FIXED))
def test_linear_weights_match(name):
    port_cls, jax_cls, kw = FIXED[name]
    want = jax_cls(**kw).linear_weights(K + 1)
    got = port_cls(**kw).linear_weights(K + 1)
    if want is None:
        assert got is None
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)
        # the weights give the op's aggregate
        hops = _hops(2)
        agg = port_cls(**kw)(torch.as_tensor(hops))
        np.testing.assert_allclose(np.tensordot(got, hops, axes=1), agg.numpy(), rtol=1e-5, atol=1e-6)


def test_hand_crafted_length_mismatch():
    kw = dict(start=0, end=K + 1, combination_type="hand_crafted", weight_list=[0.5, 0.5])
    assert P.SimpleWeightedMessageOp(**kw).linear_weights(K + 1) is None
    assert J.SimpleWeightedMessageOp(**kw).linear_weights(K + 1) is None
    with pytest.raises(ValueError, match="different lengths"):
        P.SimpleWeightedMessageOp(**kw)(torch.as_tensor(_hops()))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("start", [0, 1])
def test_projected_concat_matches(start, bf16):
    hops = _hops(3)
    jop = J.ProjectedConcatMessageOp(start=start, end=K + 1, hidden_dim=8, num_layers=3)
    jh = jnp.asarray(hops, jnp.bfloat16 if bf16 else jnp.float32)
    variables = jop.init(jax.random.PRNGKey(2), jh)
    want = jop.apply(variables, jh)
    op = P.ProjectedConcatMessageOp(start=start, end=K + 1, hidden_dim=8, num_layers=3, feat_dim=D)
    convert._load_msg_op(op, _np_tree(variables)["params"])
    got = op(torch.as_tensor(hops).to(torch.bfloat16 if bf16 else torch.float32))
    assert got.shape == (N, 8 * (K + 1 - start))
    _assert_close(got, want, bf16)
    # the first hop's projection has no ReLU; the later ones do
    assert (got[:, :8] < 0).any() and (got[:, 8:] >= 0).all()


@pytest.mark.parametrize("node_major", [False, True], ids=["hop_major", "node_major"])
@pytest.mark.parametrize("start", [0, 1])
def test_iterate_learnable_matches(start, node_major):
    hops = _hops(4)
    h = np.moveaxis(hops, 0, 1).copy() if node_major else hops
    jop = J.IterateLearnableWeightedMessageOp(start=start, end=K + 1)
    variables = jop.init(jax.random.PRNGKey(3), jnp.asarray(hops))
    want = jop.apply(variables, jnp.asarray(h), node_major=node_major)
    op = P.IterateLearnableWeightedMessageOp(start=start, end=K + 1, feat_dim=D)
    convert._load_msg_op(op, _np_tree(variables)["params"])
    _assert_close(op(torch.as_tensor(h), node_major=node_major), want)


@pytest.mark.parametrize(
    "ct,start", [("simple", 0), ("simple", 1), ("simple_allow_neg", 0), ("gate", 1),
                 ("ori_ref", 1), ("jk", 0)],
)
def test_learnable_weighted_node_major_matches(ct, start):
    hops = _hops(5)
    nm = np.moveaxis(hops, 0, 1).copy()
    jop = J.LearnableWeightedMessageOp(start=start, end=K + 1, combination_type=ct,
                                       prop_steps=K, feat_dim=D)
    variables = jop.init(jax.random.PRNGKey(4), jnp.asarray(hops))
    want = jop.apply(variables, jnp.asarray(nm), node_major=True)
    op = P.LearnableWeightedMessageOp(start=start, end=K + 1, combination_type=ct,
                                      prop_steps=K, feat_dim=D)
    convert._load_msg_op(op, _np_tree(variables)["params"])
    got = op(torch.as_tensor(nm), node_major=True)
    _assert_close(got, want)
    # and the same as the hop-major layout
    np.testing.assert_allclose(got.detach().numpy(), op(torch.as_tensor(hops)).detach().numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cls", [P.LearnableWeightedMessageOp, P.IterateLearnableWeightedMessageOp])
def test_bf16_hops_meet_f32_parameters_in_f32(cls):
    kw = dict(start=0, end=K + 1, feat_dim=D)
    if cls is P.LearnableWeightedMessageOp:
        kw.update(combination_type="gate")
    hops = _hops(6)
    jcls = getattr(J, cls.__name__)
    jkw = {k: v for k, v in kw.items() if k != "feat_dim" or cls is P.LearnableWeightedMessageOp}
    jop = jcls(**jkw)
    variables = jop.init(jax.random.PRNGKey(5), jnp.asarray(hops))
    want = jop.apply(variables, jnp.asarray(hops, jnp.bfloat16))
    op = cls(**kw)
    convert._load_msg_op(op, _np_tree(variables)["params"])
    got = op(torch.as_tensor(hops).to(torch.bfloat16))
    assert got.dtype == torch.float32
    _assert_close(got, want, bf16=True)


def test_support_flags_and_aggr_types_match():
    for name in ("SumMessageOp", "MeanMessageOp", "MaxMessageOp", "MinMessageOp", "ConcatMessageOp",
                 "ProjectedConcatMessageOp", "SimpleWeightedMessageOp", "LearnableWeightedMessageOp",
                 "IterateLearnableWeightedMessageOp", "OverSmoothDistanceWeightedOp", "LastMessageOp"):
        assert getattr(P, name).aggr_type == getattr(J, name).aggr_type, name
        assert getattr(P, name).supports_node_major == getattr(J, name).supports_node_major, name
    assert P.LEARNABLE_AGGR_TYPES == J.LEARNABLE_AGGR_TYPES


def test_unmapped_message_op_raises():
    with pytest.raises(TypeError, match="no Flax mapping"):
        convert._load_msg_op(P.SumMessageOp(), {})
