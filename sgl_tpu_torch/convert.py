"""Carry a trained ``sgl_tpu`` (Flax) parameter tree into the port's modules.

The tree is given as nested dicts of numpy arrays (``jax.device_get`` of
the Flax params), so this module needs no JAX.  Flax ``Dense.kernel`` is
``(in, out)`` and the port's ``Dense.weight`` is ``(out, in)``: kernels are
transposed.  With it both packages compute the same function, which is how
the parity tests hold the port against the reference.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from sgl_tpu_torch.models.base import SGAPModel
from sgl_tpu_torch.models.blocks import Dense, LogisticRegression, MultiLayerPerceptron, PReLU
from sgl_tpu_torch.ops.message_ops import LearnableWeightedMessageOp


def _copy(dst: torch.nn.Parameter, value, name: str) -> None:
    src = torch.from_numpy(np.array(value, np.float32))  # a writable copy
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: Flax shape {tuple(src.shape)} != port shape {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src)


def _load_dense(dense: Dense, tree: Mapping, name: str) -> None:
    _copy(dense.weight, np.asarray(tree["kernel"]).T, f"{name}.kernel")
    _copy(dense.bias, tree["bias"], f"{name}.bias")


def _load_prelu(prelu: PReLU, tree: Mapping, name: str) -> None:
    _copy(prelu.negative_slope, tree["negative_slope"], f"{name}.negative_slope")


def _load_msg_op(op: LearnableWeightedMessageOp, tree: Mapping) -> None:
    if op.hop_weight is not None:
        _copy(op.hop_weight, tree["hop_weight"], "msg_op.hop_weight")
    elif op.combination_type == "gate":
        _load_dense(op.gate, tree["Dense_0"], "msg_op.Dense_0")
    else:  # ori_ref / jk: the split gate
        _copy(op.gate.weight, np.asarray(tree["gate_kernel"]).T, "msg_op.gate_kernel")
        _copy(op.gate.bias, tree["gate_bias"], "msg_op.gate_bias")


def _load_base(base: torch.nn.Module, tree: Mapping) -> None:
    if isinstance(base, LogisticRegression):
        _load_dense(base.dense, tree["Dense_0"], "base_model.Dense_0")
    elif isinstance(base, MultiLayerPerceptron):
        for i, layer in enumerate(base.layers):
            _load_dense(layer, tree[f"Dense_{i}"], f"base_model.Dense_{i}")
        _load_prelu(base.prelu, tree["PReLU_0"], "base_model.PReLU_0")
    else:
        raise TypeError(f"no Flax mapping for base model {type(base).__name__}")


def load_flax_params(model: SGAPModel, params: Mapping) -> None:
    """Copy a Flax ``SGAPNet`` parameter tree (``{"params": {...}}`` or its
    inside) into ``model``'s trainable modules, in place."""
    tree = params.get("params", params)
    net = model.net
    if net.msg_op is not None:
        if not isinstance(net.msg_op, LearnableWeightedMessageOp):
            raise TypeError(f"no Flax mapping for message op {type(net.msg_op).__name__}")
        _load_msg_op(net.msg_op, tree["msg_op"])
    _load_base(net.base_model, tree["base_model"])
