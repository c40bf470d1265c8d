"""Carry a trained ``sgl_tpu`` (Flax) parameter tree into the port's modules.

The tree is given as nested dicts of numpy arrays (``jax.device_get`` of
the Flax variables), so this module needs no JAX.  Flax ``Dense.kernel`` is
``(in, out)`` and the port's ``Dense.weight`` is ``(out, in)``: kernels are
transposed.  Batch norms take ``scale``/``bias`` from ``params`` and their
running ``mean``/``var`` from ``batch_stats``.  With it both packages
compute the same function, which is how the parity tests hold the port
against the reference.  A module with no mapping raises ``TypeError``.
A NAS ``SearchModel`` of every message type is carried too: its concat
widens the base model to ``feat_dim·(K+1)``, and type 8's ``simple``
weights are a ``hop_weight`` of ``prop_steps + 1`` entries.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from sgl_tpu_torch.models.blocks import (
    Dense,
    IdenticalMapping,
    LogisticRegression,
    MultiLayerPerceptron,
    PReLU,
    ResMultiLayerPerceptron,
)
from sgl_tpu_torch.ops.message_ops import (
    IterateLearnableWeightedMessageOp,
    LearnableWeightedMessageOp,
    ProjectedConcatMessageOp,
)


def _copy(dst: torch.Tensor, value, name: str) -> None:
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


def _load_bns(bns, tree: Mapping, stats: Mapping, name: str) -> None:
    """``BatchNorm_i``: ``scale``/``bias`` from ``tree``, the running
    ``mean``/``var`` from ``stats`` (kept at their initial values when the
    tree carries no ``batch_stats``)."""
    if bns is None:
        return
    for i, bn in enumerate(bns):
        key = f"BatchNorm_{i}"
        _copy(bn.weight, tree[key]["scale"], f"{name}.{key}.scale")
        _copy(bn.bias, tree[key]["bias"], f"{name}.{key}.bias")
        if key in stats:
            _copy(bn.running_mean, stats[key]["mean"], f"{name}.{key}.mean")
            _copy(bn.running_var, stats[key]["var"], f"{name}.{key}.var")


def _load_mlp(mlp: torch.nn.Module, tree: Mapping, stats: Mapping, name: str) -> None:
    """``MultiLayerPerceptron`` or ``ResMultiLayerPerceptron``."""
    for i, layer in enumerate(mlp.layers):
        _load_dense(layer, tree[f"Dense_{i}"], f"{name}.Dense_{i}")
    if isinstance(mlp, MultiLayerPerceptron):
        _load_prelu(mlp.prelu, tree["PReLU_0"], f"{name}.PReLU_0")
    _load_bns(mlp.bns, tree, stats, name)


def _load_msg_op(op: torch.nn.Module, tree: Mapping, stats: Optional[Mapping] = None) -> None:
    stats = stats or {}
    if isinstance(op, LearnableWeightedMessageOp):
        if op.hop_weight is not None:
            _copy(op.hop_weight, tree["hop_weight"], "msg_op.hop_weight")
        elif op.combination_type == "gate":
            _load_dense(op.gate, tree["Dense_0"], "msg_op.Dense_0")
        else:  # ori_ref / jk: the split gate
            _copy(op.gate.weight, np.asarray(tree["gate_kernel"]).T, "msg_op.gate_kernel")
            _copy(op.gate.bias, tree["gate_bias"], "msg_op.gate_bias")
    elif isinstance(op, IterateLearnableWeightedMessageOp):
        _load_dense(op.gate, tree["Dense_0"], "msg_op.Dense_0")
    elif isinstance(op, ProjectedConcatMessageOp):
        for i, proj in enumerate(op.projections):
            key = f"MultiLayerPerceptron_{i}"
            _load_mlp(proj, tree[key], stats.get(key, {}), f"msg_op.{key}")
    else:
        raise TypeError(f"no Flax mapping for message op {type(op).__name__}")


def _load_base(base: torch.nn.Module, tree: Mapping, stats: Mapping) -> None:
    if isinstance(base, LogisticRegression):
        _load_dense(base.dense, tree["Dense_0"], "base_model.Dense_0")
    elif isinstance(base, (MultiLayerPerceptron, ResMultiLayerPerceptron)):
        _load_mlp(base, tree, stats, "base_model")
    elif isinstance(base, IdenticalMapping):
        return  # nothing to carry
    else:
        raise TypeError(f"no Flax mapping for base model {type(base).__name__}")


def load_flax_params(model, params: Mapping) -> None:
    """Copy a Flax variable tree (``{"params": {...}, "batch_stats":
    {...}}``, or the inside of ``params`` alone) into ``model``'s trainable
    modules, in place.  ``model.net`` is an ``SGAPNet``, a
    ``HeteroSGAPNet`` or ``FastHeteroSGAPNet`` (its ``aggregator/weight``
    has Flax's shape, ``(K, D, S)`` or ``(S·K, 1)``), or a
    ``GraphReadoutNet``."""
    tree = params.get("params", params)
    stats = params.get("batch_stats", {})
    net = model.net
    aggregator = getattr(net, "aggregator", None)
    if aggregator is not None:
        _copy(aggregator.weight, tree["aggregator"]["weight"], "aggregator.weight")
    if getattr(net, "msg_op", None) is not None:
        _load_msg_op(net.msg_op, tree["msg_op"], stats.get("msg_op", {}))
    _load_base(net.base_model, tree.get("base_model", {}), stats.get("base_model", {}))

