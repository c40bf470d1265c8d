"""Plain reference of ``gamlp_products.json``'s model, GAMLP with JK
attention (Zhang et al., KDD 2022, arXiv:2206.04355, as SGL runs it).

The cached feature is the hop stack ``[x, Âx, …, Â^K x]``.  The JK
attention reads each hop ``h_k`` beside the reference ``r = concat(h_0 …
h_K)``: ``s_k = sigmoid(g · [r, h_k] + c)`` with one gate ``(g, c)`` over
``(K+2)·D`` inputs, the weights a softmax of the ``s_k`` over the hops,
per node, and the MLP's input ``Σ_k w_k h_k``.  The MLP is ``num_layers``
affine layers with one shared PReLU slope (0.25) and dropout after each
hidden layer.  Departure from the paper, kept as SGL has it: the softmax is
taken of the sigmoid, not of the raw scores.  Parameters are drawn in the
program's order from a CPU generator (the gate as Flax's ``lecun_normal``,
the MLP's layers ``variance_scaling(2, fan_avg, uniform)``, biases zero),
dropout bits from a generator on the device seeded alike."""

from __future__ import annotations

import torch

import reference as ref


def _dims(cfg: dict) -> list:
    a = cfg["model_args"]
    return [a["feat_dim"]] + [a["hidden_dim"]] * (a["num_layers"] - 1) + [a["output_dim"]]


def init(cfg: dict, gen) -> dict:
    a = cfg["model_args"]
    k1, d = a["prop_steps"] + 1, a["feat_dim"]
    p = {"msg_op.gate.weight": ref.lecun_normal_(torch.empty(1, (k1 + 1) * d), gen),
         "msg_op.gate.bias": torch.zeros(1)}
    dims = _dims(cfg)
    for i, (fan_in, fan_out) in enumerate(zip(dims[:-1], dims[1:])):
        p[f"base_model.layers.{i}.weight"] = ref.xavier_relu_uniform_(torch.empty(fan_out, fan_in), gen)
        p[f"base_model.layers.{i}.bias"] = torch.zeros(fan_out)
    p["base_model.prelu.negative_slope"] = torch.tensor(0.25)
    return p


def forward(cfg: dict, params: dict, feats, train: bool, gen, prec: str):
    """``feats`` is the batch's hop stack ``(K+1, B, D)``."""
    k1, d = feats.shape[0], feats.shape[2]
    kern = params["msg_op.gate.weight"][0]
    kern_ref, kern_hop = kern[: k1 * d].view(k1, d), kern[k1 * d:]
    ref_logit = sum(ref.matmul(feats[k], kern_ref[k][:, None], prec)[:, 0] for k in range(k1))
    scores = torch.stack([ref.matmul(feats[k], kern_hop[:, None], prec)[:, 0] for k in range(k1)])
    w = torch.softmax(torch.sigmoid(scores + ref_logit[None] + params["msg_op.gate.bias"]), dim=0)
    h = (w[:, :, None] * feats).sum(dim=0)
    n_layers = len(_dims(cfg)) - 1
    slope = params["base_model.prelu.negative_slope"]
    for i in range(n_layers):
        h = ref.matmul(h, params[f"base_model.layers.{i}.weight"].T, prec) + params[f"base_model.layers.{i}.bias"]
        if i < n_layers - 1:
            h = torch.where(h >= 0, h, slope * h)
            if train:
                h = ref.dropout(h, cfg["model_args"]["dropout"], gen)
    return h


def cached(hop_list):
    return torch.stack(hop_list)


def rows(feats, idx):
    return feats[:, idx]


def forward_flops_per_row(cfg: dict) -> int:
    """The gate's two reads of the stack and the weighted sum (2·(K+1)·D
    each), then the MLP's products."""
    a = cfg["model_args"]
    dims = _dims(cfg)
    return 3 * 2 * (a["prop_steps"] + 1) * a["feat_dim"] + sum(2 * i * o for i, o in zip(dims[:-1], dims[1:]))
