"""Plain reference of ``sgc_reddit.json``'s model, SGC (Wu et al., ICML 2019,
arXiv:1902.07153): the cached feature is ``Â^K x`` (the last hop), and the
trainable stage one affine layer, ``logits = S x W^T + b``, with ``W``
drawn as Flax's ``lecun_normal`` and ``b`` zero, as the program draws them
from a CPU generator seeded with the job's seed.  No departure from the
paper: its SGC has no bias-free variant and no nonlinearity."""

from __future__ import annotations

import torch

import reference as ref


def init(cfg: dict, gen) -> dict:
    a = cfg["model_args"]
    w = ref.lecun_normal_(torch.empty(a["output_dim"], a["feat_dim"]), gen)
    return {"base_model.dense.weight": w, "base_model.dense.bias": torch.zeros(a["output_dim"])}


def forward(cfg: dict, params: dict, feats, train: bool, gen, prec: str):
    return ref.matmul(feats, params["base_model.dense.weight"].T, prec) + params["base_model.dense.bias"]


def cached(hop_list):
    return hop_list[-1]


def rows(feats, idx):
    return feats[idx]


def forward_flops_per_row(cfg: dict) -> int:
    a = cfg["model_args"]
    return 2 * a["feat_dim"] * a["output_dim"]
