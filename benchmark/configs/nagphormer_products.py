"""Plain reference of ``nagphormer_products.json``'s model, NAGphormer (Chen
et al., ICLR 2023, arXiv:2206.04910), the benchmark's copy of the repo's
``references/nagphormer.py`` in this harness's interface, with ``prec``.

The cached feature is the hop stack ``[x, Âx, …, Â^K x]``, hop-major.  A
batch's ``K+1`` hops per node are tokens: ``Z = X W_e + b_e``; each pre-LN
layer ``Z += Drop(MHA(LN(Z)))``, ``Z += Drop(W_2 GELU(W_1 LN(Z)))`` (``f =
2h``, exact GELU, LN eps 1e-5; MHA: q scaled by ``(h/H)^-1/2``, a softmax
over the K+1 keys, attention dropout, the output projection); the readout
``Z = LN(Z)``, ``r = z_0 + Σ_k softmax_k(w_a·[z_0, z_k] + b_a) z_k`` over
hops 1..K; the head ``W_o2 ReLU(W_o1 r + b_o1) + b_o2`` (``h -> h/2 ->
C``).  Every Linear weight is drawn ``N(0, (0.02/sqrt(L))²)`` from a CPU
generator in the program's order, biases 0, LayerNorms 1 and 0; the
dropout bits come from a generator on the device in the program's order
and tensor layout (per layer: the attention probabilities ``(B, H, K+1,
K+1)``, then the two sublayers' outputs ``(B, K+1, h)``).

Departures from the published model, the program's too: q, k and v are
one ``(3h, h)`` weight (rows ``[q; k; v]``), drawn in one call; dropout's
keep probability is quantized to ``round(256·0.9)/256``; Adam with an L2
term at a constant learning rate (the harness's ``train_steps``), not
AdamW with warm-up and decay; the unused ``scaling`` parameter is left
out.  With ``prec="tf32"`` every product, the batched attention ones too,
takes operands rounded to TF32, forward and backward."""

from __future__ import annotations

import math

import torch

import reference as ref


class _TF32BatchedMatMul(torch.autograd.Function):
    """``a @ b`` over the last two axes with TF32 operands, forward and
    backward (``reference.matmul`` takes 2-D operands)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return ref.tf32(a) @ ref.tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = ref.tf32(g)
        return g @ ref.tf32(b).transpose(-1, -2), ref.tf32(a).transpose(-1, -2) @ g


def _bmm(a, b, prec: str):
    return _TF32BatchedMatMul.apply(a, b) if prec == "tf32" else a @ b


def _linear(x, p: dict, name: str, prec: str, rows: slice = slice(None)):
    """``x @ W[rows].T + b[rows]`` for ``x`` of any leading shape."""
    w, b = p[f"{name}.weight"][rows], p[f"{name}.bias"][rows]
    return ref.matmul(x.reshape(-1, x.shape[-1]), w.T, prec).view(*x.shape[:-1], w.shape[0]) + b


def _layer_norm(x, p: dict, name: str, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p[f"{name}.weight"] + p[f"{name}.bias"]


def init(cfg: dict, gen) -> dict:
    a = cfg["model_args"]
    d, h, c, layers = a["feat_dim"], a["hidden_dim"], a["output_dim"], a["num_layers"]
    std = 0.02 / math.sqrt(layers)
    p = {}

    def linear(name, fan_in, fan_out):
        p[f"{name}.weight"] = torch.empty(fan_out, fan_in).normal_(0.0, std, generator=gen)
        p[f"{name}.bias"] = torch.zeros(fan_out)

    def norm(name, width):
        p[f"{name}.weight"], p[f"{name}.bias"] = torch.ones(width), torch.zeros(width)

    linear("msg_op.embed", d, h)
    for i in range(layers):
        pre = f"msg_op.layers.{i}"
        norm(f"{pre}.attn_norm", h)
        linear(f"{pre}.attn.qkv", h, 3 * h)
        linear(f"{pre}.attn.out", h, h)
        norm(f"{pre}.ffn_norm", h)
        linear(f"{pre}.ffn.fc1", h, 2 * h)
        linear(f"{pre}.ffn.fc2", 2 * h, h)
    norm("msg_op.final_norm", h)
    linear("msg_op.readout", 2 * h, 1)
    linear("base_model.fc1", h, h // 2)
    linear("base_model.fc2", h // 2, c)
    return p


def _attention(x, p: dict, pre: str, heads: int, rate: float, train: bool, gen, prec: str):
    b, t, h = x.shape
    dh = h // heads
    q, k, v = (_linear(x, p, f"{pre}.qkv", prec, slice(s * h, (s + 1) * h)).view(b, t, heads, dh).transpose(1, 2)
               for s in range(3))  # (B, H, T, dh)
    probs = torch.softmax(_bmm(q * dh ** -0.5, k.transpose(2, 3), prec), dim=3)
    if train:
        probs = ref.dropout(probs, rate, gen)
    return _linear(_bmm(probs, v, prec).transpose(1, 2).reshape(b, t, h), p, f"{pre}.out", prec)


def forward(cfg: dict, params: dict, feats, train: bool, gen, prec: str):
    """``feats`` is the batch's hop stack ``(K+1, B, D)``."""
    a = cfg["model_args"]
    p = params

    def drop(x):
        return ref.dropout(x, a["dropout"], gen) if train else x

    z = _linear(feats.transpose(0, 1), p, "msg_op.embed", prec)  # (B, K+1, h)
    for i in range(a["num_layers"]):
        pre = f"msg_op.layers.{i}"
        z = z + drop(_attention(_layer_norm(z, p, f"{pre}.attn_norm"), p, f"{pre}.attn", a["num_heads"],
                                a["attn_dropout"], train, gen, prec))
        y = _linear(_layer_norm(z, p, f"{pre}.ffn_norm"), p, f"{pre}.ffn.fc1", prec)
        z = z + drop(_linear(torch.nn.functional.gelu(y), p, f"{pre}.ffn.fc2", prec))
    z = _layer_norm(z, p, "msg_op.final_norm")
    node, neighbors = z[:, :1], z[:, 1:]
    score = _linear(torch.cat([node.expand_as(neighbors), neighbors], dim=2), p, "msg_op.readout", prec)
    r = (node + (torch.softmax(score, dim=1) * neighbors).sum(dim=1, keepdim=True))[:, 0]
    return _linear(torch.relu(_linear(r, p, "base_model.fc1", prec)), p, "base_model.fc2", prec)


def cached(hop_list):
    return torch.stack(hop_list)


def rows(feats, idx):
    return feats[:, idx]


def forward_flops_per_row(cfg: dict) -> int:
    """A forward's multiply-adds ×2 for one node: the embedding, each
    layer's q/k/v/output projections (``8·T·h²``), scores and weighted
    values (``4·T²·h``) and FFN (``8·T·h²``), the readout and the head; ``T
    = K+1`` tokens."""
    a = cfg["model_args"]
    t, d, h, c = a["prop_steps"] + 1, a["feat_dim"], a["hidden_dim"], a["output_dim"]
    per_layer = 8 * t * h * h + 4 * t * t * h + 8 * t * h * h
    readout = 4 * (t - 1) * h + 2 * (t - 1) * h
    return 2 * t * d * h + a["num_layers"] * per_layer + readout + 2 * h * (h // 2) + 2 * (h // 2) * c
