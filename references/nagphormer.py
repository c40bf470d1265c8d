"""Plain reference of NAGphormer (Chen, Gao, Xiao, Song, He, "NAGphormer: A
Tokenized Graph Transformer for Node Classification in Large Graphs", ICLR
2023, arXiv:2206.04910; code github.com/JHL-HUST/NAGphormer) for the tests
that hold ``sgl_tpu_torch.models.NAGphormer`` to it.  Plain ``torch``
operations in the parameters' dtype (float32 or float64), importing
nothing of ``sgl_tpu``, ``sgl_tpu_torch`` or JAX.

``args`` are the model's constructor arguments: ``prop_steps`` (K),
``feat_dim`` (d), ``output_dim`` (C), ``hidden_dim`` (h), ``num_heads``
(H), ``num_layers`` (L), ``dropout`` and ``attn_dropout``.

* Hop tokens: ``X_v = [x_v, (Âx)_v, …, (Â^K x)_v]``, ``Â = D̃^-1/2 (A+I)
  D̃^-1/2`` (:func:`hop_stack`, hop-major ``(K+1, N, d)``).
* ``Z_0 = X W_e + b_e``; each pre-LN layer ``Z' = Z + Drop(MHA(LN(Z)))``,
  ``Z = Z' + Drop(W_2 GELU(W_1 LN(Z')))``, ``f = 2h``, exact GELU, LN eps
  1e-5; MHA scales q by ``(h/H)^-1/2``, takes a softmax over the K+1 keys,
  drops the probabilities out (``attn_dropout``), then projects.
* Readout: ``Z = LN(Z)``, ``α = softmax_{k=1..K}(w_a·[z_0, z_k] + b_a)``,
  ``r = z_0 + Σ_k α_k z_k``; head ``W_o2 ReLU(W_o1 r + b_o1) + b_o2``, ``h
  -> h/2 -> C``.
* Init: every Linear weight ``N(0, (0.02/sqrt(L))²)``, biases 0, LayerNorms
  1 and 0; drawn from a CPU generator in the program's order (the order of
  ``net.named_parameters()``, whose names this module's keys are).

Departures from the published model, each the program's too:

* q, k and v are one ``(3h, h)`` weight, ``attn.qkv``, rows ``[q; k; v]``
  (NAGphormer's ``linear_q``, ``linear_k``, ``linear_v``, stacked), drawn
  in one call: the same distribution, other numbers;
* dropout keeps where a uint8 bit is below ``round(256·(1-p))`` and scales
  by ``256/keep_q`` (``FastDropout``'s quantized keep probability, 0.9
  becoming 230/256); the bits are drawn from the dropout generator in the
  program's order and tensor layout (per layer: the attention
  probabilities ``(B, H, K+1, K+1)``, the attention sublayer's output
  ``(B, K+1, h)``, the FFN's ``(B, K+1, h)``);
* training is Adam with an L2 term added to the gradient, at a constant
  learning rate (:func:`adam_l2_step`), not AdamW with warm-up and decay;
* the published model's ``scaling`` parameter, which its forward never
  reads, is left out.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def hop_stack(src, dst, num_nodes: int, x, prop_steps: int, dtype=torch.float64) -> torch.Tensor:
    """``[x, Âx, …, Â^K x]`` as a hop-major ``(K+1, N, d)`` tensor in
    ``dtype``: ``Â = D̃^-1/2 (A+I) D̃^-1/2``, ``D̃`` the row sums of ``A + I``,
    messages flowing ``x[src] -> y[dst]``."""
    loop = torch.arange(num_nodes)
    s = torch.cat([torch.as_tensor(np.asarray(src)).long(), loop])
    d = torch.cat([torch.as_tensor(np.asarray(dst)).long(), loop])
    deg = torch.bincount(s, minlength=num_nodes).to(dtype)
    w = deg.pow(-0.5)[d] * deg.pow(-0.5)[s]
    adj = torch.sparse_coo_tensor(torch.stack([d, s]), w, (num_nodes, num_nodes), check_invariants=False).coalesce()
    h = torch.as_tensor(np.asarray(x)).to(dtype)
    out = [h]
    for _ in range(prop_steps):
        h = torch.sparse.mm(adj, h)
        out.append(h)
    return torch.stack(out)


def init(args: dict, gen: torch.Generator) -> dict:
    """The parameters, drawn in float32 from ``gen`` (a CPU generator) in
    the program's order, named as ``net.named_parameters()``."""
    d, h, c, layers = args["feat_dim"], args["hidden_dim"], args["output_dim"], args["num_layers"]
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


def layer_norm(x, w, b, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def dropout(x, rate: float, gen):
    """Inverted dropout from uint8 bits of ``x``'s shape drawn from ``gen``
    on ``x``'s device: keep where the bits are below the quantized keep
    probability, scaled by its inverse."""
    if rate == 0.0:
        return x
    keep_q = min(max(int(round((1.0 - rate) * 256.0)), 1), 255)
    bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, device=x.device, generator=gen)
    return torch.where(bits < keep_q, x * (256.0 / keep_q), torch.zeros((), dtype=x.dtype, device=x.device))


def linear(x, p: dict, name: str):
    return x @ p[f"{name}.weight"].T + p[f"{name}.bias"]


def attention(x, p: dict, pre: str, heads: int, rate: float, train: bool, gen):
    """NAGphormer's ``MultiHeadAttention`` over ``x`` ``(B, T, h)``."""
    b, t, h = x.shape
    dh = h // heads
    w, bias = p[f"{pre}.qkv.weight"], p[f"{pre}.qkv.bias"]

    def split(s):  # (B, T, h) -> (B, H, T, dh)
        return (x @ w[s * h:(s + 1) * h].T + bias[s * h:(s + 1) * h]).view(b, t, heads, dh).transpose(1, 2)

    q, k, v = split(0), split(1), split(2)
    probs = torch.softmax(torch.matmul(q * dh ** -0.5, k.transpose(2, 3)), dim=3)
    if train:
        probs = dropout(probs, rate, gen)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(b, t, h)
    return linear(out, p, f"{pre}.out")


def forward(args: dict, p: dict, hops, train: bool = False, gen=None):
    """The logits ``(B, C)`` of a batch's hop stack ``hops`` ``(K+1, B, d)``;
    in training the dropouts draw their bits from ``gen``."""
    rate = args["dropout"]

    def drop(x):
        return dropout(x, rate, gen) if train else x

    z = linear(hops.transpose(0, 1), p, "msg_op.embed")  # (B, K+1, h)
    for i in range(args["num_layers"]):
        pre = f"msg_op.layers.{i}"
        y = layer_norm(z, p[f"{pre}.attn_norm.weight"], p[f"{pre}.attn_norm.bias"])
        z = z + drop(attention(y, p, f"{pre}.attn", args["num_heads"], args["attn_dropout"], train, gen))
        y = layer_norm(z, p[f"{pre}.ffn_norm.weight"], p[f"{pre}.ffn_norm.bias"])
        y = linear(torch.nn.functional.gelu(linear(y, p, f"{pre}.ffn.fc1")), p, f"{pre}.ffn.fc2")
        z = z + drop(y)
    z = layer_norm(z, p["msg_op.final_norm.weight"], p["msg_op.final_norm.bias"])
    node, neighbors = z[:, :1], z[:, 1:]
    score = linear(torch.cat([node.expand_as(neighbors), neighbors], dim=2), p, "msg_op.readout")  # (B, K, 1)
    r = (node + (torch.softmax(score, dim=1) * neighbors).sum(dim=1, keepdim=True))[:, 0]
    return linear(torch.relu(linear(r, p, "base_model.fc1")), p, "base_model.fc2")


def loss(logits, labels, w):
    """The weighted mean cross-entropy: ``Σ w_i ce_i / max(Σ w_i, 1)``."""
    ce = torch.logsumexp(logits, dim=1) - logits.gather(1, labels[:, None])[:, 0]
    return (ce * w).sum() / w.sum().clamp(min=1.0)


def adam_l2_step(p: dict, grads: dict, state: dict, lr: float, weight_decay: float) -> None:
    """One Adam step with ``weight_decay · p`` added to each gradient
    (betas 0.9, 0.999, eps 1e-8), in place; ``state`` starts empty."""
    t = state["t"] = state.get("t", 0) + 1
    with torch.no_grad():
        for k, q in p.items():
            g = grads[k] + weight_decay * q
            m = state.setdefault(("m", k), torch.zeros_like(q))
            v = state.setdefault(("v", k), torch.zeros_like(q))
            m.mul_(BETA1).add_(g, alpha=1 - BETA1)
            v.mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
            q.addcdiv_(m, (v.sqrt() / math.sqrt(1 - BETA2 ** t)).add_(EPS), value=-lr / (1 - BETA1 ** t))


def flops_per_row(args: dict) -> int:
    """A forward's multiply-adds ×2 for one node: the embedding, each
    layer's q/k/v/output projections, scores and weighted values, the FFN,
    the readout and the head."""
    t, d, h, c = args["prop_steps"] + 1, args["feat_dim"], args["hidden_dim"], args["output_dim"]
    per_layer = 2 * t * h * h * 4 + 2 * t * t * h * 2 + 2 * t * h * 2 * h * 2
    readout = 2 * (t - 1) * 2 * h + 2 * (t - 1) * h
    return 2 * t * d * h + args["num_layers"] * per_layer + readout + 2 * h * (h // 2) + 2 * (h // 2) * c
