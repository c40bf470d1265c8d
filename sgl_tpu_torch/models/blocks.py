"""Trainable building blocks — counterpart of ``sgl_tpu/models/blocks.py``.

Initialization follows the Flax reference so both packages draw from the
same distributions (not the same numbers: the random streams differ):

* ``Dense`` defaults to Flax's ``lecun_normal`` — a normal truncated at two
  standard deviations, scaled to variance ``1/fan_in`` — and a zero bias;
* the MLP's layers use ``variance_scaling(2, fan_avg, uniform)`` (xavier
  uniform with ReLU gain) and zero biases;
* ``PReLU`` is one slope, 0.25, shared across the MLP's layers;
* ``BatchNorm`` starts at scale 1, bias 0, running mean 0 and variance 1;
* the NARS aggregators' 3-D weights use ``variance_scaling(1, fan_avg,
  uniform)`` with Flax's fan rule (:func:`flax_fans`), and
  ``FastOneDimConvolution`` starts from ones;
* the hop-token transformer's blocks (NAGphormer, which has no ``sgl_tpu``
  twin) draw every ``Dense`` weight from ``N(0, std²)`` with ``std =
  0.02/sqrt(num_layers)``, as NAGphormer's ``init_params`` does, zero
  biases, and ``LayerNorm`` starts at scale 1, bias 0.

Every module that owns parameters has ``reset_parameters(generator)``;
:func:`init_params` runs them all from one explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sgl_tpu_torch.utils.profiling import span

# Flax's truncated normal: unit normal cut at ±2, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def xavier_relu_uniform_(w: torch.Tensor, fan_in: int, fan_out: int, generator=None):
    """``variance_scaling(2.0, "fan_avg", "uniform")``."""
    limit = math.sqrt(3.0 * 2.0 / ((fan_in + fan_out) / 2.0))
    return nn.init.uniform_(w, -limit, limit, generator=generator)


def flax_fans(shape) -> tuple:
    """Flax's ``(fan_in, fan_out)`` of a weight: the last two axes are in
    and out, and every leading axis is the receptive field, multiplied into
    both (``(K, D, S)`` gives ``(D·K, S·K)``)."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def fan_avg_uniform_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """``variance_scaling(1.0, "fan_avg", "uniform")``: uniform within
    ``±sqrt(6 / (fan_in + fan_out))``."""
    fan_in, fan_out = flax_fans(tuple(w.shape))
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return nn.init.uniform_(w, -limit, limit, generator=generator)


def init_params(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """(Re)initialize every parameter of ``module`` from ``generator``."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


class Dense(nn.Module):
    """Affine layer ``x @ weight.T + bias`` with Flax ``Dense``'s
    initializers, or ``kernel_init="normal"``: ``N(0, std²)``.  ``weight``
    is ``(out, in)``, the transpose of a Flax ``kernel``.  ``forward(x,
    dtype)`` computes in ``dtype`` when given (parameters stay f32), as
    Flax ``Dense(dtype=...)`` does."""

    def __init__(self, in_features: int, out_features: int, kernel_init: str = "lecun_normal",
                 std: float = 0.02):
        super().__init__()
        if kernel_init not in ("lecun_normal", "xavier_relu", "normal"):
            raise ValueError(f"unknown kernel_init {kernel_init!r}")
        self.kernel_init = kernel_init
        self.std = std
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        out_f, in_f = self.weight.shape
        if self.kernel_init == "lecun_normal":
            lecun_normal_(self.weight, in_f, generator)
        elif self.kernel_init == "normal":
            nn.init.normal_(self.weight, 0.0, self.std, generator=generator)
        else:
            xavier_relu_uniform_(self.weight, in_f, out_f, generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        # no dtype: promote as Flax does (bf16 inputs meet f32 weights in f32)
        dt = dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class PReLU(nn.Module):
    """Parametric ReLU with a single shared slope, torch-init 0.25."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.init = init
        self.negative_slope = nn.Parameter(torch.tensor(init))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.negative_slope.fill_(self.init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the slope takes the activation's dtype, so bf16 stays bf16
        return torch.where(x >= 0, x, self.negative_slope.to(x.dtype) * x)


class FastDropout(nn.Module):
    """Inverted dropout from uint8 random bits: keep where
    ``bits < round(keep_prob * 256)`` and scale by the quantized keep
    probability ``256 / keep_q`` so the expectation stays exact.

    ``generator`` is a ``torch.Generator``, or any object with a
    ``bits(shape, device)`` method returning uint8 bits (bits recorded
    elsewhere, replayed).  ``batch_rows = (total, lo, hi)`` makes a rank of
    a data-parallel step draw the bits of the whole ``total``-row batch and
    keep rows ``[lo, hi)``, so its mask is the single-device step's
    (``parallel/train_dist.py`` sets it around a step)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.batch_rows = None

    def forward(self, x: torch.Tensor, train: bool, generator=None) -> torch.Tensor:
        if self.rate == 0.0 or not train:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep_q = min(max(int(round((1.0 - self.rate) * 256.0)), 1), 255)
        shape = x.shape if self.batch_rows is None else (self.batch_rows[0], *x.shape[1:])
        if hasattr(generator, "bits"):
            bits = generator.bits(shape, x.device)
        else:
            bits = torch.randint(0, 256, shape, dtype=torch.uint8, device=x.device, generator=generator)
        if self.batch_rows is not None:
            bits = bits[self.batch_rows[1]:self.batch_rows[2]]
        return torch.where(bits < keep_q, x * (256.0 / keep_q), torch.zeros((), dtype=x.dtype, device=x.device))


class BatchNorm(nn.BatchNorm1d):
    """Flax ``nn.BatchNorm`` over the batch axis, as an ``nn.BatchNorm1d``
    (``weight``/``bias`` are Flax's ``scale``/``bias``; the running buffers
    its ``batch_stats`` ``mean``/``var``).

    Flax's momentum 0.99 is PyTorch's 0.01 and its epsilon is 1e-5.  In
    train mode the batch's mean and biased variance (Flax's
    ``E[x²] - E[x]²``) normalize ``x`` and move the running statistics;
    PyTorch's own ``batch_norm`` would move the running variance by the
    unbiased one, so the update is written out here.  In eval mode the
    running statistics normalize.  Statistics are f32 for bf16 inputs too;
    the output has the input's dtype."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.01)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        super().reset_parameters()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x32 = x.float()
        if train:
            mean = x32.mean(dim=0)
            var = torch.clamp((x32 * x32).mean(dim=0) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(m * mean)
                self.running_var.mul_(1.0 - m).add_(m * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


class IdenticalMapping(nn.Module):
    """Identity base model for training-free pipelines."""

    def forward(self, x, train: bool = False, generator=None):
        return x


class LogisticRegression(nn.Module):
    """Single linear layer (Flax param tree: ``Dense_0``)."""

    def __init__(self, in_dim: int, output_dim: int):
        super().__init__()
        self.dense = Dense(in_dim, output_dim)

    def forward(self, x, train: bool = False, generator=None):
        return self.dense(x)


class MultiLayerPerceptron(nn.Module):
    """PReLU + dropout (+ optional batch norm) MLP (Flax param tree:
    ``Dense_0..Dense_{L-1}``, ``PReLU_0``, with ``bn`` also
    ``BatchNorm_0..BatchNorm_{L-2}``).

    ``compute_dtype=torch.bfloat16`` runs the matmuls and activations in
    bf16 (parameters stay f32; logits come back f32)."""

    def __init__(
        self,
        in_dim: int,
        hidden_dim: int,
        num_layers: int,
        output_dim: int,
        dropout: float = 0.5,
        bn: bool = False,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if num_layers < 2:
            raise ValueError("MLP must have at least two layers!")
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Dense(a, b, kernel_init="xavier_relu") for a, b in zip(dims[:-1], dims[1:])
        )
        self.bns = nn.ModuleList(BatchNorm(hidden_dim) for _ in dims[1:-1]) if bn else None
        self.prelu = PReLU()  # single slope shared across layers, like torch nn.PReLU()
        self.dropout = FastDropout(dropout)
        self.compute_dtype = compute_dtype

    def forward(self, x, train: bool = False, generator=None):
        dt = self.compute_dtype
        if dt is not None:
            x = x.to(dt)
        for i, layer in enumerate(self.layers[:-1]):
            x = layer(x, dt)
            if self.bns is not None:
                x = self.bns[i](x, train)
            x = self.dropout(self.prelu(x), train, generator)
        out = self.layers[-1](x, dt)
        return out.float() if dt is not None else out


class ResMultiLayerPerceptron(nn.Module):
    """Residual MLP, dropout first (Flax param tree: ``Dense_0..Dense_{L-1}``
    with Flax ``Dense``'s own initializers, with ``bn`` also
    ``BatchNorm_0..BatchNorm_{L-2}``).

    dropout → Dense_0 (→ BN) → ReLU is the first residual; each middle
    layer is dropout → Dense_i (→ BN) → ReLU, plus the residual, and its
    ReLU output (before the add) becomes the next residual; the last is
    dropout → Dense_{L-1}."""

    def __init__(
        self,
        in_dim: int,
        hidden_dim: int,
        num_layers: int,
        output_dim: int,
        dropout: float = 0.8,
        bn: bool = False,
    ):
        super().__init__()
        if num_layers < 2:
            raise ValueError("ResMLP must have at least two layers!")
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(Dense(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.bns = nn.ModuleList(BatchNorm(hidden_dim) for _ in dims[1:-1]) if bn else None
        self.dropout = FastDropout(dropout)

    def _hidden(self, i: int, x, train: bool, generator):
        h = self.layers[i](self.dropout(x, train, generator))
        if self.bns is not None:
            h = self.bns[i](h, train)
        return torch.relu(h)

    def forward(self, x, train: bool = False, generator=None):
        x = self._hidden(0, x, train, generator)
        residual = x
        for i in range(1, len(self.layers) - 1):
            h = self._hidden(i, x, train, generator)
            x = h + residual
            residual = h
        return self.layers[-1](self.dropout(x, train, generator))


class OneDimConvolution(nn.Module):
    """NARS aggregator: a learnable weight per (hop, feature, subgraph).
    Input ``(K, B, D, S)`` hop-major subgraph features; output the
    weighted mean over subgraphs, ``(K, B, D)`` [Flax ``weight`` ``(K, D,
    S)``]."""

    def __init__(self, num_subgraphs: int, prop_steps: int, feat_dim: int):
        super().__init__()
        self.num_subgraphs = num_subgraphs
        self.prop_steps = prop_steps
        self.weight = nn.Parameter(torch.empty(prop_steps, feat_dim, num_subgraphs))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        fan_avg_uniform_(self.weight, generator)

    def forward(self, feats_kbds: torch.Tensor) -> torch.Tensor:
        return torch.mean(feats_kbds * self.weight[:, None, :, :], dim=-1)


class OneDimConvolutionWeightSharedAcrossFeatures(OneDimConvolution):
    """As :class:`OneDimConvolution` with one weight per (hop, subgraph),
    shared across features [Flax ``weight`` ``(K, 1, S)``]."""

    def __init__(self, num_subgraphs: int, prop_steps: int):
        super().__init__(num_subgraphs, prop_steps, 1)


class FastOneDimConvolution(nn.Module):
    """One learnable weight per (subgraph, hop), applied as one matmul over
    packed ``(B, D, S·K)`` features (subgraph-major) [Flax ``weight``
    ``(S·K, 1)``].  Starts from ones, as ``sgl_tpu`` does."""

    def __init__(self, num_subgraphs: int, prop_steps: int):
        super().__init__()
        self.num_subgraphs = num_subgraphs
        self.prop_steps = prop_steps
        self.weight = nn.Parameter(torch.ones(num_subgraphs * prop_steps, 1))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.fill_(1.0)

    def forward(self, feats_bdsk: torch.Tensor) -> torch.Tensor:
        return torch.squeeze(feats_bdsk @ self.weight, dim=2)

    def subgraph_weight(self) -> torch.Tensor:
        """Each subgraph's weight summed over its hops: ``(S,)``."""
        return self.weight.detach().reshape(self.num_subgraphs, self.prop_steps).sum(dim=1)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over the last axis (eps 1e-5, scale 1, bias 0) whose
    ``reset_parameters`` takes the generator :func:`init_params` passes; it
    draws nothing from it."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        super().reset_parameters()


class MultiHeadAttention(nn.Module):
    """Self-attention over short token sequences ``(B, T, h)`` (NAGphormer's
    ``MultiHeadAttention``): ``num_heads`` heads of ``h / num_heads``, q
    scaled by ``head_dim^-1/2``, a softmax over the ``T`` keys, dropout on
    the probabilities through :class:`FastDropout` (bits of shape ``(B, H,
    T, T)``), then the output projection.  q, k and v are one ``(3h, h)``
    projection, ``qkv``, so that one product makes all three."""

    def __init__(self, hidden_dim: int, num_heads: int, attn_dropout: float, std: float):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError(f"hidden_dim {hidden_dim} is not a multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        self.scale = (hidden_dim // num_heads) ** -0.5
        self.qkv = Dense(hidden_dim, 3 * hidden_dim, kernel_init="normal", std=std)
        self.out = Dense(hidden_dim, hidden_dim, kernel_init="normal", std=std)
        self.attn_dropout = FastDropout(attn_dropout)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        b, t, h = x.shape
        # (B, T, 3, H, dh) -> three (B, H, T, dh)
        q, k, v = self.qkv(x).view(b, t, 3, self.num_heads, h // self.num_heads).permute(2, 0, 3, 1, 4)
        probs = torch.softmax((q * self.scale) @ k.transpose(-1, -2), dim=-1)
        probs = self.attn_dropout(probs, train, generator)
        return self.out((probs @ v).transpose(1, 2).reshape(b, t, h))


class FeedForward(nn.Module):
    """``fc2(GELU(fc1(x)))`` with the exact (erf) GELU, no inner dropout."""

    def __init__(self, hidden_dim: int, ffn_dim: int, std: float):
        super().__init__()
        self.fc1 = Dense(hidden_dim, ffn_dim, kernel_init="normal", std=std)
        self.fc2 = Dense(ffn_dim, hidden_dim, kernel_init="normal", std=std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class TransformerEncoderLayer(nn.Module):
    """A pre-LN encoder layer over ``(B, T, h)`` tokens:
    ``x + Drop(MHA(LN(x)))``, then ``x + Drop(FFN(LN(x)))``.  Its forward
    opens the spans ``sgl.hop_token.attention`` and ``sgl.hop_token.ffn``
    (stream-timed) around the two sublayers, residuals included."""

    def __init__(self, hidden_dim: int, num_heads: int, ffn_dim: int, dropout: float, attn_dropout: float,
                 std: float):
        super().__init__()
        self.attn_norm = LayerNorm(hidden_dim)
        self.attn = MultiHeadAttention(hidden_dim, num_heads, attn_dropout, std)
        self.ffn_norm = LayerNorm(hidden_dim)
        self.ffn = FeedForward(hidden_dim, ffn_dim, std)
        self.dropout = FastDropout(dropout)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        with span("sgl.hop_token.attention", stream=True):
            x = x + self.dropout(self.attn(self.attn_norm(x), train, generator), train, generator)
        with span("sgl.hop_token.ffn", stream=True):
            x = x + self.dropout(self.ffn(self.ffn_norm(x)), train, generator)
        return x


class TwoLayerHead(nn.Module):
    """``fc2(ReLU(fc1(x)))``, widths ``in_dim -> in_dim / 2 -> output_dim``
    (NAGphormer's ``out_proj`` and ``Linear1``), no dropout."""

    def __init__(self, in_dim: int, output_dim: int, std: float):
        super().__init__()
        self.fc1 = Dense(in_dim, in_dim // 2, kernel_init="normal", std=std)
        self.fc2 = Dense(in_dim // 2, output_dim, kernel_init="normal", std=std)

    def forward(self, x, train: bool = False, generator=None):
        return self.fc2(torch.relu(self.fc1(x)))
