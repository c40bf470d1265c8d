"""Trainable building blocks — counterpart of ``sgl_tpu/models/blocks.py``.

Initialization follows the Flax reference so both packages draw from the
same distributions (not the same numbers: the random streams differ):

* ``Dense`` defaults to Flax's ``lecun_normal`` — a normal truncated at two
  standard deviations, scaled to variance ``1/fan_in`` — and a zero bias;
* the MLP's layers use ``variance_scaling(2, fan_avg, uniform)`` (xavier
  uniform with ReLU gain) and zero biases;
* ``PReLU`` is one slope, 0.25, shared across the MLP's layers.

Every module that owns parameters has ``reset_parameters(generator)``;
:func:`init_params` runs them all from one explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# Flax's truncated normal: unit normal cut at ±2, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def xavier_relu_uniform_(w: torch.Tensor, fan_in: int, fan_out: int, generator=None):
    """``variance_scaling(2.0, "fan_avg", "uniform")``."""
    limit = math.sqrt(3.0 * 2.0 / ((fan_in + fan_out) / 2.0))
    return nn.init.uniform_(w, -limit, limit, generator=generator)


def init_params(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """(Re)initialize every parameter of ``module`` from ``generator``."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


class Dense(nn.Module):
    """Affine layer ``x @ weight.T + bias`` with Flax ``Dense``'s
    initializers.  ``weight`` is ``(out, in)``, the transpose of a Flax
    ``kernel``.  ``forward(x, dtype)`` computes in ``dtype`` when given
    (parameters stay f32), as Flax ``Dense(dtype=...)`` does."""

    def __init__(self, in_features: int, out_features: int, kernel_init: str = "lecun_normal"):
        super().__init__()
        if kernel_init not in ("lecun_normal", "xavier_relu"):
            raise ValueError(f"unknown kernel_init {kernel_init!r}")
        self.kernel_init = kernel_init
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        out_f, in_f = self.weight.shape
        if self.kernel_init == "lecun_normal":
            lecun_normal_(self.weight, in_f, generator)
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
    probability ``256 / keep_q`` so the expectation stays exact."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, train: bool, generator=None) -> torch.Tensor:
        if self.rate == 0.0 or not train:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep_q = min(max(int(round((1.0 - self.rate) * 256.0)), 1), 255)
        bits = torch.randint(
            0, 256, x.shape, dtype=torch.uint8, device=x.device, generator=generator
        )
        return torch.where(bits < keep_q, x * (256.0 / keep_q), torch.zeros((), dtype=x.dtype, device=x.device))


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
    """PReLU + dropout MLP (Flax param tree: ``Dense_0..Dense_{L-1}``,
    ``PReLU_0``).

    ``compute_dtype=torch.bfloat16`` runs the matmuls and activations in
    bf16 (parameters stay f32; logits come back f32)."""

    def __init__(
        self,
        in_dim: int,
        hidden_dim: int,
        num_layers: int,
        output_dim: int,
        dropout: float = 0.5,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if num_layers < 2:
            raise ValueError("MLP must have at least two layers!")
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Dense(a, b, kernel_init="xavier_relu") for a, b in zip(dims[:-1], dims[1:])
        )
        self.prelu = PReLU()  # single slope shared across layers, like torch nn.PReLU()
        self.dropout = FastDropout(dropout)
        self.compute_dtype = compute_dtype

    def forward(self, x, train: bool = False, generator=None):
        dt = self.compute_dtype
        if dt is not None:
            x = x.to(dt)
        for layer in self.layers[:-1]:
            x = self.prelu(layer(x, dt))
            x = self.dropout(x, train, generator)
        out = self.layers[-1](x, dt)
        return out.float() if dt is not None else out
