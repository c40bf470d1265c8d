"""Message ops: hop aggregation over the stacked ``(K+1, B, D)`` tensor.

Counterpart of ``sgl_tpu/ops/message_ops.py`` (this slice: the base class,
``LastMessageOp`` and ``LearnableWeightedMessageOp``).  Ops are
``nn.Module``s; ``aggr_type`` drives the eager-vs-lazy aggregation split in
``SGAPModel`` exactly as in the reference.  Hop stacks are hop-major.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

LEARNABLE_AGGR_TYPES = frozenset(
    {"proj_concat", "learnable_weighted", "iterate_learnable_weighted"}
)


class MessageOp(nn.Module):
    """Base: slices hops ``[start:end)`` then combines.  Subclasses set
    ``aggr_type`` as a class attribute."""

    aggr_type: str = ""

    def __init__(self, start: Optional[int] = None, end: Optional[int] = None):
        super().__init__()
        self.start = start
        self.end = end

    def _slice(self, hops: torch.Tensor) -> torch.Tensor:
        return hops[self.start : self.end]

    def linear_weights(self, k_all: int):
        """Fixed per-hop weights ``w`` such that ``aggregate(hops) ==
        sum_k w[k] hops[k]``, or None when the op is not a static linear
        combination (enables the fused ``k_hop_aggregate`` path)."""
        return None


class LastMessageOp(MessageOp):
    """``hops[-1]`` (SGC)."""

    aggr_type: str = "last"

    def forward(self, hops):
        return hops[-1]

    def linear_weights(self, k_all: int):
        w = np.zeros(k_all, np.float32)
        w[-1] = 1.0
        return w


class LearnableWeightedMessageOp(MessageOp):
    """Learnable hop weighting, five combination types (GAMLP's JK
    attention = ``'jk'``).

    Parameters, by type (Flax names in brackets, for ``convert.py``):

    * ``simple`` / ``simple_allow_neg``: ``hop_weight`` ``(prop_steps+1,)``
      [``hop_weight``];
    * ``gate``: ``gate`` = ``Dense(feat_dim, 1)`` [``Dense_0``];
    * ``ori_ref`` / ``jk``: ``gate`` = ``Dense(ref_dim + feat_dim, 1)``
      [``gate_kernel``, ``gate_bias``], ``ref_dim`` = ``feat_dim`` for
      ``ori_ref`` and ``(prop_steps+1)·feat_dim`` for ``jk``.

    The gate of ``ori_ref``/``jk`` reads ``concat(reference, hop_k)``.  The
    reference is the same for every hop, so the gate's weight is split: the
    reference half is applied once per node, never broadcast into a
    ``(K, B, ref_dim + D)`` concat.  For ``jk`` it is applied hop by hop on
    the hop-major stack, so the ``(B, (K+1)·D)`` concat is not built either.
    The weights are a softmax over the hops of the sigmoid of the logits,
    per node.
    """

    aggr_type: str = "learnable_weighted"

    def __init__(
        self,
        start: Optional[int] = None,
        end: Optional[int] = None,
        combination_type: str = "simple",
        prop_steps: int = 0,
        feat_dim: int = 0,
    ):
        from sgl_tpu_torch.models.blocks import Dense

        super().__init__(start, end)
        ct = combination_type
        self.combination_type = ct
        self.prop_steps = prop_steps
        self.feat_dim = feat_dim
        self.hop_weight = None
        self.gate = None
        if ct in ("simple", "simple_allow_neg"):
            self.hop_weight = nn.Parameter(torch.empty(prop_steps + 1))
        elif ct in ("gate", "ori_ref", "jk"):
            if feat_dim <= 0:
                raise ValueError(f"combination_type {ct!r} needs feat_dim")
            ref_dim = {"gate": 0, "ori_ref": feat_dim, "jk": (prop_steps + 1) * feat_dim}[ct]
            self.gate = Dense(ref_dim + feat_dim, 1)
        else:
            raise ValueError(
                "Invalid weighted combination type! Type must be 'simple', "
                "'simple_allow_neg', 'gate', 'ori_ref' or 'jk'."
            )
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Initializes ``hop_weight`` (xavier_normal of a (1, K+1) tensor,
        as the reference does); the gate is a ``Dense`` and resets itself."""
        if self.hop_weight is not None:
            std = (2.0 / (1 + self.prop_steps + 1)) ** 0.5
            nn.init.normal_(self.hop_weight, 0.0, std, generator=generator)

    def forward(self, hops: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        ct = self.combination_type
        param = self.hop_weight if self.gate is None else self.gate.weight
        # bf16 hops meet f32 parameters in f32, as JAX's type promotion does
        hops = hops.to(torch.promote_types(hops.dtype, param.dtype))
        h = self._slice(hops)  # (K, B, D)
        if ct in ("simple", "simple_allow_neg"):
            w = self.hop_weight[self.start : self.end]
            if ct == "simple":
                w = torch.softmax(torch.sigmoid(w), dim=0)
            return torch.einsum("k,kbd->bd", w, h)

        kernel = self.gate.weight[0]  # (ref_dim + D,)
        d = h.shape[-1]
        ref_dim = kernel.shape[0] - d
        hop_logit = torch.einsum("kbd,d->kb", h, kernel[ref_dim:])
        if ct == "gate":
            logits = hop_logit + self.gate.bias
        else:
            if ct == "ori_ref":
                ref_logit = hops[0] @ kernel[:ref_dim]  # (B,)
            else:
                # jk: concat(hops[0..K]) @ kernel[:ref_dim], hop by hop
                ref_logit = torch.einsum(
                    "kbd,kd->b", hops, kernel[:ref_dim].view(hops.shape[0], d)
                )
            logits = ref_logit[None] + hop_logit + self.gate.bias
        w = torch.softmax(torch.sigmoid(logits), dim=0)  # over hops, per node
        return torch.einsum("kb,kbd->bd", w, h)
