"""Message ops: hop aggregation over the stacked ``(K+1, B, D)`` tensor.

Counterpart of ``sgl_tpu/ops/message_ops.py``: the same eleven ops, as
``nn.Module``s.  ``aggr_type`` drives the eager-vs-lazy aggregation split in
``SGAPModel`` as in ``sgl_tpu``.  Hop stacks are hop-major; the two
attention ops (``supports_node_major``) also take a node-major
``(B, K+1, D)`` stack with ``node_major=True``.

The quirks ``sgl_tpu`` keeps are kept here (PARITY.md §2.2–2.3): the first
hop's projection in ``ProjectedConcatMessageOp`` gets no ReLU; the
recursive op re-softmaxes weights that are already softmaxed; the
over-smoothing op is one einsum, not a loop over nodes.
"""

from __future__ import annotations

from typing import Optional, Sequence

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
    # ops that accept a (B, K, D) node-major hop stack set this to True
    supports_node_major: bool = False

    def __init__(self, start: Optional[int] = None, end: Optional[int] = None):
        super().__init__()
        self.start = start
        self.end = end

    def _slice(self, hops: torch.Tensor) -> torch.Tensor:
        return hops[self.start : self.end]

    @property
    def learnable(self) -> bool:
        """Whether the op has weights of its own (its ``aggr_type`` is one
        of :data:`LEARNABLE_AGGR_TYPES`)."""
        return self.aggr_type in LEARNABLE_AGGR_TYPES

    def linear_weights(self, k_all: int):
        """Fixed per-hop weights ``w`` such that ``aggregate(hops) ==
        sum_k w[k] hops[k]``, or None when the op is not a static linear
        combination (enables the fused ``k_hop_aggregate`` path)."""
        return None

    def _slice_range(self, k_all: int):
        start = 0 if self.start is None else self.start
        end = k_all if self.end is None else self.end
        return start, end


class LastMessageOp(MessageOp):
    """``hops[-1]`` (SGC)."""

    aggr_type: str = "last"

    def forward(self, hops):
        return hops[-1]

    def linear_weights(self, k_all: int):
        w = np.zeros(k_all, np.float32)
        w[-1] = 1.0
        return w


class SumMessageOp(MessageOp):
    """Sum over hops."""

    aggr_type: str = "sum"

    def forward(self, hops):
        return torch.sum(self._slice(hops), dim=0)

    def linear_weights(self, k_all: int):
        start, end = self._slice_range(k_all)
        w = np.zeros(k_all, np.float32)
        w[start:end] = 1.0
        return w


class MeanMessageOp(MessageOp):
    """Mean over hops (S²GC)."""

    aggr_type: str = "mean"

    def forward(self, hops):
        return torch.mean(self._slice(hops), dim=0)

    def linear_weights(self, k_all: int):
        start, end = self._slice_range(k_all)
        w = np.zeros(k_all, np.float32)
        w[start:end] = 1.0 / max(end - start, 1)
        return w


class MaxMessageOp(MessageOp):
    """Elementwise max over hops."""

    aggr_type: str = "max"

    def forward(self, hops):
        return torch.amax(self._slice(hops), dim=0)


class MinMessageOp(MessageOp):
    """Elementwise min over hops."""

    aggr_type: str = "min"

    def forward(self, hops):
        return torch.amin(self._slice(hops), dim=0)


class ConcatMessageOp(MessageOp):
    """Feature-axis concat in hop order (SIGN): ``(B, K·D)``."""

    aggr_type: str = "concat"

    def forward(self, hops):
        h = self._slice(hops)  # (K, B, D)
        k, b, d = h.shape
        return h.movedim(0, 1).reshape(b, k * d)


class ProjectedConcatMessageOp(MessageOp):
    """Per-hop MLP projection, then concat (the original SIGN).  The first
    hop's projection gets no ReLU, later ones do, as in ``sgl_tpu``.

    Flax infers each projection's input width; here ``feat_dim`` gives it,
    and ``start``/``end`` must both be set (they give the number of
    projections, ``end - start``).  The projections are
    ``MultiLayerPerceptron(feat_dim, hidden_dim, num_layers, hidden_dim)``
    with their default dropout [Flax ``MultiLayerPerceptron_i``]."""

    aggr_type: str = "proj_concat"

    def __init__(
        self,
        start: Optional[int] = None,
        end: Optional[int] = None,
        hidden_dim: int = 0,
        num_layers: int = 2,
        feat_dim: int = 0,
    ):
        from sgl_tpu_torch.models.blocks import MultiLayerPerceptron

        super().__init__(start, end)
        if start is None or end is None or end <= start:
            raise ValueError("ProjectedConcatMessageOp needs start < end to size its projections")
        if feat_dim <= 0 or hidden_dim <= 0:
            raise ValueError("ProjectedConcatMessageOp needs feat_dim and hidden_dim")
        self.projections = nn.ModuleList(
            MultiLayerPerceptron(feat_dim, hidden_dim, num_layers, hidden_dim)
            for _ in range(end - start)
        )

    def forward(self, hops, train: bool = False, generator=None):
        h = self._slice(hops)
        if h.shape[0] != len(self.projections):
            raise ValueError(f"{h.shape[0]} hops for {len(self.projections)} projections")
        outs = []
        for i, proj in enumerate(self.projections):
            p = proj(h[i], train=train, generator=generator)
            outs.append(p if i == 0 else torch.relu(p))
        return torch.cat(outs, dim=-1)


class SimpleWeightedMessageOp(MessageOp):
    """Fixed scalar hop weights.

    ``alpha`` mode: geometric weights ``α(1-α)^k`` over the *full* hop list,
    then sliced (GBP).  ``hand_crafted`` mode: the caller's weights, one per
    sliced hop.
    """

    aggr_type: str = "simple_weighted"

    def __init__(
        self,
        start: Optional[int] = None,
        end: Optional[int] = None,
        combination_type: str = "alpha",
        alpha: float = 0.85,
        weight_list: Optional[Sequence[float]] = None,
    ):
        super().__init__(start, end)
        self.combination_type = combination_type
        self.alpha = alpha
        self.weight_list = weight_list

    def forward(self, hops):
        h = self._slice(hops)
        if self.combination_type == "alpha":
            if not 0.0 <= self.alpha <= 1.0:
                raise ValueError("The alpha must be a float in [0,1]!")
            k = torch.arange(hops.shape[0], dtype=torch.float32, device=hops.device)
            w = (self.alpha * (1.0 - self.alpha) ** k)[self.start : self.end]
        elif self.combination_type == "hand_crafted":
            w = torch.as_tensor(self.weight_list, dtype=torch.float32, device=hops.device)
            if w.shape[0] != h.shape[0]:
                raise ValueError("The feature list and the weight list have different lengths!")
        else:
            raise ValueError(
                "Invalid weighted combination type! Type must be 'alpha' or 'hand_crafted'."
            )
        return torch.tensordot(w.to(h.dtype), h, dims=1)

    def linear_weights(self, k_all: int):
        start, end = self._slice_range(k_all)
        w = np.zeros(k_all, np.float32)
        if self.combination_type == "alpha":
            full = self.alpha * (1.0 - self.alpha) ** np.arange(k_all)
            w[start:end] = full[start:end]
        elif self.combination_type == "hand_crafted":
            vals = np.asarray(self.weight_list, np.float32)
            if vals.shape[0] != end - start:
                return None
            w[start:end] = vals
        else:
            return None
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
    per node.  With ``node_major=True`` the stack is ``(B, K+1, D)``: the
    same parameters and math, and the ``jk`` concat is a free reshape.
    """

    aggr_type: str = "learnable_weighted"
    supports_node_major: bool = True

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

    def forward(
        self, hops: torch.Tensor, train: bool = False, generator=None, node_major: bool = False
    ) -> torch.Tensor:
        """``hops`` is ``(K+1, B, D)``, or ``(B, K+1, D)`` with
        ``node_major=True`` (the same math in the batch-major layout)."""
        ct = self.combination_type
        param = self.hop_weight if self.gate is None else self.gate.weight
        # bf16 hops meet f32 parameters in f32, as JAX's type promotion does
        hops = hops.to(torch.promote_types(hops.dtype, param.dtype))
        # (K, B, D) or (B, K, D)
        h = hops[:, self.start : self.end] if node_major else self._slice(hops)
        hop_ax = 1 if node_major else 0
        if ct in ("simple", "simple_allow_neg"):
            w = self.hop_weight[self.start : self.end]
            if ct == "simple":
                w = torch.softmax(torch.sigmoid(w), dim=0)
            return torch.einsum("k,bkd->bd" if node_major else "k,kbd->bd", w, h)

        kernel = self.gate.weight[0]  # (ref_dim + D,)
        d = h.shape[-1]
        ref_dim = kernel.shape[0] - d
        hop_logit = torch.einsum("bkd,d->bk" if node_major else "kbd,d->kb", h, kernel[ref_dim:])
        if ct == "gate":
            logits = hop_logit + self.gate.bias
        else:
            if ct == "ori_ref":
                ref_logit = (hops[:, 0] if node_major else hops[0]) @ kernel[:ref_dim]  # (B,)
            elif node_major:
                # jk: the concat of the hops is a free reshape of (B, K+1, D)
                ref_logit = hops.reshape(hops.shape[0], -1) @ kernel[:ref_dim]
            else:
                # jk: concat(hops[0..K]) @ kernel[:ref_dim], hop by hop
                ref_logit = torch.einsum(
                    "kbd,kd->b", hops, kernel[:ref_dim].view(hops.shape[0], d)
                )
            ref_logit = ref_logit[:, None] if node_major else ref_logit[None]
            logits = ref_logit + hop_logit + self.gate.bias
        w = torch.softmax(torch.sigmoid(logits), dim=hop_ax)  # over hops, per node
        return torch.einsum("bk,bkd->bd" if node_major else "kb,kbd->bd", w, h)


class IterateLearnableWeightedMessageOp(MessageOp):
    """GAMLP-Recursive: hop ``i`` is gated against the running weighted sum,
    and all weights so far are re-softmaxed at each step.

    As in ``sgl_tpu``, the weights kept between steps are the ones already
    softmaxed: the next raw sigmoid is appended to them and the whole list
    is softmaxed again.  The gate is ``Dense(2·feat_dim, 1)`` [Flax
    ``Dense_0``]; Flax infers its width, here ``feat_dim`` gives it."""

    aggr_type: str = "iterate_learnable_weighted"
    supports_node_major: bool = True

    def __init__(
        self,
        start: Optional[int] = None,
        end: Optional[int] = None,
        combination_type: str = "recursive",
        feat_dim: int = 0,
    ):
        from sgl_tpu_torch.models.blocks import Dense

        super().__init__(start, end)
        if combination_type != "recursive":
            raise ValueError("Invalid weighted combination type! Type must be 'recursive'.")
        if feat_dim <= 0:
            raise ValueError("IterateLearnableWeightedMessageOp needs feat_dim")
        self.combination_type = combination_type
        self.feat_dim = feat_dim
        self.gate = Dense(2 * feat_dim, 1)

    def forward(
        self, hops: torch.Tensor, train: bool = False, generator=None, node_major: bool = False
    ) -> torch.Tensor:
        hops = hops.to(torch.promote_types(hops.dtype, self.gate.weight.dtype))
        h = hops[:, self.start : self.end] if node_major else self._slice(hops)
        k = h.shape[1 if node_major else 0]

        def hop(i):
            return h[:, i] if node_major else h[i]

        weighted = hop(0)
        w = None  # (B, i+1) weights so far, softmaxed
        for i in range(k):
            g = torch.sigmoid(self.gate(torch.cat([hop(i), weighted], dim=-1)))  # (B, 1)
            w = g if w is None else torch.cat([w, g], dim=1)
            w = torch.softmax(w, dim=1)
            weighted = (
                torch.einsum("bk,bkd->bd", w, h[:, : i + 1])
                if node_major
                else torch.einsum("bk,kbd->bd", w, h[: i + 1])
            )
        return weighted


class OverSmoothDistanceWeightedOp(MessageOp):
    """NAFS: per node, a softmax over the hops of each hop's cosine
    similarity to hop 0, as one einsum (the ``1e-10`` guards of
    ``sgl_tpu``'s)."""

    aggr_type: str = "over_smooth_dis_weighted"

    def forward(self, hops):
        ref = hops[0]  # (B, D)
        ref_norm = torch.linalg.vector_norm(ref, dim=-1) + 1e-10  # (B,)
        norms = torch.linalg.vector_norm(hops, dim=-1) + 1e-10  # (K+1, B)
        cos = torch.einsum("bd,kbd->kb", ref, hops) / (norms * ref_norm[None])
        w = torch.softmax(cos, dim=0)  # over hops, per node
        return torch.einsum("kb,kbd->bd", w, hops)
