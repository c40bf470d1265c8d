"""The plain reference the benchmark judges the program by: plain PyTorch,
importing nothing of the program and taking nothing it made.

It works out again, from the inputs the seed made (``inputs.Inputs``, or
a configuration's own), what the program derives: the normalized
adjacency ``D^-1/2 (A + I) D^-1/2``, its hops, a configuration's initial
parameters, batch order and dropout bits, its train steps (weighted
cross-entropy, backward, Adam with an L2 term) and its eval forward.  The
model of each configuration is the ``configs/<name>.py`` beside its file;
this module holds what they share.

``prec`` is ``"f64"`` for the judge; ``"tf32"`` for the control, float32
whose every product (matmuls, the SpMM) takes operands rounded to TF32's
10-bit mantissa, the step below the port's f32 with TF32 off; ``"f32"``
plain float32, in which the planted faults run.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def dtype_of(prec: str) -> torch.dtype:
    return {"f64": torch.float64, "f32": torch.float32, "tf32": torch.float32}[prec]


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (f32) rounded to the nearest TF32 value, ties away from zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` of 2-D f32 tensors with TF32 operands and an f32 sum, in
    the backward's two products too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        return g @ tf32(b).T, tf32(a).T @ g


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    return _TF32MatMul.apply(a, b) if prec == "tf32" else a @ b


def normalized_adjacency(inputs, device, prec: str, r: float = 0.5) -> torch.Tensor:
    """``D^{r-1} (A + I) D^{-r}`` as a sparse CSR tensor on ``device``:
    ``deg`` the row sums of ``A + I``, an edge ``(s, t)`` weighted
    ``deg[t]^(r-1) · deg[s]^(-r)``, messages flowing ``x[s] -> y[t]``."""
    n = inputs.num_nodes
    loop = torch.arange(n, device=device)
    src = torch.cat([torch.as_tensor(inputs.src, device=device).long(), loop])
    dst = torch.cat([torch.as_tensor(inputs.dst, device=device).long(), loop])
    deg = torch.bincount(src, minlength=n).double()
    w = deg.pow(r - 1.0)[dst] * deg.pow(-r)[src]
    del loop
    w = tf32(w.float()) if prec == "tf32" else w.to(dtype_of(prec))
    a = torch.sparse_coo_tensor(torch.stack([dst, src]), w, (n, n), check_invariants=False)
    del src, dst, w
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "sparse CSR support is in beta"
        return a.coalesce().to_sparse_csr()


def hops(adj: torch.Tensor, x, steps: int, prec: str) -> list:
    """``[x, Âx, …, Â^steps x]`` in ``prec``."""
    h = torch.as_tensor(x, device=adj.device).to(dtype_of(prec))
    out = [h]
    for _ in range(steps):
        h = adj @ (tf32(h) if prec == "tf32" else h)
        out.append(h)
    return out


def gap(candidate: torch.Tensor, ref: torch.Tensor, scale: float) -> float:
    """The widest elementwise gap, over ``scale`` (the reference's max)."""
    return float((candidate.double() - ref.double()).abs().max()) / max(scale, 1e-300)


def batch_order(idx, batch_size, shuffle: bool, rng):
    """Fixed-size batches of ``idx``: shuffled by ``rng.permutation`` when
    asked, the tail padded by wrapping, the padding weighted 0; yields
    ``(rows, weights)``; one batch of all rows when ``batch_size`` is None
    or covers them."""
    idx = np.asarray(idx)
    n = idx.shape[0]
    if batch_size is None or batch_size >= n:
        yield idx, np.ones(n, np.float32)
        return
    order = rng.permutation(n) if shuffle else np.arange(n)
    for s in range(0, n, batch_size):
        chunk = order[s:s + batch_size]
        pad = batch_size - chunk.shape[0]
        w = np.ones(batch_size, np.float32)
        if pad:
            chunk = np.concatenate([chunk, order[:pad]])
            w[batch_size - pad:] = 0.0
        yield idx[chunk], w


def weighted_ce(logits, labels, w):
    ce = torch.logsumexp(logits, dim=1) - logits.gather(1, labels[:, None])[:, 0]
    return (ce * w).sum() / w.sum().clamp(min=1.0)


def dropout(x, rate: float, gen):
    """Inverted dropout from uint8 bits drawn from ``gen`` on ``x``'s
    device: keep where the bits are below the quantized keep probability."""
    if rate == 0.0:
        return x
    keep_q = min(max(int(round((1.0 - rate) * 256.0)), 1), 255)
    bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, device=x.device, generator=gen)
    return torch.where(bits < keep_q, x * (256.0 / keep_q), torch.zeros((), dtype=x.dtype, device=x.device))


def lecun_normal_(w, gen):
    """Flax's ``lecun_normal``: a normal cut at two standard deviations,
    rescaled to variance ``1/fan_in``."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def xavier_relu_uniform_(w, gen):
    """``variance_scaling(2, fan_avg, uniform)``."""
    out_f, in_f = w.shape
    limit = math.sqrt(3.0 * 2.0 / ((in_f + out_f) / 2.0))
    return torch.nn.init.uniform_(w, -limit, limit, generator=gen)


def train_steps(model, params: dict, feats, labels, batches, drop_gen, lr: float, wd: float,
                prec: str, steps: int, half_batch: bool = False) -> dict:
    """``steps`` train steps of ``model`` (a ``ModelRef``) from ``params``
    on the batches' rows of ``feats``: the loss of each step, the first
    gradient as Adam receives it (L2 term included) and the parameters
    after each step.  ``half_batch`` is the planted fault that takes the
    mean over the first half of each batch only."""
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grad, after = [], {}, []
    for t, (rows, w) in zip(range(1, steps + 1), batches):
        rows_t = torch.as_tensor(rows, device=labels.device)
        w_t = torch.as_tensor(w, dtype=feats.dtype, device=labels.device)
        if half_batch:
            w_t = torch.where(torch.arange(w_t.shape[0], device=w_t.device) < w_t.shape[0] // 2, w_t, 0.0)
        logits = model.forward(p, model.rows(feats, rows_t), True, drop_gen, prec)
        loss = weighted_ce(logits, labels[rows_t], w_t)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for (k, q), g in zip(p.items(), grads):
                g = g + wd * q
                if t == 1:
                    first_grad[k] = g.clone()
                m[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
                v2[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                denom = (v2[k].sqrt() / math.sqrt(1 - BETA2 ** t)).add_(EPS)
                q.addcdiv_(m[k], denom, value=-lr / (1 - BETA1 ** t))
        after.append({k: q.detach().clone() for k, q in p.items()})
    return dict(losses=losses, first_grad=first_grad, params_after=after)


class ModelRef:
    """A configuration's reference module (``configs/<name>.py``) bound to
    its sizes: ``init(gen)``, ``forward(params, feats, train, gen, prec)``,
    ``rows(feats, idx)``, ``cached(hop_list)``, ``flops_per_row()``, and
    the hooks the module may define in place of the benchmark's defaults
    (:meth:`hook`): ``make_inputs(cfg, seed, device)``,
    ``reference_features(cfg, inputs, device, prec)`` (then ``cached`` is
    not needed) and ``sample_rows(cfg, inputs, seed)``."""

    HOOKS = ("make_inputs", "reference_features", "sample_rows")

    def __init__(self, module, cfg: dict):
        self.module, self.cfg = module, cfg

    def hook(self, name: str):
        """The module's ``name`` bound to the configuration, or None where
        the module leaves it to the default."""
        assert name in self.HOOKS, name
        fn = getattr(self.module, name, None)
        return None if fn is None else (lambda *args: fn(self.cfg, *args))

    def init(self, gen) -> dict:
        return self.module.init(self.cfg, gen)

    def forward(self, params, feats, train: bool, gen, prec: str):
        return self.module.forward(self.cfg, params, feats, train, gen, prec)

    def rows(self, feats, idx):
        return self.module.rows(feats, idx)

    def cached(self, hop_list):
        return self.module.cached(hop_list)

    def flops_per_row(self) -> int:
        return self.module.forward_flops_per_row(self.cfg)


@torch.no_grad()
def eval_counts(model, params: dict, feats, labels, idx_lists, batch_size, prec: str) -> list:
    """``(correct, rows)`` of each eval batch over ``idx_lists`` in order,
    as the program's eval loop cuts them (no shuffle, tail wrapped)."""
    out = []
    for idx in idx_lists:
        for rows, w in batch_order(idx, batch_size, False, None):
            rows_t = torch.as_tensor(rows, device=labels.device)
            w_t = torch.as_tensor(w, dtype=torch.float64, device=labels.device)
            logits = model.forward(params, model.rows(feats, rows_t), False, None, prec)
            hit = (logits.argmax(dim=1) == labels[rows_t]).double()
            out.append((float((hit * w_t).sum()), float(w_t.sum())))
    return out


def leaf_gaps(cand: dict, ref: dict, skip=()) -> dict:
    """Each leaf's gap between the candidate's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's
    (some gradients are all but zero); leaves in ``skip`` left out."""
    names = [k for k in ref if k not in skip]
    norms = {k: float(ref[k].double().norm()) for k in names}
    median = float(np.median(list(norms.values())))
    return {k: abs(float(cand[k].double().norm()) - norms[k]) / max(norms[k], median, 1e-300) for k in names}
