"""What decides ``correct``: the numbers that compare a candidate's outputs
with the plain reference (``reference.py``); those that
``limits/<workload>.json`` gives a limit are compared, the rest are
readings.

A candidate is what a run produced, as :func:`judge` reads it:

* ``full``: the cached features of the last unit of work, whole;
* ``samples``: the rows ``sample_idx`` of the cached features of every
  unit (calls or jobs) of the window, in order;
* ``train`` (train cells): the first recorded job's ``seed``, the
  ``losses`` of its first three steps, its ``first_grad`` (Adam's first
  gradient, L2 term included), its parameters at the start
  (``params0``), after three steps (``params3``) and at the first eval
  (``params_eval``), the ``eval_counts`` ``(correct, rows)`` of each
  batch of that eval, and the ``logits_rows`` of ``sample_idx`` of its
  last forward over every node with the ``logits_params`` it ran with.

The numbers:

* ``hop_err``: the widest gap of the cached features (every row of the
  last unit, the sampled rows of every unit) from the float64 reference,
  over the reference's largest magnitude: of the whole matrix, or of each
  ``(N, D)`` block of a stack, rows on its second-to-last axis (per hop of
  a ``(K+1, N, D)`` hop stack, per hop and subset of a ``(K+1, S, N, D)``
  one);
* ``init_gap``: the start against the reference's draw (exact, limit 0);
* ``loss1_gap`` / ``loss_gap``: the gap of the first step's loss / the
  widest of the three steps', over the larger of the step's reference
  loss and the first step's;
* ``grad_gap``: the worst leaf's gap of the first gradient's norm, over
  the larger of that leaf's reference norm and the median leaf's;
* ``change_gap`` / ``change_median_gap``: the worst / the median leaf's
  gap of the norm of the parameters' change over three steps, measured
  alike, leaving out leaves whose reference gradient norm is under a
  thousandth of the median leaf's;
* ``eval_gap``: the widest gap of an eval batch's correct count, over its
  rows, with the reference's forward run from ``params_eval``;
* ``logits_gap``: the widest gap of the sampled rows' logits of the job's
  last forward over every node (``logits_rows``), over the reference's
  largest, with the reference's forward run from the parameters that
  forward ran with (``logits_params``); none where the task runs no such
  forward (``HeteroNodeClassification``), so a limit on it fails there.
The eval forward is the one stage the reference follows from the
program's state (``PERF.md``).

The rows compared and the reference's cached features are the
configuration's hooks where its reference module defines them
(``sample_rows``, ``reference_features``; ``reference.ModelRef.hook``),
else the defaults here; the judge and ``control.py`` both reach them
through :func:`sample_rows` and :func:`candidate_features`.
"""

from __future__ import annotations

import itertools
import math
import sys

import numpy as np
import torch

import reference as ref

RECORDED_STEPS = 3


def sample_rows(model, inputs, seed: int) -> np.ndarray:
    """The rows compared in every unit: the configuration's own, or
    :func:`hub_and_uniform_rows` of one graph."""
    hook = model.hook("sample_rows")
    return hook(inputs, seed) if hook else hub_and_uniform_rows(inputs, seed)


def hub_and_uniform_rows(inputs, seed: int, count: int = 4096, hubs: int = 64) -> np.ndarray:
    """The ``hubs`` rows of most nonzeros (their products are cut into
    segments) and uniform draws from the seed, sorted."""
    deg = np.bincount(inputs.dst, minlength=inputs.num_nodes)
    top = np.argsort(deg, kind="stable")[-hubs:]
    rest = np.setdiff1d(np.arange(inputs.num_nodes), top)
    rng = np.random.default_rng([seed, 7])
    draw = rng.choice(rest, size=min(count - hubs, rest.shape[0]), replace=False)
    return np.sort(np.concatenate([top, draw]))


def candidate_features(model, inputs, device, prec: str):
    """The cached features as the reference computes them in ``prec``: the
    configuration's own, or the hops of one normalized adjacency."""
    hook = model.hook("reference_features")
    if hook:
        return hook(inputs, device, prec)
    adj = ref.normalized_adjacency(inputs, device, prec)
    hop_list = ref.hops(adj, inputs.x, model.cfg["model_args"]["prop_steps"], prec)
    del adj
    return model.cached(hop_list)


def _feature_gap(cand, want) -> float:
    """Per ``(N, D)`` block for a stack, else over the whole matrix."""
    if want.dim() >= 3:
        cand, want = (t.reshape(-1, *t.shape[-2:]) for t in (cand, want))
        return max(ref.gap(cand[k], want[k], float(want[k].abs().max())) for k in range(want.shape[0]))
    return ref.gap(cand, want, float(want.abs().max()))


def _scaled_rows(model, want, idx):
    """The reference's rows ``idx`` and, per ``(N, D)`` block, its largest
    magnitude."""
    scale = want.abs().amax(dim=(-2, -1), keepdim=True) if want.dim() >= 3 else want.abs().max()
    return model.rows(want, idx), scale


def steps_per_epoch(cfg: dict, inputs) -> int:
    n, bs = len(inputs.train_idx), cfg["train_batch_size"]
    return 1 if bs is None or bs >= n else -(-n // bs)


def reference_run(model, cfg: dict, inputs, feats, job_seed: int, prec: str, device, sample_idx,
                  half_batch: bool = False) -> dict:
    """The reference's (or a control's) first job as far as the program's
    record goes: init from ``job_seed``, the first epoch's batches, the
    steps to its first eval, that eval's counts, and the logits of the
    ``sample_idx`` rows with the parameters of that eval."""
    params = {k: v.to(device, ref.dtype_of(prec)) for k, v in
              model.init(torch.Generator().manual_seed(job_seed)).items()}
    labels = torch.as_tensor(inputs.y, device=device)
    spe = steps_per_epoch(cfg, inputs)
    rng = np.random.default_rng(job_seed)
    batches = (b for _ in itertools.count() for b in ref.batch_order(inputs.train_idx, cfg["train_batch_size"],
                                                                       True, rng))
    drop_gen = torch.Generator(device).manual_seed(job_seed)
    out = ref.train_steps(model, params, feats, labels, batches, drop_gen, cfg["lr"], cfg["weight_decay"],
                          prec, max(RECORDED_STEPS, spe), half_batch=half_batch)
    p_eval = out["params_after"][spe - 1]
    return dict(seed=job_seed, losses=out["losses"][:RECORDED_STEPS], first_grad=out["first_grad"],
                params0=params, params3=out["params_after"][RECORDED_STEPS - 1], params_eval=p_eval,
                eval_counts=ref.eval_counts(model, p_eval, feats, labels, [inputs.val_idx, inputs.test_idx],
                                            cfg["eval_batch_size"], prec),
                logits_params=p_eval, logits_rows=_logits(model, p_eval, feats, sample_idx, prec))


@torch.no_grad()
def _logits(model, params: dict, feats, sample_idx, prec: str):
    idx = torch.as_tensor(sample_idx, device=feats.device)
    return model.forward(params, model.rows(feats, idx), False, None, prec)


def judge(cand: dict, model, cfg: dict, inputs, sample_idx, device) -> tuple:
    """The numbers of ``cand`` against the float64 reference, and the
    ``hop_err`` of each unit's sampled rows."""
    want = candidate_features(model, inputs, device, "f64")
    want_rows, scale = _scaled_rows(model, want, torch.as_tensor(sample_idx, device=device))
    unit_errs = [float(((rows.to(device).double() - want_rows).abs() / scale).max()) for rows in cand["samples"]]
    numbers = {"hop_err": max([_feature_gap(cand["full"].to(device), want)] + unit_errs)}
    if cand.get("train") is not None:
        numbers.update(_train_numbers(cand["train"], model, cfg, inputs, want, device, sample_idx))
    return numbers, unit_errs


TRAIN_NUMBERS = ("init_gap", "loss1_gap", "loss_gap", "grad_gap", "change_gap", "change_median_gap", "eval_gap",
                 "logits_gap")


def _train_numbers(got: dict, model, cfg: dict, inputs, want, device, sample_idx) -> dict:
    r = reference_run(model, cfg, inputs, want, got["seed"], "f64", device, sample_idx)
    if set(got.get("params0", {})) != set(r["params0"]) or len(got["losses"]) < RECORDED_STEPS:
        return dict.fromkeys(TRAIN_NUMBERS, math.inf)
    numbers = {"init_gap": max(float((got["params0"][k].double().to(device) - v).abs().max())
                               for k, v in r["params0"].items())}
    # each step's gap over the larger of its reference loss and the first
    # step's: a loss that saturates towards 0 (SGC on Reddit's separable
    # rows) keeps no relative digits in f32
    first = abs(r["losses"][0])
    steps = [abs(a - b) / max(abs(b), first) for a, b in zip(got["losses"], r["losses"])]
    numbers["loss1_gap"], numbers["loss_gap"] = steps[0], max(steps)
    grads = ref.leaf_gaps({k: v.to(device) for k, v in got["first_grad"].items()}, r["first_grad"])
    numbers["grad_gap"] = max(grads.values())
    gnorm = {k: float(g.norm()) for k, g in r["first_grad"].items()}
    median = float(np.median(list(gnorm.values())))
    skip = {k for k, g in gnorm.items() if g < 1e-3 * median}
    got_change = {k: got["params3"][k].to(device).double() - got["params0"][k].to(device).double()
                  for k in r["params0"]}
    changes = ref.leaf_gaps(got_change, {k: r["params3"][k] - r["params0"][k] for k in r["params0"]}, skip)
    numbers["change_gap"] = max(changes.values())
    numbers["change_median_gap"] = float(np.median(list(changes.values())))
    flips = {k: int((torch.sign(got["first_grad"][k].to(device).double()) != torch.sign(g)).sum())
             for k, g in r["first_grad"].items()}
    print(f"losses: program {got['losses']} reference {r['losses']}; step gaps {steps}", file=sys.stderr)
    print(f"first gradient, gap by leaf {grads}; sign flips by leaf {flips}", file=sys.stderr)
    print(f"change over {RECORDED_STEPS} steps, gap by leaf {changes}; left out {sorted(skip)}", file=sys.stderr)
    eval_ref = ref.eval_counts(model, {k: v.to(device).double() for k, v in got["params_eval"].items()}, want,
                               torch.as_tensor(inputs.y, device=device), [inputs.val_idx, inputs.test_idx],
                               cfg["eval_batch_size"], "f64")
    if len(eval_ref) != len(got["eval_counts"]):
        numbers["eval_gap"] = math.inf
    else:
        numbers["eval_gap"] = max(abs(a[0] - b[0]) / b[1] for a, b in zip(got["eval_counts"], eval_ref))
    if "logits_rows" in got:
        want_logits = _logits(model, {k: v.to(device).double() for k, v in got["logits_params"].items()}, want,
                              sample_idx, "f64")
        numbers["logits_gap"] = ref.gap(got["logits_rows"].to(device), want_logits, float(want_logits.abs().max()))
    return numbers


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: each number that has a limit, beside it; a
    limit without its number fails.  The other numbers are readings."""
    checks = {k: {"value": _finite(numbers.get(k, math.nan)), "limit": lim} for k, lim in sorted(limits.items())}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def _finite(v: float) -> float:
    """A number that JSON can carry: a missing or infinite reading becomes
    the largest float, which fails any limit."""
    return v if math.isfinite(v) else sys.float_info.max
