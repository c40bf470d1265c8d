"""NAGphormer in the port (``sgl_tpu_torch.models.NAGphormer``) against the
plain reference ``references/nagphormer.py``, on the CPU at a small size
with seeded weights: the hop-major stack, the init, the eval logits, a
training forward with the same dropout bits, the loss and every
parameter's gradient, three Adam steps through ``NodeClassification``'s
step factories; the benchmark's copy of the reference against the repo's;
the chunked postprocess (GAMLP and NAGphormer), the label tasks' forwards
over every node in eval batches, and the hop-token spans and counter.

Tolerances.  The port computes in float32 and the reference in float64
from the same float32 draws, so each gap is float32 rounding carried
through two encoder layers of width 32 and a softmax: they read 1e-7 to
4e-7 of the largest magnitude.  ``TOL`` = 2e-6 leaves five times that, and
lies a hundred times and more under what TF32 products (10-bit operands)
or bfloat16 give, which :func:`test_the_tolerance_fails_tf32_and_bf16`
shows."""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

from sgl_tpu_torch.datasets.synthetic import PlantedPartition
from sgl_tpu_torch.models import GAMLP, NAGphormer
from sgl_tpu_torch.ops import HopTokenMessageOp
from sgl_tpu_torch.tasks import NodeClassification, NodeClassificationWithCorrectAndSmooth, NodeClassificationWithLabelUse
from sgl_tpu_torch.tasks import node_classification as nc
from sgl_tpu_torch.tasks.utils import adam_l2, make_train_step, weighted_cross_entropy
from sgl_tpu_torch.utils import clear_spans, recording, spans

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 2e-6
ARGS = dict(prop_steps=3, feat_dim=16, output_dim=4, hidden_dim=32, num_heads=4, num_layers=2, dropout=0.1,
            attn_dropout=0.1)
LR, WD = 1e-3, 1e-5


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


R = _load(ROOT / "references" / "nagphormer.py", "nagphormer_reference")


@pytest.fixture(scope="module")
def ds():
    d = PlantedPartition(num_nodes=300, feat_dim=16, p_in=0.08, seed=3)
    assert d.num_classes == ARGS["output_dim"]
    return d


@pytest.fixture(scope="module")
def stack64(ds):
    src, dst, _ = ds.graph.edges()
    return R.hop_stack(src, dst, ds.graph.num_nodes, ds.x, ARGS["prop_steps"])


@pytest.fixture(scope="module")
def model(ds):
    m = NAGphormer(**ARGS)
    m.preprocess(ds.graph, ds.x, device="cpu")
    return m


def _net(model, seed=5):
    model.init(torch.Generator().manual_seed(seed))
    return model.net


def _params64(seed=5):
    return {k: v.double() for k, v in R.init(ARGS, torch.Generator().manual_seed(seed)).items()}


def _gap(got, want) -> float:
    return float((got.detach().double() - want.detach()).abs().max()) / float(want.detach().abs().max())


def test_the_stack_is_hop_major_and_matches_the_reference(model, stack64, ds):
    assert model.pre_msg_learnable and not model.node_major
    feats = model.processed_feature
    assert feats.shape == (ARGS["prop_steps"] + 1, ds.graph.num_nodes, ARGS["feat_dim"])
    assert feats.dtype == torch.float32
    # per hop, over the hop's largest: f32 SpMM sums, ~1e-7 read
    for k in range(feats.shape[0]):
        assert _gap(feats[k], stack64[k]) < TOL


def test_the_init_is_the_references_draw_under_its_names(model):
    got = dict(_net(model).named_parameters())
    want = R.init(ARGS, torch.Generator().manual_seed(5))
    assert list(got) == list(want)
    for k, v in want.items():
        assert torch.equal(got[k].detach(), v), k
    assert "scaling" not in " ".join(got)


def test_eval_logits_match_the_reference(model, stack64):
    idx = torch.arange(0, 300, 2)
    got = _net(model)(model.batch_input(idx))
    assert _gap(got, R.forward(ARGS, _params64(), stack64[:, idx])) < TOL


def test_a_training_forward_draws_the_references_dropout_bits(model, stack64):
    idx = torch.arange(1, 300, 3)
    net = _net(model)
    got = net(model.batch_input(idx), train=True, generator=torch.Generator().manual_seed(11))
    want = R.forward(ARGS, _params64(), stack64[:, idx], True, torch.Generator().manual_seed(11))
    assert _gap(got, want) < TOL
    # the bits matter: another draw moves the logits far beyond the tolerance
    other = R.forward(ARGS, _params64(), stack64[:, idx], True, torch.Generator().manual_seed(12))
    assert _gap(got, other) > 100 * TOL


def _leaf_scale(grads: dict) -> dict:
    """Each leaf's largest magnitude, at least the median leaf's: some
    gradients are all but zero (the key bias's and the readout bias's, to
    which the softmaxes are blind)."""
    tops = {k: float(g.abs().max()) for k, g in grads.items()}
    median = float(np.median(list(tops.values())))
    return {k: max(t, median) for k, t in tops.items()}


def test_the_loss_and_every_gradient_match_the_reference(model, stack64, ds):
    idx = torch.arange(0, 300, 4)
    labels = torch.as_tensor(ds.y)[idx]
    w = torch.ones(len(idx))
    w[-5:] = 0.0  # wrapped padding rows weigh nothing
    net = _net(model)
    loss = weighted_cross_entropy(net(model.batch_input(idx), train=True, generator=torch.Generator().manual_seed(3)),
                                  labels, w)
    grads = dict(zip([n for n, _ in net.named_parameters()], torch.autograd.grad(loss, list(net.parameters()))))
    p = {k: v.requires_grad_(True) for k, v in _params64().items()}
    want_loss = R.loss(R.forward(ARGS, p, stack64[:, idx], True, torch.Generator().manual_seed(3)), labels,
                       w.double())
    want = dict(zip(p, torch.autograd.grad(want_loss, list(p.values()))))
    assert abs(float(loss.detach()) - float(want_loss.detach())) / abs(float(want_loss.detach())) < TOL
    scale = _leaf_scale(want)
    assert set(grads) == set(want)
    for k, g in want.items():
        assert float((grads[k].double() - g).abs().max()) / scale[k] < TOL, k


def test_three_adam_steps_through_the_task_step_factories(model, stack64, ds):
    net = _net(model)
    step = make_train_step(net, adam_l2(net.parameters(), LR, WD), weighted_cross_entropy)
    gen = torch.Generator().manual_seed(21)
    p = _params64()
    p0 = {k: v.clone() for k, v in p.items()}
    ref_gen, state = torch.Generator().manual_seed(21), {}
    labels = torch.as_tensor(ds.y)
    rng = np.random.default_rng(4)
    for _ in range(3):
        idx = torch.as_tensor(rng.choice(300, 64, replace=False))
        w = torch.ones(64)
        loss, _ = step(model.batch_input(idx), labels[idx], w, gen)
        q = {k: v.requires_grad_(True) for k, v in p.items()}
        want = R.loss(R.forward(ARGS, q, stack64[:, idx], True, ref_gen), labels[idx], w.double())
        grads = dict(zip(q, torch.autograd.grad(want, list(q.values()))))
        p = {k: v.detach() for k, v in q.items()}
        R.adam_l2_step(p, grads, state, LR, WD)
        assert abs(float(loss) - float(want.detach())) / abs(float(want.detach())) < TOL
    # the change over three steps, leaf by leaf: the norm of its gap over
    # the norm of the reference's.  Adam divides each element's gradient by
    # its own size, so an element whose gradient is a thousandth of its
    # leaf's carries a thousand times the leaf's rounding: the gaps read
    # 1e-7 to 1.2e-4 (the readout weight, the LayerNorm scales), 1e-3 leaves
    # eight times the most.  The key third of the q/k/v bias and the readout
    # bias are left out: their gradient is zero but for rounding, which
    # Adam's normalization turns into steps of either sign
    h = ARGS["hidden_dim"]
    got = dict(net.named_parameters())
    for k in p:
        change, want_change = got[k].detach().double() - p0[k], p[k] - p0[k]
        if k.endswith("attn.qkv.bias"):
            keep = torch.ones(3 * h, dtype=torch.bool)
            keep[h:2 * h] = False
            change, want_change = change[keep], want_change[keep]
        elif k == "msg_op.readout.bias":
            continue
        assert float((change - want_change).norm()) / float(want_change.norm()) < 1e-3, k


@pytest.fixture(scope="module")
def bench_ref():
    """The benchmark's copy of the reference, which imports the harness's
    ``reference`` module from beside it."""
    bench = str(ROOT / "benchmark")
    sys.path.insert(0, bench)
    try:
        return _load(ROOT / "benchmark" / "configs" / "nagphormer_products.py", "nagphormer_bench_reference")
    finally:
        sys.path.remove(bench)


def test_the_benchmark_copy_gives_the_references_outputs(stack64, bench_ref):
    B = bench_ref
    cfg = {"model_args": ARGS}
    p = {k: v.double() for k, v in B.init(cfg, torch.Generator().manual_seed(5)).items()}
    want = _params64()
    assert list(p) == list(want) and all(torch.equal(p[k], want[k]) for k in want)
    idx = torch.arange(0, 300, 5)
    feats = B.rows(B.cached(list(stack64)), idx)
    assert torch.equal(feats, stack64[:, idx])
    for train in (False, True):
        got = B.forward(cfg, p, feats, train, torch.Generator().manual_seed(8), "f64")
        ref = R.forward(ARGS, want, stack64[:, idx], train, torch.Generator().manual_seed(8))
        assert _gap(got, ref) < 1e-12  # the same float64 operations, up to their order
    assert B.forward_flops_per_row(cfg) == R.flops_per_row(ARGS)


def test_the_tolerance_fails_tf32_and_bf16(model, stack64, bench_ref):
    """The tolerance is tight enough that computing in TF32 (the
    benchmark's control: every product's operands rounded to TF32) or in
    bfloat16 fails it."""
    idx = torch.arange(0, 300, 2)
    want = R.forward(ARGS, _params64(), stack64[:, idx])
    p32 = {k: v.float() for k, v in _params64().items()}
    tf32 = bench_ref.forward({"model_args": ARGS}, p32, stack64[:, idx].float(), False, None, "tf32")
    net = _net(model)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        bf16 = net(model.batch_input(idx))
    # they read 5.7e-4 and 5.1e-3
    assert _gap(tf32, want) > 100 * TOL and _gap(bf16.float(), want) > 100 * TOL


@pytest.mark.parametrize("make", [
    lambda ds: GAMLP(prop_steps=3, feat_dim=ds.num_features, output_dim=ds.num_classes, hidden_dim=16, num_layers=2),
    lambda ds: NAGphormer(prop_steps=3, feat_dim=ds.num_features, output_dim=ds.num_classes, hidden_dim=16,
                          num_heads=2),
], ids=["GAMLP", "NAGphormer"])
def test_the_postprocess_runs_in_eval_batches_inside_one_logits_call(ds, make, monkeypatch):
    calls = []
    make_logits = nc.make_logits_fn

    def recorded(net, *args, **kwargs):
        fn = make_logits(net, *args, **kwargs)

        def logits(feats):
            out = fn(feats)
            calls.append((net, out))
            return out
        return logits

    monkeypatch.setattr(nc, "make_logits_fn", recorded)
    model = make(ds)
    NodeClassification(ds, model, lr=0.01, weight_decay=5e-5, epochs=1, device="cpu", seed=7, train_batch_size=32,
                       eval_batch_size=70, verbose=False)
    (net, out), = calls
    assert out.shape == (ds.num_node, ds.num_classes)
    whole = net(model.batch_input(torch.arange(ds.num_node)), train=False)
    # row-wise: each piece's rows are the single forward's, up to the
    # blocking of products over another row count
    torch.testing.assert_close(out, whole, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("task", ["correct_and_smooth", "label_use"])
def test_the_label_tasks_run_every_node_in_eval_batches(ds, task, monkeypatch):
    rows = []
    forward = HopTokenMessageOp.forward

    def recorded(self, hops, train=False, generator=None):
        if not train:
            rows.append(hops.shape[1])
        return forward(self, hops, train, generator)

    monkeypatch.setattr(HopTokenMessageOp, "forward", recorded)
    job = dict(lr=0.01, weight_decay=5e-5, epochs=2, device="cpu", seed=7, train_batch_size=32, eval_batch_size=70,
               verbose=False)
    args = dict(prop_steps=3, output_dim=ds.num_classes, hidden_dim=16, num_heads=2)
    if task == "correct_and_smooth":
        NodeClassificationWithCorrectAndSmooth(ds, NAGphormer(feat_dim=ds.num_features, **args), num_correct_layers=2,
                                               correct_alpha=0.8, num_smooth_layers=2, smooth_alpha=0.8, **job)
    else:
        NodeClassificationWithLabelUse(ds, NAGphormer(feat_dim=ds.num_features + ds.num_classes, **args),
                                       label_iters=1, reuse_start_epoch=0, **job)
    # the val and test batches, then at least one pass over every node
    # (the best epoch's forward, or label reuse and the postprocess), each
    # in pieces of at most the eval batch
    assert max(rows) == 70
    assert sum(rows) >= ds.num_node + len(ds.val_idx) + len(ds.test_idx)


def test_the_hop_token_spans_and_counter_are_kept_only_while_recording(ds):
    clear_spans()
    args = dict(ARGS, output_dim=ds.num_classes)
    job = dict(lr=0.01, weight_decay=5e-5, epochs=1, device="cpu", seed=7, train_batch_size=32, eval_batch_size=50,
               verbose=False)
    NodeClassification(ds, NAGphormer(**args), **job)
    assert spans() == []
    try:
        with recording():
            NodeClassification(ds, NAGphormer(**args), **job)
        recs = spans()
    finally:
        clear_spans()
    by_id = {r["id"]: r for r in recs}
    k1, layers = args["prop_steps"] + 1, args["num_layers"]
    # 3 train batches of 32 (90 rows), eval 2 + 3 batches of 50, the
    # postprocess forward over all 300 rows in pieces of 50
    forwards = {"sgl.task.train": (3, 32), "sgl.task.eval": (5, 50), "sgl.task.postprocess": (6, 50)}
    for parent, (n, rows) in forwards.items():
        (p,) = [r for r in recs if r["name"] == parent]
        kind = "train" if parent == "sgl.task.train" else "eval"
        assert p["counts"]["sgl.hop_tokens"] == p["counts"][f"sgl.hop_tokens[kind={kind}]"] == n * rows * k1
        kids = [r for r in recs if r["parent"] == p["id"] and r["name"].startswith("sgl.hop_token.")]
        names = [r["name"] for r in kids]
        assert names.count("sgl.hop_token.attention") == names.count("sgl.hop_token.ffn") == n * layers
        assert names.count("sgl.hop_token.readout") == n
    for r in recs:
        if r["name"].startswith("sgl.hop_token."):
            assert by_id[r["parent"]]["name"] in forwards and r["stream_ms"] is None  # no CUDA in use
            assert r["counts"] == {}
    assert sum(r["counts"].get("sgl.hop_tokens", 0) for r in recs) == (3 * 32 + 5 * 50 + 300) * k1
