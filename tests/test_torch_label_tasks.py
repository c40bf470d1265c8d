"""The port's label tasks against ``sgl_tpu``'s on the CPU: the label-use
features and the warmup schedule, Correct & Smooth's post-processing on a
given ``y_soft``, one label-reuse iteration for the same carried
parameters, both tasks end to end above the accuracy bars of
``tests/test_tasks.py``, and the ``Predictor``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sgl_tpu.datasets.synthetic as jsyn
from sgl_tpu.models.homo import SGC as JSGC
from sgl_tpu.tasks.correct_and_smooth import (
    NodeClassificationWithCorrectAndSmooth as JNodeClassificationWithCorrectAndSmooth,
)
from sgl_tpu.tasks.inference import Predictor as JPredictor
from sgl_tpu.tasks.inference import _bucket as j_bucket
from sgl_tpu.tasks.utils import add_labels as j_add_labels
from sgl_tpu.tasks.utils import adam_l2_warmup as j_adam_l2_warmup
from sgl_tpu.tasks.utils import bce_loss as j_bce_loss
from sgl_tpu.tasks.utils import cross_entropy_loss as j_cross_entropy_loss
from sgl_tpu.tasks.utils import warmup_lr_schedule as j_warmup_lr_schedule
from sgl_tpu.tricks import CorrectAndSmooth as JCorrectAndSmooth
from sgl_tpu_torch import convert
from sgl_tpu_torch.datasets import PlantedPartition
from sgl_tpu_torch.models import SGC
from sgl_tpu_torch.tasks import (
    NodeClassification,
    NodeClassification_With_CorrectAndSmooth,
    NodeClassificationWithCorrectAndSmooth,
    NodeClassificationWithLabelUse,
    Predictor,
    predictor_from_task,
)
from sgl_tpu_torch.tasks.inference import _bucket
from sgl_tpu_torch.tasks.node_classification_with_label_use import reuse_labels
from sgl_tpu_torch.tasks.utils import (
    adam_l2_warmup,
    add_labels,
    bce_loss,
    cross_entropy_loss,
    warmup_factor,
    warmup_lr_schedule,
)
from sgl_tpu_torch.tricks import CorrectAndSmooth

CPU = torch.device("cpu")
RTOL = 1e-5
DS_ARGS = dict(num_nodes=300, feat_dim=16, p_in=0.08, seed=3)  # tests/test_tasks.py's DS


@pytest.fixture(scope="module")
def datasets():
    return PlantedPartition(**DS_ARGS), jsyn.PlantedPartition(**DS_ARGS)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def _bare(cls, **attrs):
    """An instance of a task class without running its constructor (which
    trains), to call one of its steps."""
    obj = cls.__new__(cls)
    obj.__dict__.update(attrs)
    return obj


def test_add_labels_matches_sgl_tpu(datasets):
    ds, _ = datasets
    idx = np.asarray(ds.train_idx)[::2]
    want = j_add_labels(ds.x, ds.y, idx, ds.num_classes)
    got = add_labels(ds.x, ds.y, idx, ds.num_classes)
    assert got.shape == (ds.num_node, ds.num_features + ds.num_classes) and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_losses_match_sgl_tpu():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(50, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 50)
    prob = rng.random((50, 4)).astype(np.float32)
    target = (rng.random((50, 4)) < 0.5).astype(np.float32)
    np.testing.assert_allclose(float(cross_entropy_loss(torch.as_tensor(logits), torch.as_tensor(labels))),
                               float(j_cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))), rtol=RTOL)
    np.testing.assert_allclose(float(bce_loss(torch.as_tensor(prob), torch.as_tensor(target))),
                               float(j_bce_loss(jnp.asarray(prob), jnp.asarray(target))), rtol=RTOL)


@pytest.mark.parametrize("warmup", [1, 10, 50])
def test_warmup_schedule_matches_sgl_tpu(warmup):
    lr = 0.05
    schedule = j_warmup_lr_schedule(lr, warmup)
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=lr)
    sched = warmup_lr_schedule(opt, warmup)
    for step in range(warmup + 5):
        assert warmup_factor(step, warmup) == min((step + 1) / warmup, 1.0)
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(schedule(step)), rtol=1e-6)
        opt.step()
        sched.step()


def test_adam_l2_warmup_matches_optax():
    """Twenty steps on a least-squares problem with a warmup of eight: the
    same parameters step for step, the L2 term before the moments."""
    rng = np.random.default_rng(3)
    w0 = rng.normal(size=(6, 4)).astype(np.float32)
    xs = rng.normal(size=(20, 20, 6)).astype(np.float32)
    ys = rng.normal(size=(20, 20, 4)).astype(np.float32)
    lr, wd, warmup = 0.05, 1e-2, 8

    wt = torch.nn.Parameter(torch.tensor(w0.copy()))
    opt, sched = adam_l2_warmup([wt], lr, wd, warmup)
    for x, y in zip(xs, ys):
        opt.zero_grad()
        ((torch.tensor(x) @ wt - torch.tensor(y)) ** 2).mean().backward()
        opt.step()
        sched.step()

    tx = j_adam_l2_warmup(lr, wd, warmup)
    params = jnp.asarray(w0.copy())
    state = tx.init(params)
    for x, y in zip(xs, ys):
        grads = jax.grad(lambda w: jnp.mean((jnp.asarray(x) @ w - jnp.asarray(y)) ** 2))(params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    # the bar of tests/test_reference_parity.py::test_adam_l2_matches_torch_adam:
    # the two Adams round the moments' square root and quotient differently,
    # which twenty steps carry into the parameters
    np.testing.assert_allclose(wt.detach().numpy(), np.asarray(params), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("autoscale", [True, False])
def test_correct_and_smooth_postprocess_on_a_given_y_soft(datasets, autoscale):
    """The task's post-processing (correct over ``correct_r``, smooth over
    ``smooth_r``, accuracies) on the same ``y_soft`` in both packages."""
    ds, jds = datasets
    rng = np.random.default_rng(8)
    y_soft = np.array(jax.nn.softmax(jnp.asarray(2 * rng.normal(size=(ds.num_node, ds.num_classes))), -1),
                      np.float32)
    labels = np.asarray(ds.y).reshape(-1)
    common = dict(_correct_r=0.3, _smooth_r=0.5, _verbose=False)
    jtask = _bare(JNodeClassificationWithCorrectAndSmooth, _dataset=jds, _best_y_soft=jnp.asarray(y_soft),
                  _cs=JCorrectAndSmooth(4, 0.8, 3, 0.7, autoscale, 1.2), **common)
    task = _bare(NodeClassificationWithCorrectAndSmooth, _dataset=ds, _best_y_soft=torch.as_tensor(y_soft),
                 _cs=CorrectAndSmooth(4, 0.8, 3, 0.7, autoscale, 1.2), _device=CPU, **common)
    want = jtask._postprocess(None, jnp.asarray(labels), jds.val_idx, jds.test_idx)
    got = task._postprocess(None, torch.as_tensor(labels), ds.val_idx, ds.test_idx)
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_label_reuse_features_match_sgl_tpu_for_the_same_params(datasets):
    """One label-reuse iteration: the soft predictions of the same carried
    parameters fill the label columns of the unlabeled rows, and the result
    is propagated again."""
    ds, jds = datasets
    c, d = ds.num_classes, ds.num_features
    labels = np.asarray(ds.y).reshape(-1)
    train_idx = np.asarray(ds.train_idx)
    mask = np.random.default_rng(0).random(train_idx.shape[0]) < 0.5
    features = add_labels(ds.x, labels, train_idx[mask], c)
    unlabeled = np.concatenate([train_idx[~mask], ds.val_idx, ds.test_idx])

    jm = JSGC(2, d + c, c)
    jm.preprocess(jds.graph, features.copy())
    params = jm.init(jax.random.PRNGKey(0))
    jfeat = features.copy()
    soft = np.asarray(jax.nn.softmax(jm.apply(params, jnp.arange(ds.num_node)), axis=-1))
    jfeat[unlabeled, -c:] = soft[unlabeled]
    jm.preprocess(jds.graph, jfeat)

    m = SGC(2, d + c, c)
    m.preprocess(ds.graph, features.copy(), device=CPU)
    convert.load_flax_params(m, _np_tree(params))
    feat = features.copy()
    reuse_labels(m, m.net, ds.graph, feat, unlabeled, c, CPU)
    np.testing.assert_allclose(feat, jfeat, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(m.processed_feature.numpy(), np.asarray(jm.processed_feature),
                               rtol=RTOL, atol=1e-6)


def test_correct_and_smooth_task_end_to_end(datasets):
    ds, _ = datasets
    assert NodeClassification_With_CorrectAndSmooth is NodeClassificationWithCorrectAndSmooth
    task = NodeClassificationWithCorrectAndSmooth(
        ds, SGC(2, ds.num_features, ds.num_classes), lr=0.1, weight_decay=5e-5, epochs=15,
        num_correct_layers=10, correct_alpha=0.8, num_smooth_layers=10, smooth_alpha=0.8,
        verbose=False, device="cpu",
    )
    assert task.test_acc > 0.85, task.test_acc
    assert task._best_y_soft.shape == (ds.num_node, ds.num_classes)


def test_label_use_and_reuse_end_to_end(datasets):
    ds, _ = datasets
    task = NodeClassificationWithLabelUse(
        ds, SGC(2, ds.num_features + ds.num_classes, ds.num_classes), lr=0.1, weight_decay=5e-5,
        epochs=12, mask_rate=0.5, use_labels=True, label_iters=1, reuse_start_epoch=5,
        verbose=False, device="cpu",
    )
    assert task.test_acc > 0.8, task.test_acc
    assert len(task.propagate_seconds) == 12
    with pytest.raises(ValueError):
        NodeClassificationWithLabelUse(ds, SGC(2, 4, 4), 0.1, 0.0, 1, use_labels=False, label_iters=1,
                                       device="cpu")


def test_bucket_matches_sgl_tpu():
    for n in [0, 1, 7, 8, 9, 100, 1000, 65535, 65536, 65537, 200_000]:
        assert _bucket(n) == j_bucket(n)


def test_predictor_matches_sgl_tpu_for_the_same_params(datasets):
    ds, jds = datasets
    d, c = ds.num_features, ds.num_classes
    jm = JSGC(2, d, c)
    jm.preprocess(jds.graph, jds.x)
    params = jm.init(jax.random.PRNGKey(1))
    m = SGC(2, d, c)
    m.preprocess(ds.graph, ds.x, device=CPU)
    convert.load_flax_params(m, _np_tree(params))
    pred, jpred = Predictor(m, m.net), JPredictor(jm, params)
    for n in (1, 3, 8, 13, 100, ds.num_node):
        ids = np.arange(ds.num_node)[::-1][:n]
        np.testing.assert_allclose(pred.predict(ids), jpred.predict(ids), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(pred.predict_proba([0, 5, 7]), jpred.predict_proba([0, 5, 7]), rtol=RTOL)


def test_predictor_save_load_round_trip(datasets, tmp_path):
    ds, _ = datasets
    task = NodeClassification(ds, SGC(2, ds.num_features, ds.num_classes), lr=0.1, weight_decay=5e-5,
                              epochs=10, verbose=False, device="cpu")
    pred = predictor_from_task(task)
    for n in (1, 3, 8, 13, 100):
        assert pred.predict(np.arange(n)).shape == (n, ds.num_classes)
    np.testing.assert_allclose(pred.predict_proba([0, 5, 7]).sum(1), 1.0, rtol=1e-5)
    logits = pred.predict(np.arange(ds.num_node))
    acc = (logits.argmax(1) == np.asarray(ds.y))[np.asarray(ds.test_idx)].mean()
    assert acc > 0.8
    path = str(tmp_path / "predictor.pt")
    pred.save(path)
    assert task._model.processed_feature is not None  # the task's model is left as it was
    loaded = Predictor.load(path, device="cpu")
    np.testing.assert_array_equal(loaded.predict(np.arange(ds.num_node)), logits)
    np.testing.assert_array_equal(loaded.predict([4, 2]), logits[[4, 2]])
    assert list(tmp_path.iterdir()) == [tmp_path / "predictor.pt"]  # no temporary file left
