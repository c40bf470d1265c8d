"""The port's node-classification task end to end on the CPU, against
``sgl_tpu`` on the same synthetic graph and split."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgl_tpu.datasets.synthetic as jsyn
import sgl_tpu.tasks.utils as jutils
import sgl_tpu_torch.tasks.utils as tutils
from sgl_tpu.models.homo import GAMLP as JGAMLP
from sgl_tpu.models.homo import SGC as JSGC
from sgl_tpu.tasks.node_classification import NodeClassification as JNodeClassification
from sgl_tpu.tasks.utils import batch_iterator as j_batch_iterator
from sgl_tpu_torch import resolve_device
from sgl_tpu_torch.datasets import PlantedPartition
from sgl_tpu_torch.models import GAMLP, SGC
from sgl_tpu_torch.tasks import NodeClassification
from sgl_tpu_torch.tasks.utils import batch_iterator
from sgl_tpu_torch.utils import TrainConfig

SEEDS = (42, 7)
EPOCHS = 60


@pytest.fixture(scope="module")
def datasets():
    return PlantedPartition(), jsyn.PlantedPartition()


MODELS = {
    "sgc": (lambda d, c: SGC(3, d, c), lambda d, c: JSGC(3, d, c)),
    "gamlp": (
        lambda d, c: GAMLP(3, d, c, hidden_dim=32, num_layers=2),
        lambda d, c: JGAMLP(3, d, c, hidden_dim=32, num_layers=2),
    ),
}


@pytest.mark.parametrize("kind", ["sgc", "gamlp"])
def test_node_classification_matches_reference(datasets, kind):
    """The bar of tests/test_training_parity.py: mean test accuracy over
    seeds within 0.02 of the reference (random streams differ per
    framework, so single seeds may not)."""
    ds, jds = datasets
    make, jmake = MODELS[kind]
    d, c = ds.num_features, ds.num_classes
    kw = dict(lr=0.1, weight_decay=5e-5, epochs=EPOCHS, verbose=False)
    got = [
        NodeClassification(ds, make(d, c), seed=s, device="cpu", **kw).test_acc for s in SEEDS
    ]
    want = [JNodeClassification(jds, jmake(d, c), seed=s, **kw).test_acc for s in SEEDS]
    assert min(got) >= 0.8, got
    assert abs(np.mean(got) - np.mean(want)) <= 0.02, (got, want)


def test_node_classification_minibatch_and_bf16_precompute(datasets):
    ds, _ = datasets
    task = NodeClassification(
        ds, SGC(3, ds.num_features, ds.num_classes), device="cpu", verbose=False,
        precompute_dtype=torch.bfloat16, config=TrainConfig(epochs=30, train_batch_size=64, eval_batch_size=100),
    )
    assert task.test_acc >= 0.8
    assert len(task.epoch_seconds) == 30 and task.preprocess_seconds > 0


def test_node_classification_defaults_to_cuda_and_raises_without_it(datasets):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    ds, _ = datasets
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NodeClassification(ds, SGC(3, ds.num_features, ds.num_classes), epochs=1, verbose=False)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        ds.to_device()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("metric", ["accuracy", "weighted_accuracy", "weighted_cross_entropy"])
def test_metrics_match(metric):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(40, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 40)
    w = (rng.random(40) < 0.8).astype(np.float32)
    args = (logits, labels) if metric == "accuracy" else (logits, labels, w)
    got = getattr(tutils, metric)(*(torch.as_tensor(a) for a in args))
    want = getattr(jutils, metric)(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("batch_size", [None, 7, 50])
def test_batch_iterator_matches(batch_size):
    idx = np.arange(100, 130)
    got = list(batch_iterator(idx, batch_size, True, np.random.default_rng(1)))
    want = list(j_batch_iterator(idx, batch_size, True, np.random.default_rng(1)))
    assert len(got) == len(want)
    for (a, wa), (b, wb) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(wa, wb)
