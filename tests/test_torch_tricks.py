"""The port's tricks against ``sgl_tpu``'s on the CPU: label propagation
(integer labels, soft labels, a mask), the Loge losses, and Correct & Smooth
(``correct`` with autoscale on and off, ``smooth``), on the same numpy
inputs.  The card's cases are in ``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_tpu.graph import symmetric_normalized_weights as j_sym
from sgl_tpu.tricks import CorrectAndSmooth as JCorrectAndSmooth
from sgl_tpu.tricks import label_propagation as j_label_propagation
from sgl_tpu.tricks import loge_bce_loss as j_loge_bce_loss
from sgl_tpu.tricks import loge_cross_entropy_loss as j_loge_cross_entropy_loss
from sgl_tpu_torch.graph import symmetric_normalized_weights
from sgl_tpu_torch.tasks import utils as task_utils
from sgl_tpu_torch.tricks import (
    CorrectAndSmooth,
    label_propagation,
    loge_bce_loss,
    loge_cross_entropy_loss,
)
from tests.conftest import random_graph
from tests.test_torch_graph import to_port_graph

CPU = torch.device("cpu")
RTOL = 1e-5
C = 5


@pytest.fixture(scope="module")
def graphs():
    jg = random_graph(n=250, avg_deg=8, d=4, num_classes=C, seed=13)
    return jg, to_port_graph(jg)


def _inputs(n: int, seed: int = 11):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, C)).astype(np.float32)
    y_soft = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    y_true = rng.integers(0, C, n)
    mask = rng.choice(n, size=n // 3, replace=False)
    return y_soft, y_true, mask


@pytest.mark.parametrize("kind", ["integer", "soft", "integer_masked", "soft_boolean_mask"])
@pytest.mark.parametrize("r", [0.5, 0.3])
def test_label_propagation_matches_sgl_tpu(graphs, kind, r):
    jg, g = graphs
    y_soft, y_true, mask = _inputs(g.num_nodes)
    labels = y_true if kind.startswith("integer") else y_soft
    m = None
    if kind.endswith("masked"):
        m = mask
    elif kind.endswith("boolean_mask"):
        m = np.zeros(g.num_nodes, bool)
        m[mask] = True
    want = j_label_propagation(jnp.asarray(labels), j_sym(jg, r=r), 6, 0.8,
                               mask=None if m is None else jnp.asarray(m))
    got = label_propagation(torch.as_tensor(labels), symmetric_normalized_weights(g, r=r, device=CPU),
                            6, 0.8, mask=m)
    assert got.dtype == torch.float32 and got.shape == (g.num_nodes, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)


def test_label_propagation_custom_post_process(graphs):
    jg, g = graphs
    y_soft, _, _ = _inputs(g.num_nodes, seed=4)
    want = j_label_propagation(jnp.asarray(y_soft), j_sym(jg), 4, 0.5, post_process=lambda x: x * 2.0)
    got = label_propagation(torch.as_tensor(y_soft), symmetric_normalized_weights(g, device=CPU), 4, 0.5,
                            post_process=lambda x: x * 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("module", ["tricks", "tasks.utils"])
def test_loge_losses_match_sgl_tpu(module):
    ce = loge_cross_entropy_loss if module == "tricks" else task_utils.loge_cross_entropy_loss
    bce = loge_bce_loss if module == "tricks" else task_utils.loge_bce_loss
    rng = np.random.default_rng(5)
    logits = (3 * rng.normal(size=(64, C))).astype(np.float32)
    labels = rng.integers(0, C, 64)
    target = (rng.random((64, C)) < 0.4).astype(np.float32)
    np.testing.assert_allclose(
        float(ce(torch.as_tensor(logits), torch.as_tensor(labels))),
        float(j_loge_cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))), rtol=RTOL)
    np.testing.assert_allclose(
        float(bce(torch.as_tensor(logits), torch.as_tensor(target))),
        float(j_loge_bce_loss(jnp.asarray(logits), jnp.asarray(target))), rtol=RTOL)


@pytest.mark.parametrize("autoscale", [True, False])
def test_correct_and_smooth_matches_sgl_tpu(graphs, autoscale):
    """``tests/test_reference_parity.py::test_correct_and_smooth_parity``'s
    case, held against ``sgl_tpu``: 3 correct layers at 0.8, 2 smooth
    layers at 0.6, scale 1.5."""
    jg, g = graphs
    y_soft, y_true, mask = _inputs(g.num_nodes)
    jcs = JCorrectAndSmooth(3, 0.8, 2, 0.6, autoscale=autoscale, scale=1.5)
    jadj = j_sym(jg)
    want_c = jcs.correct(jnp.asarray(y_soft), jnp.asarray(y_true), mask, jadj)
    want_s = jcs.smooth(want_c, jnp.asarray(y_true), mask, jadj)
    cs = CorrectAndSmooth(3, 0.8, 2, 0.6, autoscale=autoscale, scale=1.5)
    adj = symmetric_normalized_weights(g, device=CPU)
    got_c = cs.correct(torch.as_tensor(y_soft), torch.as_tensor(y_true), mask, adj)
    got_s = cs.smooth(got_c, torch.as_tensor(y_true), mask, adj)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=RTOL, atol=1e-6)


def test_smooth_leaves_its_input_alone(graphs):
    _, g = graphs
    y_soft, y_true, mask = _inputs(g.num_nodes)
    before = torch.as_tensor(y_soft).clone()
    CorrectAndSmooth(1, 0.5, 1, 0.5).smooth(before, torch.as_tensor(y_true), mask,
                                           symmetric_normalized_weights(g, device=CPU))
    assert torch.equal(before, torch.as_tensor(y_soft))
