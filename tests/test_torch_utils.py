"""The port's utilities on the CPU: the stage timer, checkpoints (a train
state resumed bit for bit, a precompute killed and resumed, against
``sgl_tpu``'s within 1e-5), timing and tracing, and the device chooser."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_tpu.graph import symmetric_normalized_weights as j_sym
from sgl_tpu.utils.checkpoint import HopCheckpointer as JHopCheckpointer
from sgl_tpu_torch.graph import symmetric_normalized_weights
from sgl_tpu_torch.kernels import prepare_csr, spmm
from sgl_tpu_torch.models.blocks import ResMultiLayerPerceptron, init_params
from sgl_tpu_torch.ops.graph_ops import k_hop_propagate
from sgl_tpu_torch.tasks.utils import adam_l2, make_train_step
from sgl_tpu_torch.utils import (
    GpuWithMaxFreeMem,
    HopCheckpointer,
    StageTimer,
    default_backend,
    device_with_max_free_mem,
    load_pytree,
    load_train_state,
    num_devices,
    save_pytree,
    save_train_state,
    slope_time,
    sync,
    torch_trace,
)
from tests.conftest import random_graph
from tests.test_torch_graph import to_port_graph


def test_stage_timer_accumulates_per_stage():
    timer = StageTimer()
    for _ in range(3):
        with timer.stage("propagate"):
            pass
    with timer.stage("train"):
        sum(range(1000))
    assert timer.counts == {"propagate": 3, "train": 1}
    assert timer.total() == pytest.approx(timer.totals["propagate"] + timer.totals["train"])
    assert timer.total("train") == timer.totals["train"] > 0
    assert "propagate=" in timer.summary() and "(n=3)" in timer.summary()
    with pytest.raises(KeyError):
        with timer.stage("fails"):
            raise KeyError("x")
    assert timer.counts["fails"] == 1  # a stage that raises is still timed


def test_pytree_round_trip_with_numpy_leaves(tmp_path):
    tree = {"w": torch.arange(6.0).view(2, 3), "bf": torch.tensor([1.5, -2.0], dtype=torch.bfloat16),
            "nested": [np.arange(3), (torch.zeros(2, dtype=torch.int64), "tag")], "step": 7}
    path = str(tmp_path / "ck" / "tree.pkl")
    save_pytree(path, tree)
    assert not os.path.exists(path + ".tmp")  # written atomically
    loaded = load_pytree(path)
    assert isinstance(loaded["w"], np.ndarray) and np.array_equal(loaded["w"], tree["w"].numpy())
    assert loaded["nested"][1][1] == "tag" and loaded["step"] == 7
    from sgl_tpu_torch.utils.checkpoint import _to_tensors

    back = _to_tensors(loaded)
    assert back["bf"].dtype == torch.bfloat16 and torch.equal(back["bf"], tree["bf"])


def _train(net, optimizer, gen, x, y, steps):
    step = make_train_step(net, optimizer)
    w = torch.ones(x.shape[0])
    return [float(step(x, y, w, gen)[0]) for _ in range(steps)]


def _fresh(seed):
    net = ResMultiLayerPerceptron(12, 16, 3, 4, dropout=0.5)  # dropout: the generator's state matters
    init_params(net, torch.Generator().manual_seed(seed))
    return net, adam_l2(net.parameters(), 0.01, 5e-4), torch.Generator().manual_seed(seed + 100)


def test_train_state_resume_is_bit_equal(tmp_path):
    """3 steps, save, load into a fresh net / optimizer / generator, 3
    more: the same bits as 6 steps in one go."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(64, 12)).astype(np.float32))
    y = torch.as_tensor(rng.integers(0, 4, 64))
    net, opt, gen = _fresh(0)
    whole = _train(net, opt, gen, x, y, 6)

    net_a, opt_a, gen_a = _fresh(0)
    first = _train(net_a, opt_a, gen_a, x, y, 3)
    path = str(tmp_path / "state.pkl")
    save_train_state(path, net_a, opt_a, gen_a)
    net_b, opt_b, gen_b = _fresh(1)  # other weights and draws, overwritten by the load
    load_train_state(path, net_b, opt_b, gen_b)
    second = _train(net_b, opt_b, gen_b, x, y, 3)
    assert first + second == whole
    for k, v in net.state_dict().items():
        assert torch.equal(v, net_b.state_dict()[k]), k


def test_hop_checkpointer_killed_and_resumed(tmp_path):
    g = random_graph(n=60, d=8, seed=2)
    pg = to_port_graph(g)
    adj = prepare_csr(symmetric_normalized_weights(pg, device="cpu"))
    calls = []

    def dies_after_two_hops(a, h):
        if len(calls) == 2:
            raise RuntimeError("killed")
        calls.append(1)
        return spmm(a, h)

    ck = HopCheckpointer(str(tmp_path / "hops"))
    with pytest.raises(RuntimeError, match="killed"):
        ck.propagate_resumable(adj, g.x, 4, spmm_fn=dies_after_two_hops, device="cpu")
    assert ck.last_completed_hop() == 2
    resumed = HopCheckpointer(str(tmp_path / "hops")).propagate_resumable(adj, g.x, 4, device="cpu")
    direct = k_hop_propagate(adj, torch.as_tensor(np.asarray(g.x)), 4)
    assert torch.equal(resumed, direct)

    jadj = j_sym(g)
    want = JHopCheckpointer(str(tmp_path / "jax")).propagate_resumable(jadj, jnp.asarray(g.x), 4)
    np.testing.assert_allclose(resumed.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_hop_checkpointer_runs_on_the_gpu_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = random_graph(n=20, d=4, seed=3)
    adj = prepare_csr(symmetric_normalized_weights(to_port_graph(g), device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HopCheckpointer(str(tmp_path)).propagate_resumable(adj, g.x, 2)


def test_device_with_max_free_mem_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_with_max_free_mem()
    assert GpuWithMaxFreeMem is device_with_max_free_mem
    assert default_backend() == "cpu" and num_devices() == 1 and num_devices("cuda") == 0
    with pytest.raises(ValueError):
        num_devices("tpu")


def test_device_with_max_free_mem_picks_the_freest_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: ([5, 9, 7][i], 10))
    assert device_with_max_free_mem() == torch.device("cuda", 1)
    assert default_backend() == "cuda" and num_devices() == 3 and num_devices("gpu") == 3


def test_sync_and_slope_time_on_the_cpu():
    t = torch.ones(3)
    assert sync(t) is t and sync({"a": [1, t]})["a"][1] is t and sync("no tensor") == "no tensor"

    def chained(k):
        def run():
            for _ in range(k):
                sum(range(100_000))
            return t
        return run

    per_iter = slope_time(chained, k1=2, k2=6, iters=5)
    assert 0 < per_iter < 1.0


def test_torch_trace_writes_a_trace(tmp_path):
    with torch_trace(None) as prof:
        assert prof is None
    with torch_trace(str(tmp_path / "trace")) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert prof is not None
    files = os.listdir(tmp_path / "trace")
    assert files and all(f.endswith(".json") or f.endswith(".json.gz") for f in files)
