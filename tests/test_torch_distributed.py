"""The port's distributed runtime (``sgl_tpu_torch.parallel``,
``NodeClassificationDist``, the NAS dist twins) against ``sgl_tpu``'s, on the
CPU.

In this process: ``partition_adj``'s arrays bit-equal to ``sgl_tpu``'s (P =
1, 4, uneven nodes); ``partition_adj_chunked``'s shuffle, diag, out-hub and
dst-hub arrays equal on the zipf graph of ``__graft_entry__.py:87-89`` at
P = 4, and its buckets the same edges; ``pad_features``, ``MeshConfig``,
``init_distributed`` with no environment, the one-rank ring against
``sgl_tpu`` on a one-device mesh (1e-5), ``ring_bucket_work_time``, and the
two dist examples alone.

Across processes (gloo ranks on the CPU through
``sgl_tpu_torch.dev.dist_worker``, two launches): at P = 4 on a (1, 4) mesh
the segment and chunked rings, f32 and bf16, replicated and sharded,
against ``sgl_tpu``'s ``k_hop_propagate_dist`` on a (1, 4) mesh (f32 rtol
2e-4 / atol 2e-5, bf16 relative error < 3e-2) and the two layouts within
1e-5 of each other; on a (2, 2) mesh one data-parallel GAMLP step with
dropout 0.5 from ``sgl_tpu``'s parameters and dropout bits against
``sgl_tpu``'s single-device step (rtol 1e-5, atol 1e-6),
``NodeClassificationDist`` with PASCA_V3 sharded and replicated, and
``SearchManagerDist``'s inner loop (accuracy > 0.6, the same on every rank).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgl_tpu.datasets.synthetic as jsyn
import sgl_tpu.models.homo as JH
from sgl_tpu.graph import symmetric_normalized_weights as j_norm
from sgl_tpu.parallel import k_hop_propagate_dist as j_k_hop_dist
from sgl_tpu.parallel import make_mesh as j_make_mesh
from sgl_tpu.parallel import partition_adj as j_partition_adj
from sgl_tpu.parallel import partition_adj_chunked as j_partition_adj_chunked
from sgl_tpu.parallel import ring_padding_stats as j_ring_padding_stats
from sgl_tpu.tasks.utils import adam_l2 as j_adam_l2
from sgl_tpu.tasks.utils import init_train_state, make_train_step as j_make_train_step
from sgl_tpu_torch import convert
from sgl_tpu_torch.dev import dist_worker
from sgl_tpu_torch.kernels.sparse import SparseAdj
from sgl_tpu_torch.models import homo as PH
from sgl_tpu_torch.parallel import (
    k_hop_propagate_dist,
    make_mesh,
    pad_features,
    partition_adj,
    partition_adj_chunked,
    ring_bucket_work_time,
    ring_padding_stats,
)
from sgl_tpu_torch.utils import MeshConfig
from tests.conftest import random_graph

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")

F32_TOL = dict(rtol=2e-4, atol=2e-5)  # __graft_entry__.py:113
BF16_REL = 3e-2
STEP_TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_distributed.py:124-130


def _port_adj(jadj) -> SparseAdj:
    return SparseAdj(*(torch.as_tensor(np.array(a)) for a in (jadj.src, jadj.dst, jadj.w)), jadj.num_nodes)


def _zipf_adj(p: int):
    """The adversarial graph of ``__graft_entry__.py:87-89``: every split
    activates."""
    g = jsyn.random_power_law_graph(max(20_000, 2560 * p), 3, 8, seed=0, alpha=1.5)
    return g, j_norm(g)


@pytest.fixture
def one_rank():
    """The one-rank process group ``make_mesh`` starts alone, torn down after."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- layouts, in this process ----------------------------------------------------


@pytest.mark.parametrize("n, p", [(333, 1), (333, 4), (101, 8)])
def test_partition_adj_matches_sgl_tpu(n, p):
    g = random_graph(n=n, avg_deg=10, d=4, seed=21)
    jadj = j_norm(g)
    want = j_partition_adj(jadj, p)
    got = partition_adj(_port_adj(jadj), p)
    assert (got.num_nodes, got.block, got.num_partitions) == (want.num_nodes, want.block, p)
    for name in ("src", "dst", "w"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name
    assert ring_padding_stats(got) == j_ring_padding_stats(want)


def _bucket_edges(dadj) -> set:
    """(src, dst, w) of every bucket edge in the layout's (shuffled)
    numbering: a bucket's rows are its owner's block, its columns the
    source block's."""
    out = set()
    for o, row in enumerate(dadj.buckets):
        for b, part in enumerate(row):
            rows = np.repeat(np.arange(part.num_rows), np.diff(part.rowptr.numpy()))
            for s, d, w in zip(part.col.numpy() + b * dadj.block, rows + o * dadj.block, part.val.numpy()):
                out.add((int(s), int(d), float(w)))
    return out


def _j_bucket_edges(jd) -> set:
    src, dst, w = (np.asarray(a) for a in (jd.src, jd.dst, jd.w))
    o, b, _ = np.nonzero(w != 0)
    real = w != 0
    return {(int(s), int(d), float(x)) for s, d, x in zip(
        src[real] + b * jd.block, dst[real] + o * jd.block, w[real])}


def test_partition_adj_chunked_matches_sgl_tpu_on_the_zipf_graph():
    g, jadj = _zipf_adj(4)
    want = j_partition_adj_chunked(jadj, 4)
    got = partition_adj_chunked(_port_adj(jadj), 4)
    n = g.num_nodes
    for name in ("order", "diag", "hub_ids", "hub_m", "hub_in_ids", "hub_in_m"):
        assert getattr(want, name) is not None and getattr(got, name) is not None, name
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    np.testing.assert_array_equal(got.diag.numpy()[:n], np.asarray(want.diag)[:n])
    np.testing.assert_array_equal(got.hub_ids.numpy(), np.asarray(want.hub_ids))
    np.testing.assert_array_equal(got.hub_m.numpy()[:n], np.asarray(want.hub_m)[:n])
    np.testing.assert_array_equal(got.hub_in_ids.numpy(), np.asarray(want.hub_in_ids))
    np.testing.assert_array_equal(got.hub_in_m.numpy()[:, :n], np.asarray(want.hub_in_m)[:, :n])
    edges = _bucket_edges(got)
    assert len(edges) == got.nnz == int((np.asarray(want.w) != 0).sum())
    assert edges == _j_bucket_edges(want)
    # unpadded buckets: ratio 1.0 by construction
    assert ring_padding_stats(got)["ratio"] == 1.0
    assert got.block == -(-n // 4)


def test_pad_features_and_mesh_config():
    x = np.arange(10 * 3, dtype=np.float64).reshape(10, 3)
    got = pad_features(x, 4)
    assert got.dtype == torch.float32 and got.shape == (12, 3)
    np.testing.assert_array_equal(got.numpy()[:10], x.astype(np.float32))
    assert not got[10:].any()
    bf = pad_features(torch.ones(5, 2, dtype=torch.bfloat16), 2, block=4)
    assert bf.dtype == torch.bfloat16 and bf.shape == (8, 2)
    from sgl_tpu.utils.config import MeshConfig as JMeshConfig

    assert MeshConfig().shape == JMeshConfig().shape == (1, 1)
    assert MeshConfig(data=2, graph=4).shape == JMeshConfig(data=2, graph=4).shape == (2, 4)


def test_init_distributed_without_environment_does_nothing(monkeypatch):
    from sgl_tpu_torch.parallel import init_distributed

    for var in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("chunked", [False, True], ids=["segment", "chunked"])
def test_one_rank_ring_matches_sgl_tpu(one_rank, chunked):
    g = random_graph(n=300, avg_deg=11, d=12, seed=23)
    jadj = j_norm(g)
    jmesh = j_make_mesh((1, 1), devices=jax.devices()[:1])
    want = np.asarray(j_k_hop_dist(jmesh, j_partition_adj(jadj, 1), g.x, prop_steps=3))
    mesh = make_mesh()
    assert mesh.mesh_dim_names == ("data", "graph") and mesh.size() == 1
    part = partition_adj_chunked if chunked else partition_adj
    got = k_hop_propagate_dist(mesh, part(_port_adj(jadj), 1), np.asarray(g.x), 3, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    sh = k_hop_propagate_dist(mesh, part(_port_adj(jadj), 1), np.asarray(g.x), 3, device="cpu",
                              keep_sharded=True)
    np.testing.assert_allclose(sh.rows([0, 7, 299]).numpy(), want[:, [0, 7, 299]], rtol=1e-5, atol=1e-5)
    assert sh.per_device_bytes == 4 * 4 * 300 * 12


def test_ring_bucket_work_time_is_positive():
    _, jadj = _zipf_adj(1)
    dadj = partition_adj_chunked(_port_adj(jadj), 4)
    for dtype in (torch.float32, torch.bfloat16):
        t = ring_bucket_work_time(dadj, 16, dtype=dtype, rounds=1, iters=1, device="cpu")
        assert 0 < t < 10


def test_examples_run_alone(one_rank, capsys):
    from sgl_tpu_torch.examples import nas_dist, nodeclass_dist

    acc = nodeclass_dist.main(["--device", "cpu", "--epochs", "5", "--nodes", "300"])
    assert 0.0 <= acc <= 1.0
    history = nas_dist.main(["--device", "cpu", "--max-runs", "2", "--epochs", "3", "--nodes", "200"])
    assert len(history.trials) == 2
    assert "final test acc" in capsys.readouterr().out


# -- across processes ---------------------------------------------------------------


def test_ring_across_four_ranks_matches_sgl_tpu(tmp_path):
    g, jadj = _zipf_adj(4)
    ids = np.array([0, 1, 7, g.num_nodes - 1])
    x = np.asarray(g.x, np.float32)
    np.savez(tmp_path / "in.npz", src=np.asarray(jadj.src), dst=np.asarray(jadj.dst), w=np.asarray(jadj.w),
             num_nodes=g.num_nodes, x=x, prop_steps=2, ids=ids)
    ranks = dist_worker.launch(4, (1, 4), {"checks": ["ring"], "inputs": str(tmp_path / "in.npz")},
                               str(tmp_path / "out"), device="cpu", threads=2, limit_s=120)
    jmesh = j_make_mesh((1, 4), devices=jax.devices()[:4])
    want = np.asarray(j_k_hop_dist(jmesh, j_partition_adj(jadj, 4), x, prop_steps=2))
    for r in ranks:
        a = r["arrays"]
        for layout in ("segment", "chunked"):
            assert r[f"{layout}_f32_dtype"] == "torch.float32"
            assert r[f"{layout}_bf16_dtype"] == "torch.bfloat16"  # the sharded stack stays bf16
            assert r[f"{layout}_f32_shard_shape"][1] == -(-g.num_nodes // 4)
            assert r[f"{layout}_f32_route"] == "gloo, cpu tensors"
            for form, ref in (("full", want), ("gather", want), ("rows", want[:, ids])):
                np.testing.assert_allclose(a[f"{layout}_f32_{form}"], ref, **F32_TOL)
                assert np.isfinite(a[f"{layout}_bf16_{form}"]).all()
                assert _rel(a[f"{layout}_bf16_{form}"], ref) < BF16_REL
        np.testing.assert_allclose(a["chunked_f32_full"], a["segment_f32_full"], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(a["chunked_f32_full"], ranks[0]["arrays"]["chunked_f32_full"])


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _gamlp_step_inputs(tmp_path, monkeypatch) -> dict:
    """``sgl_tpu``'s single-device GAMLP step (dropout 0.5) with its dropout
    bits recorded, and the same parameters carried into the port."""
    jds = jsyn.PlantedPartition(num_nodes=160, feat_dim=8, seed=5)
    c = int(np.asarray(jds.y).max()) + 1
    args = (3, 8, c, 16, 3)
    jm = JH.GAMLP(*args)
    jm.preprocess(jds.graph, jds.x)
    variables = jm.init(jax.random.PRNGKey(0))
    idx = jnp.arange(160)
    labels = jnp.asarray(np.asarray(jds.y), jnp.int32)
    w = jnp.ones(160, jnp.float32)
    lr, wd = 0.01, 5e-4
    tx = j_adam_l2(lr, wd)
    net = jm.net
    step = j_make_train_step(lambda p, f, train, rngs: net.apply(p, f, train=train, rngs=rngs), tx)
    state = init_train_state(jax.random.PRNGKey(0), variables, tx)
    feats = jm.batch_input(idx)
    bits, draw = [], jax.random.bits

    def recording(key, shape=(), dtype=None):
        out = draw(key, shape, dtype)
        if out.dtype == jnp.uint8:  # FastDropout's draws (the key setup draws uint32)
            bits.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "bits", recording)
    with jax.disable_jit():
        state, loss, acc = step(state, feats, labels, w)
    monkeypatch.setattr(jax.random, "bits", draw)
    assert len(bits) == 2  # one dropout per hidden layer

    pm = PH.GAMLP(*args)
    convert.load_flax_params(pm, _np_tree(variables))
    torch.save(pm.net.state_dict(), tmp_path / "state.pt")
    want = PH.GAMLP(*args)
    convert.load_flax_params(want, _np_tree(state.params))
    np.savez(tmp_path / "dp.npz", feats=np.asarray(feats), labels=np.asarray(labels)[np.asarray(idx)],
             w=np.asarray(w), num_bits=len(bits), **{f"bits_{i}": b for i, b in enumerate(bits)})
    spec = {"model": {"name": "GAMLP", "args": list(args)}, "state": str(tmp_path / "state.pt"),
            "lr": lr, "weight_decay": wd, "seed": 3}
    return dict(spec=spec, loss=float(loss), acc=float(acc),
                params={k: v.numpy() for k, v in want.net.state_dict().items()})


def test_mesh_2x2_step_task_and_nas(tmp_path, monkeypatch):
    ref = _gamlp_step_inputs(tmp_path, monkeypatch)
    spec = {
        "checks": ["dp", "task", "nas"],
        "inputs": str(tmp_path / "dp.npz"),
        "dp": ref["spec"],
        "task": {"dataset": {"name": "PlantedPartition",
                             "kwargs": dict(num_nodes=256, feat_dim=8, p_in=0.08, seed=9)},
                 "model": {"name": "PASCA_V3", "args": [2, 2, 8, 4], "kwargs": dict(hidden_dim=16, num_layers=2)},
                 "train": dict(lr=0.05, weight_decay=5e-5, epochs=10)},
        "nas": {"dataset": {"name": "PlantedPartition",
                            "kwargs": dict(num_nodes=128, feat_dim=8, p_in=0.1, seed=10)},
                "arch": [2, 1, 0, 1, 0, 0, 0], "hidden": 16,
                "train": dict(lr=0.1, weight_decay=5e-5, epochs=8)},
    }
    ranks = dist_worker.launch(4, (2, 2), spec, str(tmp_path / "out"), device="cpu", threads=2, limit_s=150)
    for r in ranks:
        # the data-parallel step from sgl_tpu's parameters and dropout bits
        # equals sgl_tpu's single-device step
        np.testing.assert_allclose(r["dp_loss"], ref["loss"], rtol=1e-5)
        assert r["dp_acc"] == pytest.approx(ref["acc"], rel=1e-6)
        for key, want in ref["params"].items():
            np.testing.assert_allclose(r["arrays"][f"dp_param.{key}"], want, err_msg=key, **STEP_TOL)
        # and with the port's own generator, the single-device step's mask
        np.testing.assert_allclose(r["gen_loss"][0], r["gen_loss"][1], rtol=1e-5)
        assert r["gen_acc"][0] == pytest.approx(r["gen_acc"][1])
        assert r["gen_param_max_abs_diff"] <= 1e-6
        assert r["task_acc_sharded"] > 0.6 and r["nas_acc"] > 0.6 and r["nas_seconds"] > 0
        assert r["task_acc_sharded"] == r["task_acc_replicated"]
        for key in ("task_acc_sharded", "task_acc_replicated", "nas_acc", "gen_loss"):
            assert r[key] == ranks[0][key], key


def test_workload_runs_in_this_process_and_keeps_its_first_step(one_rank, tmp_path):
    """``dist_worker.run_here``: the workload check at a world of one in the
    calling process, its group destroyed after; the task's layout and first
    step (parameters before and after, summed gradients) come back."""
    spec = {"checks": ["workload"], "workload": {
        "dataset": {"name": "SyntheticPowerLaw", "kwargs": dict(num_nodes=400, avg_degree=6, feat_dim=8,
                                                               num_classes=4, seed=1)},
        "runs": [{"name": "GAMLP", "model": {"name": "GAMLP", "args": [2, 8, 4], "kwargs": dict(hidden_dim=16, num_layers=2)},
                  "train": dict(lr=0.05, weight_decay=5e-5, epochs=2)}]}}
    (r,) = dist_worker.run_here((1, 1), spec, str(tmp_path), device="cpu", backend="gloo")
    assert not torch.distributed.is_initialized()
    row = r["GAMLP"]
    # the CPU takes the segment layout: no K3 launch, none expected
    assert row["launches"] == row["want_launches"] == {"acc_f32": 0, "fixup_acc_f32": 0}
    assert row["err_vs_single"] <= 1e-5 and 0.0 <= row["test_acc"] <= 1.0 and np.isfinite(row["first_loss"])
    keys = {k.split(".", 2)[1] for k in r["arrays"]}
    assert keys == {"first_params_before", "first_grads", "first_params"}
    before, after = (r["arrays"][f"GAMLP.first_{w}.base_model.layers.0.weight"] for w in ("params_before", "params"))
    assert before.shape == after.shape and not np.array_equal(before, after)
    # a second group in a process that has one is refused
    torch.distributed.init_process_group("gloo", store=torch.distributed.HashStore(), rank=0, world_size=1)
    with pytest.raises(RuntimeError, match="process group"):
        dist_worker.run_here((1, 1), spec, str(tmp_path), device="cpu", backend="gloo")
