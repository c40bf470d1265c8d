"""The port's host hop store (``sgl_tpu_torch/utils/hop_store.py``), the
model's ``attach_host_hops`` and the precompute-to-training loop against
``sgl_tpu``, on the CPU.

Mirrors ``tests/test_kernels.py:681-720``.  Tolerances: stored bits equal
(the store copies); hops within 1e-5 of max|hop| of ``sgl_tpu``'s
out-of-core hops (its bf16 hi/lo split, run with ``interpret=True``, reads
~2.4e-6 here) and within rtol 1e-5, atol 1e-6 of the port's in-memory
propagation (the pipeline's hops, which reach ~10, within 1e-5 of
max|hop|); per-epoch training losses from the store within 1e-5 of the
in-memory path's from the same generator (the hops differ by f32 sum
order only).
"""

import numpy as np
import pytest
import torch

import ml_dtypes
import sgl_tpu.datasets.synthetic as jsyn
from sgl_tpu.models.homo import GAMLP as JGAMLP
from sgl_tpu.models.homo import SGC as JSGC
from sgl_tpu.utils import MemmapHopSink as JMemmapHopSink
from sgl_tpu_torch.datasets import PlantedPartition
from sgl_tpu_torch.examples import papers100m_pipeline
from sgl_tpu_torch.models import GAMLP, SGC
from sgl_tpu_torch.ops import LaplacianGraphOp
from sgl_tpu_torch.tasks import NodeClassification
from sgl_tpu_torch.utils import HostHops, MemmapHopSink

CPU = "cpu"


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_memmap_sink_f32_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    hops = [rng.normal(size=(50, 6)).astype(np.float32) for _ in range(3)]
    sink = MemmapHopSink(tmp_path, num_nodes=50, feat_dim=6, prop_steps=2)
    for k, h in enumerate(hops):
        sink(k, h if k != 1 else torch.from_numpy(h))  # numpy or a CPU tensor
    store = sink.hops(device=CPU)
    assert store.num_hops == 3 and store.num_nodes == 50 and store.dtype == torch.float32
    for k, h in enumerate(hops):
        got = np.load(sink.path(k), mmap_mode="r")
        assert got.dtype == np.float32 and not got.flags.writeable
        np.testing.assert_array_equal(got, h)
    idx = np.array([3, 0, 49, 3])
    np.testing.assert_array_equal(store.rows(idx).numpy(), np.stack(hops)[:, idx])


def test_memmap_sink_bf16_bits_equal_sgl_tpus(tmp_path):
    """bf16 hops are stored as their 16-bit bits, in the file ``sgl_tpu``
    writes for the same bits."""
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(40, 5)).astype(np.float32)).to(torch.bfloat16)
    bits = x.view(torch.int16).numpy()
    port = MemmapHopSink(tmp_path / "port", 40, 5, 0, dtype=torch.bfloat16)
    port(0, x)
    ref = JMemmapHopSink(str(tmp_path / "ref"), 40, 5, 0, dtype=ml_dtypes.bfloat16)
    ref(0, bits.view(ml_dtypes.bfloat16))
    with open(port.path(0), "rb") as a, open(ref.path(0), "rb") as b:
        assert a.read() == b.read()
    assert np.load(port.path(0)).dtype == np.uint16
    store = port.hops(device=CPU)
    assert store.dtype == torch.bfloat16
    assert torch.equal(store.rows(np.arange(40))[0], x)
    # the JAX store reads back the same values
    np.testing.assert_array_equal(
        np.asarray(ref.hops()._hops[0]).view(np.uint16), bits.view(np.uint16)
    )
    # an f32 hop handed to a bf16 sink is rounded to bf16 first
    port(0, x.float().numpy())
    assert torch.equal(port.hops(device=CPU).rows(np.arange(40))[0], x)


@pytest.mark.parametrize("with_agg", [False, True], ids=["stack", "agg"])
def test_host_hops_rows_match_plain_indexing(with_agg):
    rng = np.random.default_rng(2)
    hops = [rng.normal(size=(30, 4)).astype(np.float32) for _ in range(4)]
    agg = (lambda stack: stack.sum(0)) if with_agg else None
    store = HostHops(hops, agg=agg, device=CPU)
    idx = torch.tensor([5, 29, 0, 5, 17])
    got = store.rows(idx)
    want = np.stack(hops)[:, idx.numpy()]
    np.testing.assert_array_equal(got.numpy(), want.sum(0) if with_agg else want)
    bf = HostHops([torch.from_numpy(h).to(torch.bfloat16) for h in hops], device=CPU)
    assert torch.equal(bf.rows(idx), torch.from_numpy(want).to(torch.bfloat16))
    with pytest.raises(ValueError):
        HostHops([])
    with pytest.raises(ValueError):
        HostHops([hops[0], hops[1][:10]], device=CPU)


def test_attach_host_hops_refuses_a_wrong_hop_count():
    hops = [np.zeros((10, 4), np.float32)] * 3
    model = SGC(3, 4, 2)
    with pytest.raises(ValueError, match="4"):
        model.attach_host_hops(HostHops(hops, device=CPU))
    model = SGC(2, 4, 2)
    store = HostHops(hops, device=CPU)
    model.attach_host_hops(store)
    assert store.agg is not None  # a non-learnable op aggregates each batch
    model.preprocess(None)  # keeps the store: nothing to propagate
    assert model.processed_feature is store


@pytest.fixture(scope="module")
def planted():
    return (PlantedPartition(num_nodes=300, feat_dim=8, p_in=0.08, seed=6),
            jsyn.PlantedPartition(num_nodes=300, feat_dim=8, p_in=0.08, seed=6))


MODELS = {
    "sgc": (lambda ds: SGC(2, ds.num_features, ds.num_classes),
            lambda ds: JSGC(2, ds.num_features, ds.num_classes)),
    "gamlp": (lambda ds: GAMLP(2, ds.num_features, ds.num_classes, hidden_dim=16, num_layers=2),
              lambda ds: JGAMLP(2, ds.num_features, ds.num_classes, hidden_dim=16, num_layers=2)),
}


@pytest.mark.parametrize("kind", ["sgc", "gamlp"])
def test_out_of_core_precompute_to_training(tmp_path, planted, kind):
    """The papers100M-regime loop at toy scale: the 2-D out-of-core
    precompute into a memmap store, then the whole training task from the
    store.  Eager (SGC) and learnable (GAMLP) aggregation both train; the
    hops match ``sgl_tpu``'s and the port's in-memory ones, and the losses
    the in-memory path's."""
    ds, jds = planted
    assert np.array_equal(np.asarray(ds.x), np.asarray(jds.x))
    make, jmake = MODELS[kind]
    ooc_kw = dict(layout="2d", src_blocks=2, max_edges_per_part=8 * 128)

    model = make(ds)
    sink = MemmapHopSink(tmp_path / "port", num_nodes=ds.num_node, feat_dim=ds.num_features, prop_steps=2)
    model.pre_graph_op.propagate_out_of_core(ds.graph, np.asarray(ds.x), hop_sink=sink, device=CPU, **ooc_kw)
    jmodel = jmake(jds)
    jsink = JMemmapHopSink(str(tmp_path / "ref"), num_nodes=jds.num_node, feat_dim=jds.num_features,
                           prop_steps=2)
    jmodel.pre_graph_op.propagate_out_of_core(jds.graph, np.asarray(jds.x), hop_sink=jsink, interpret=True,
                                              **ooc_kw)
    in_memory = LaplacianGraphOp(2).propagate(ds.graph, ds.x, device=CPU).numpy()
    for k in range(3):
        hop = np.load(sink.path(k))
        assert _rel(hop, np.load(jsink.path(k))) <= 1e-5
        np.testing.assert_allclose(hop, in_memory[k], rtol=1e-5, atol=1e-6)

    kw = dict(lr=0.1, weight_decay=5e-5, epochs=8, verbose=False, device=CPU, train_batch_size=64,
              eval_batch_size=100)
    model.attach_host_hops(sink.hops(device=CPU))
    from_store = NodeClassification(ds, model, **kw)
    assert model.processed_feature.num_hops == 3  # preprocess kept the store
    in_mem = NodeClassification(ds, make(ds), **kw)
    np.testing.assert_allclose(from_store.train_losses, in_mem.train_losses, rtol=1e-5, atol=1e-5)
    assert from_store.test_acc > 0.6
    assert abs(from_store.test_acc - in_mem.test_acc) <= 0.02


def test_papers100m_pipeline_toy(tmp_path):
    out = papers100m_pipeline.main(["--toy", "--store", str(tmp_path / "store")], device=CPU)
    ds, sink, layout = out["dataset"], out["sink"], out["layout"]
    assert ds.num_node == 2_000 and layout.num_blocks == 2 and layout.num_parts > 1
    assert 0 < out["store_bytes"] - 4 * 2_000 * 128 * 4 <= 4 * 4096  # four .npy headers
    want = LaplacianGraphOp(3).propagate(ds.graph, ds.x, device=CPU).numpy()
    for k in range(4):  # f32 sums in two orders, of max|hop| (hops here reach ~10)
        assert _rel(np.load(sink.path(k)), want[k]) <= 1e-5
    assert len(out["task"].train_losses) == 4 and np.isfinite(out["task"].train_losses).all()
    assert out["test_acc"] > 0.5
