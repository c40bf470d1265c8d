"""NAS in the PyTorch port against ``sgl_tpu``'s, on the CPU.

* ``SearchModel`` for every message type 0–8 and post type 0–5, the Flax
  parameters carried into the port (``convert.load_flax_params``):
  preprocessed features, logits and post-processed output rtol 1e-5
  (atol 1e-5);
* one ``SearchManager`` epoch from the carried weights with dropout off:
  the same accuracy, the first step's loss rtol 1e-5;
* ``_execute`` on ``tests/test_search.py``'s graph and archs (acc > 0.5);
* ``PropagationCache``: a prefix and an extension bit-equal to the port's
  direct ``propagate`` and within 1e-5 of ``sgl_tpu``'s ``hops_for``;
  configs, dtypes and feature matrices told apart; hits, misses and hops
  computed equal ``sgl_tpu``'s over one sequence of archs;
* the search drivers under one deterministic stub objective: the same
  configs in the same order and the same Pareto front in both packages;
* the OpenBox adapter against stubs of both API generations.
"""

import importlib.machinery
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgl_tpu.datasets.synthetic as jsyn
import sgl_tpu.search as jsearch
from sgl_tpu.ops.graph_ops import LaplacianGraphOp as JLaplacian
from sgl_tpu.ops.graph_ops import PprGraphOp as JPpr
from sgl_tpu.tasks.node_classification import _make_apply
from sgl_tpu.tasks.utils import adam_l2 as j_adam_l2
from sgl_tpu.tasks.utils import init_train_state
from sgl_tpu.tasks.utils import make_train_step as j_make_train_step
from sgl_tpu_torch import convert
from sgl_tpu_torch.datasets import PlantedPartition
from sgl_tpu_torch.ops import LaplacianGraphOp, PprGraphOp
from sgl_tpu_torch.search import (
    ARCH_KEYS,
    ConfigManager,
    EvolutionarySearch,
    PropagationCache,
    RandomSearch,
    SearchManager,
    SearchModel,
    run_nas,
    run_sha,
)
from sgl_tpu_torch.search.smbo import _openbox_history_to_history

CPU = torch.device("cpu")
SMALL = dict(num_nodes=200, feat_dim=12, p_in=0.08, seed=4)
DS = PlantedPartition(**SMALL)
JDS = jsyn.PlantedPartition(**SMALL)
# one arch a message type (post message types 0-5 among them; every
# graph-op type, both base models)
ARCHS = [(1 + m % 3, 1 + m % 4, m, 1 + m % 3, 1 + (m + 1) % 3, 1 + (m + 2) % 4, m % 6) for m in range(9)]


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(variables))


def _pair(arch, hidden=16, dropout_off=False):
    """The arch in both packages, preprocessed on the same graph, the Flax
    parameters carried into the port."""
    jm = jsearch.SearchModel(arch, JDS.num_features, JDS.num_classes, hidden)
    m = SearchModel(arch, DS.num_features, DS.num_classes, hidden)
    if dropout_off and hasattr(jm.base_model, "dropout"):
        jm.base_model = jm.base_model.clone(dropout=0.0)
        m.base_model.dropout.rate = 0.0
    jm.preprocess(JDS.graph, JDS.x)
    m.preprocess(DS.graph, DS.x, device=CPU)
    variables = jm.init(jax.random.PRNGKey(0))
    convert.load_flax_params(m, _np_tree(variables))
    return jm, m, variables


def test_the_two_graphs_are_the_same():
    for name in ("src", "dst", "val", "x", "y"):
        np.testing.assert_array_equal(getattr(DS.graph, name), np.asarray(getattr(JDS.graph, name)), name)


@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: f"msg{a[2]}-post{a[6]}")
def test_search_model_matches_sgl_tpu(arch):
    jm, m, variables = _pair(arch)
    assert m.feat_dim == jm.feat_dim  # type 1: feat_dim·(K+1)
    np.testing.assert_allclose(m.processed_feature.numpy(), np.asarray(jm.processed_feature), rtol=1e-5, atol=1e-5)
    idx = np.arange(DS.num_node)
    want = jm.apply(variables, jnp.asarray(idx), train=False)
    got = m.apply(torch.as_tensor(idx), train=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    post_want = jm.postprocess(JDS.graph, want)
    post_got = m.postprocess(DS.graph, got.detach())
    np.testing.assert_allclose(post_got.numpy(), np.asarray(post_want), rtol=1e-5, atol=1e-5)


def test_search_model_widths_and_simple_weights():
    """Type 1 concatenates K+1 hops (``feat_dim·(K+1)`` into the base
    model); type 8's ``simple`` weights are ``prop_steps + 1`` long, type 7's
    gate reads ``feat_dim``; the post op exists only with post steps and a
    post type."""
    concat = SearchModel([3, 1, 1, 1, 0, 0, 0], 12, 4, 16)
    assert concat.base_model.dense.weight.shape == (4, 12 * 4) and concat.post_graph_op is None
    simple = SearchModel([3, 1, 8, 2, 2, 1, 0], 12, 4, 16)
    assert simple.pre_msg_op.hop_weight.shape == (4,) and simple.post_graph_op.prop_steps == 2
    gate = SearchModel([3, 1, 7, 2, 2, 1, 0], 12, 4, 16)
    assert gate.pre_msg_op.gate.weight.shape == (1, 12)
    for bad in ([2, 9, 0, 1, 0, 0, 0], [2, 1, 9, 1, 0, 0, 0], [2, 1, 0, 1, 2, 1, 6]):
        with pytest.raises(ValueError):
            SearchModel(bad, 12, 4, 16)


@pytest.mark.parametrize("arch", [(3, 1, 7, 2, 2, 4, 1), (2, 2, 1, 3, 1, 1, 5), (2, 3, 8, 1, 2, 2, 0)])
def test_one_search_manager_epoch_matches_sgl_tpu(arch):
    """One epoch of each package's ``_execute`` from the same weights
    (``sgl_tpu``'s init at its seed, carried into the port), dropout off:
    the same best test accuracy, the first step's loss within 1e-5."""
    jm, m, _ = _pair(arch, dropout_off=True)
    kwargs = dict(lr=0.05, weight_decay=5e-4, epochs=1, restarts=1)
    j_acc, j_time = jsearch.SearchManager(JDS, jm, **kwargs)._execute()
    variables = jm.init(jax.random.PRNGKey(42))  # _execute's own init (set_seed(42))
    m.init = lambda generator=None: convert.load_flax_params(m, _np_tree(variables))
    manager = SearchManager(DS, m, device="cpu", **kwargs)
    acc, elapsed = manager._execute()
    assert acc == pytest.approx(j_acc, abs=1e-12) and elapsed > 0 and j_time > 0

    tx = j_adam_l2(kwargs["lr"], kwargs["weight_decay"])
    state = init_train_state(jax.random.PRNGKey(42), variables, tx)
    step = j_make_train_step(_make_apply(jm), tx)
    train = jnp.asarray(np.asarray(JDS.train_idx))
    labels = jnp.asarray(np.asarray(JDS.y).reshape(-1), jnp.int32)
    _, j_loss, _ = step(state, jm.batch_input(train), labels[train], jnp.ones(train.shape[0], jnp.float32))
    assert len(manager.train_losses) == 1
    np.testing.assert_allclose(manager.train_losses[0], float(j_loss), rtol=1e-5)


@pytest.mark.parametrize(
    "arch",
    [
        [2, 1, 0, 1, 0, 0, 0],  # SGC-like, no post
        [2, 2, 1, 2, 0, 0, 0],  # PPR + concat + ResMLP
        [3, 1, 7, 2, 2, 4, 1],  # gate msg op + PPR post-propagation
        [2, 1, 6, 1, 1, 1, 5],  # alpha weights + laplacian post
    ],
)
def test_search_manager_trains(arch, tmp_path):
    model = SearchModel(arch, DS.num_features, DS.num_classes, hidden_dim=16)
    path = tmp_path / "best" / "best.pt"
    manager = SearchManager(DS, model, lr=0.05, weight_decay=5e-5, epochs=5, restarts=2, device="cpu",
                            checkpoint_path=str(path))
    acc, elapsed = manager._execute()
    assert acc > 0.5, (arch, acc)
    assert elapsed > 0
    # restarts continue the same parameters: 2 x 5 steps, one loss each
    assert len(manager.train_losses) == 10
    state = torch.load(path)
    assert set(state) == set(model.net.state_dict())


def test_search_entry_points_run_on_the_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = SearchModel([2, 1, 0, 1, 0, 0, 0], DS.num_features, DS.num_classes, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SearchManager(DS, model, lr=0.05, weight_decay=5e-5, epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ConfigManager(arch=[2, 1, 0, 1, 0, 0, 0])._setParameters(DS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PropagationCache().hops_for(DS.graph, DS.x, LaplacianGraphOp(2))


# -- the propagation cache ------------------------------------------------------


@pytest.mark.parametrize("kind", ["laplacian", "ppr"])
def test_prop_cache_prefix_and_extension_are_direct_propagation(kind):
    make = (lambda k: LaplacianGraphOp(k)) if kind == "laplacian" else (lambda k: PprGraphOp(k, alpha=0.2))
    jmake = (lambda k: JLaplacian(k)) if kind == "laplacian" else (lambda k: JPpr(k, alpha=0.2))
    cache, jcache = PropagationCache(), jsearch.PropagationCache()
    direct = make(5).propagate(DS.graph, DS.x, device=CPU)
    for k in (3, 2, 5):
        hops, est = cache.hops_for(DS.graph, DS.x, make(k), device=CPU)
        jhops, _ = jcache.hops_for(JDS.graph, JDS.x, jmake(k))
        assert torch.equal(hops, direct[: k + 1]), k
        np.testing.assert_allclose(hops.numpy(), np.asarray(jhops), rtol=1e-5, atol=1e-5)
        assert est > 0
    assert (cache.misses, cache.hits, cache.hops_computed) == (jcache.misses, jcache.hits, jcache.hops_computed)
    assert (cache.misses, cache.hits, cache.hops_computed) == (1, 2, 5)


def test_prop_cache_tells_configs_dtypes_and_features_apart():
    cache = PropagationCache()
    g, x = DS.graph, DS.x
    cache.hops_for(g, x, LaplacianGraphOp(2, r=0.5), device=CPU)
    cache.hops_for(g, x, LaplacianGraphOp(2, r=0.3), device=CPU)  # another r: another entry
    cache.hops_for(g, x, PprGraphOp(2, r=0.5, alpha=0.1), device=CPU)
    bf, _ = cache.hops_for(g, x, LaplacianGraphOp(2, r=0.5), dtype=torch.bfloat16, device=CPU)
    assert cache.misses == 4 and cache.hits == 0 and bf.dtype == torch.bfloat16
    h, _ = cache.hops_for(g, x, LaplacianGraphOp(2, r=0.5), device=CPU)
    assert cache.hits == 1 and h.dtype == torch.float32
    x2 = np.asarray(x) * 2.0  # another feature matrix on the same graph
    h2, _ = cache.hops_for(g, x2, LaplacianGraphOp(2), device=CPU)
    assert cache.misses == 5
    np.testing.assert_allclose(h2.numpy(), 2.0 * h.numpy(), rtol=1e-5, atol=1e-6)


def test_prop_cache_keys_tensor_attributes_by_content():
    from sgl_tpu_torch.search.prop_cache import _op_config_key

    a, b = LaplacianGraphOp(2), LaplacianGraphOp(3)
    a.weights = torch.arange(2000, dtype=torch.float32)
    b.weights = torch.arange(2000, dtype=torch.float32)
    assert _op_config_key(a) == _op_config_key(b)  # prop_steps is not part of the key
    b.weights[1000] = -1.0  # differs only where a repr elides
    assert _op_config_key(a) != _op_config_key(b)
    b.weights = np.arange(2000, dtype=np.float32)
    assert _op_config_key(a) != _op_config_key(b)


def test_prop_cache_stats_match_sgl_tpu_over_a_sequence_of_archs():
    """The same archs through ``preprocess(prop_cache=...)`` in both
    packages: the same hits, misses and hops computed, and the same
    features.  The cache keys on the ``x`` passed, before any conversion."""
    seq = [(2, 1, 0, 1, 0, 0, 0), (4, 1, 2, 1, 0, 0, 0), (3, 2, 7, 2, 0, 0, 0), (1, 1, 6, 1, 0, 0, 0),
           (5, 2, 1, 1, 0, 0, 0), (2, 4, 3, 1, 0, 0, 0), (6, 1, 8, 2, 0, 0, 0)]
    cache, jcache = PropagationCache(), jsearch.PropagationCache()
    for arch in seq:
        m = SearchModel(arch, DS.num_features, DS.num_classes, 16)
        jm = jsearch.SearchModel(arch, JDS.num_features, JDS.num_classes, 16)
        m.preprocess(DS.graph, DS.x, device=CPU, prop_cache=cache)
        jm.preprocess(JDS.graph, JDS.x, prop_cache=jcache)
        np.testing.assert_allclose(m.processed_feature.numpy(), np.asarray(jm.processed_feature),
                                   rtol=1e-5, atol=1e-5)
        assert m.preprocess_time_estimate is not None
    assert (cache.hits, cache.misses, cache.hops_computed) == (jcache.hits, jcache.misses, jcache.hops_computed)
    assert (cache.hits, cache.misses, cache.hops_computed) == (4, 3, 6 + 5 + 2)


def test_search_manager_with_cache_matches_without():
    cache = PropagationCache()
    kwargs = dict(lr=0.05, weight_decay=5e-5, epochs=5, restarts=2, device="cpu")
    for arch in ([2, 1, 0, 1, 0, 0, 0], [3, 1, 7, 2, 0, 0, 0]):
        acc_a, _ = SearchManager(DS, SearchModel(arch, DS.num_features, DS.num_classes, 16), **kwargs)._execute()
        acc_b, elapsed_b = SearchManager(DS, SearchModel(arch, DS.num_features, DS.num_classes, 16),
                                         prop_cache=cache, **kwargs)._execute()
        assert acc_a == acc_b and elapsed_b > 0  # the same hops, the same training
    assert cache.misses == 1 and cache.hits == 1  # the second arch extended the first's stack


# -- the search drivers ------------------------------------------------------------


def _stub(config, epochs=None):
    """A deterministic objective of the config (and the epoch budget)."""
    v = [int(config[k]) for k in ARCH_KEYS]
    acc = ((v[0] * 7 + v[1] * 13 + v[2] * 17 + v[3] * 5 + v[4] * 3 + v[5] * 11 + v[6] * 19) % 89) / 89.0
    if epochs is not None:
        acc = min(1.0, acc + 0.01 * epochs)
    return {"objs": np.array([-acc, 0.1 * v[0] + 0.01 * v[3] + 0.001 * v[4]])}


def _both_configers(**ranges):
    return ConfigManager(arch=[2, 1, 0, 1, 0, 0, 0], **ranges), jsearch.ConfigManager(
        arch=[2, 1, 0, 1, 0, 0, 0], **ranges)


def test_sample_and_random_search_draw_the_same_configs():
    c, jc = _both_configers()
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    assert [c.sample(rng) for _ in range(20)] == [jc.sample(jrng) for _ in range(20)]
    s, js = RandomSearch(c, seed=5), jsearch.RandomSearch(jc, seed=5)
    assert [s.suggest(None) for _ in range(10)] == [js.suggest(None) for _ in range(10)]


def test_evolutionary_search_suggests_the_same_configs():
    from sgl_tpu.search.smbo import History as JHistory
    from sgl_tpu_torch.search import History

    c, jc = _both_configers()
    s, js = EvolutionarySearch(c, seed=7), jsearch.EvolutionarySearch(jc, seed=7)
    h, jh = History(), JHistory()
    for _ in range(25):
        cfg, jcfg = s.suggest(h), js.suggest(jh)
        assert cfg == jcfg
        h.add(cfg, _stub(cfg)["objs"], 0.0)
        jh.add(jcfg, _stub(jcfg)["objs"], 0.0)


@pytest.mark.parametrize("optimizer", ["evolutionary", "random", "auto"])
def test_run_nas_chooses_what_sgl_tpu_chooses(optimizer):
    c, jc = _both_configers(prop_steps=(1, 6), num_layers=(1, 4))
    h = run_nas(c, max_runs=20, optimizer=optimizer, seed=1, verbose=False, objective=_stub)
    jh = jsearch.run_nas(jc, max_runs=20, optimizer=optimizer, seed=1, verbose=False, objective=_stub)
    assert [t.config for t in h.trials] == [t.config for t in jh.trials]
    assert [t.config for t in h.pareto_front()] == [t.config for t in jh.pareto_front()]
    assert h.best_accuracy_trial.config == jh.best_accuracy_trial.config
    assert h.summary().splitlines()[0] == jh.summary().splitlines()[0]


def test_run_sha_chooses_what_sgl_tpu_chooses():
    c, jc = _both_configers()
    h = run_sha(c, n_configs=9, eta=3, min_epochs=5, seed=1, verbose=False, objective=_stub)
    jh = jsearch.run_sha(jc, n_configs=9, eta=3, min_epochs=5, seed=1, verbose=False, objective=_stub)
    assert len(h.trials) == 9 + 3 + 1
    assert [t.config for t in h.trials] == [t.config for t in jh.trials]
    assert [t.config for t in h.pareto_front()] == [t.config for t in jh.pareto_front()]


def test_nas_loops_on_the_real_objective():
    """``run_nas`` and ``run_sha`` through ``_configFunction`` on the CPU:
    trials counted, the epoch override of SHA restored, the shared cache
    used by every trial."""
    c = ConfigManager(arch=[2, 1, 0, 1, 0, 0, 0], prop_steps=(1, 3), num_layers=(1, 2), post_steps=(0, 2))
    c._setParameters(DS, "cpu", 16, epochs=4, lr=0.05, wd=5e-5, restarts=1)
    history = run_nas(c, max_runs=5, optimizer="evolution", verbose=False)
    assert len(history.trials) == 5 and -history.best_accuracy_trial.objs[0] > 0.5
    assert c._prop_cache.hits + c._prop_cache.misses == 5
    sha = run_sha(c, n_configs=4, eta=2, min_epochs=2, seed=0, verbose=False)
    assert len(sha.trials) == 7 and c._epochs == 4


# -- the OpenBox adapter -----------------------------------------------------------


class _HP:
    def __init__(self, name, lo, hi):
        self.name, self.lo, self.hi = name, lo, hi


def _mod(name, **attrs):
    m = types.ModuleType(name)
    m.__spec__ = importlib.machinery.ModuleSpec(name, None)
    for k, v in attrs.items():
        setattr(m, k, v)
    return m


def _small_configer():
    c = ConfigManager(arch=[2, 1, 0, 1, 0, 0, 0], prop_steps=(1, 2), num_layers=(1, 2), post_steps=(0, 1))
    c._setParameters(DS, "cpu", 16, epochs=2, lr=0.05, wd=5e-5, restarts=1)
    return c


def test_nas_openbox_adapter_old_api(monkeypatch):
    """OpenBox ≤ 0.7: ``generic_smbo.SMBO`` with ``num_objs``, the space
    from ``openbox.utils.config_space`` with ``add_hyperparameters``, the
    objective read through ``objs``, its result the list of calls."""
    calls = []

    class _Space:
        def __init__(self):
            self.hps = []

        def add_hyperparameters(self, hps):
            self.hps.extend(hps)

    class _SMBO:
        def __init__(self, objective, space, **kwargs):
            assert kwargs["num_objs"] == 2 and kwargs["max_runs"] == 2
            assert sorted(h.name for h in space.hps) == sorted(ARCH_KEYS)
            self._objective, self._space, self._max_runs = objective, space, kwargs["max_runs"]

        def run(self):
            rng = np.random.default_rng(0)
            for _ in range(self._max_runs):
                config = {h.name: int(rng.integers(h.lo, h.hi + 1)) for h in self._space.hps}
                result = self._objective(config)
                assert len(result["objs"]) == 2
                calls.append(result)
            return calls

    monkeypatch.setitem(sys.modules, "openbox", _mod("openbox"))
    monkeypatch.setitem(sys.modules, "openbox.optimizer", _mod("openbox.optimizer"))
    monkeypatch.setitem(sys.modules, "openbox.optimizer.generic_smbo", _mod("openbox.optimizer.generic_smbo",
                                                                             SMBO=_SMBO))
    monkeypatch.setitem(sys.modules, "openbox.utils", _mod("openbox.utils"))
    monkeypatch.setitem(sys.modules, "openbox.utils.config_space", _mod(
        "openbox.utils.config_space", ConfigurationSpace=_Space, UniformIntegerHyperparameter=_HP))
    out = run_nas(_small_configer(), max_runs=2, optimizer="openbox", verbose=False)
    assert len(calls) == 2 and all(-r["objs"][0] > 0 for r in calls)
    assert len(out.trials) == 2 and -out.best_accuracy_trial.objs[0] > 0
    assert all(t.elapsed > 0 for t in out.trials)  # the wrapper's timings survive


def test_nas_openbox_adapter_new_api(monkeypatch):
    """OpenBox ≥ 0.8: ``openbox.Optimizer`` with ``num_objectives``, the
    space from ``openbox.space`` with ``add`` only, the objective read
    through ``objectives``, its result a history of observations."""

    class _Space:
        def __init__(self):
            self.hps = []

        def add(self, hps):
            self.hps.extend(hps)

    class _Config:
        def __init__(self, d):
            self._d = d

        def get_dictionary(self):
            return dict(self._d)

    class _Optimizer:
        def __init__(self, objective, space, *, num_objectives, num_constraints=0, max_runs=10, **kwargs):
            assert num_objectives == 2
            self._objective, self._space, self._max_runs = objective, space, max_runs

        def run(self):
            rng = np.random.default_rng(0)
            obs = []
            for _ in range(self._max_runs):
                config = _Config({h.name: int(rng.integers(h.lo, h.hi + 1)) for h in self._space.hps})
                result = self._objective(config)
                obs.append(types.SimpleNamespace(config=_Config(config.get_dictionary()),
                                                 objectives=list(result["objectives"])))
            return types.SimpleNamespace(observations=obs)

    monkeypatch.setitem(sys.modules, "openbox", _mod("openbox", Optimizer=_Optimizer))
    monkeypatch.setitem(sys.modules, "openbox.space", _mod(
        "openbox.space", ConfigurationSpace=_Space, UniformIntegerHyperparameter=_HP))
    out = run_nas(_small_configer(), max_runs=2, optimizer="auto", verbose=False)  # auto finds openbox
    assert len(out.trials) == 2 and all(t.elapsed > 0 for t in out.trials)
    assert -out.best_accuracy_trial.objs[0] > 0
    assert set(out.trials[0].config) == set(ARCH_KEYS)


def test_nas_openbox_real_package():
    """The reference's NAS entry point against the real OpenBox, where it
    is installed."""
    pytest.importorskip("openbox")
    out = run_nas(_small_configer(), max_runs=5, optimizer="openbox", verbose=False)
    assert len(out.trials) == 5


def test_openbox_history_elapsed_with_unhashable_and_drifted_config_values():
    cfg = {"prop_steps": 2, "widths": [64, 32]}
    trials = [(cfg, [-0.5, 1.0], 3.25)]
    for seen in (dict(cfg), {"prop_steps": 2.0, "widths": [64, 32]}):
        result = types.SimpleNamespace(observations=[types.SimpleNamespace(config=seen, objectives=[-0.5, 1.0])])
        hist = _openbox_history_to_history(result, trials)
        assert len(hist.trials) == 1 and hist.trials[0].elapsed == 3.25
