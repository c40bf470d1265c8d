"""Built-in multi-objective search drivers — counterpart of
``sgl_tpu/search/smbo.py``, numpy only, drawing from
``np.random.default_rng(seed)`` in ``sgl_tpu``'s order, so both packages
choose the same architectures from the same seed:

* ``RandomSearch``: uniform sampling of the space;
* ``EvolutionarySearch``: mutate one coordinate of a random Pareto-front
  parent (after ``init_random`` uniform samples);
* ``run_sha``: successive halving over random architectures.

Each keeps the Pareto front of the ``(-acc, time)`` pair, the reference's
two-objective formulation.  ``run_nas`` takes OpenBox's SMBO when it is
installed (imported inside the functions only) and the evolutionary search
otherwise.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from sgl_tpu_torch.search.search_config import ARCH_KEYS, ConfigManager


@dataclass
class Trial:
    config: Dict[str, int]
    objs: np.ndarray  # [-acc, time]
    elapsed: float


@dataclass
class History:
    trials: List[Trial] = field(default_factory=list)

    def add(self, config, objs, elapsed):
        self.trials.append(Trial(dict(config), np.asarray(objs), elapsed))

    def pareto_front(self) -> List[Trial]:
        front = []
        for t in self.trials:
            dominated = any(
                (o.objs <= t.objs).all() and (o.objs < t.objs).any()
                for o in self.trials
            )
            if not dominated:
                front.append(t)
        return front

    @property
    def best_accuracy_trial(self) -> Optional[Trial]:
        if not self.trials:
            return None
        return min(self.trials, key=lambda t: t.objs[0])

    def summary(self) -> str:
        best = self.best_accuracy_trial
        lines = [f"{len(self.trials)} trials, pareto front size {len(self.pareto_front())}"]
        if best is not None:
            lines.append(
                f"best acc {-best.objs[0]:.4f} (time {best.objs[1]:.3f}s) @ {best.config}"
            )
        return "\n".join(lines)


class RandomSearch:
    def __init__(self, configer: ConfigManager, seed: int = 0):
        self.configer = configer
        self.rng = np.random.default_rng(seed)

    def suggest(self, history: History) -> Dict[str, int]:
        return self.configer.sample(self.rng)


class EvolutionarySearch:
    """Mutate one coordinate of a random Pareto-front parent."""

    def __init__(self, configer: ConfigManager, seed: int = 0, init_random: int = 5):
        self.configer = configer
        self.rng = np.random.default_rng(seed)
        self.init_random = init_random

    def suggest(self, history: History) -> Dict[str, int]:
        if len(history.trials) < self.init_random:
            return self.configer.sample(self.rng)
        front = history.pareto_front()
        parent = front[int(self.rng.integers(len(front)))].config
        child = dict(parent)
        key = ARCH_KEYS[int(self.rng.integers(len(ARCH_KEYS)))]
        lo, hi = self.configer.ranges[key]
        child[key] = int(self.rng.integers(lo, hi + 1))
        return child


def run_sha(
    configer: ConfigManager,
    n_configs: int = 27,
    eta: int = 3,
    min_epochs: int = 10,
    seed: int = 0,
    verbose: bool = True,
    objective: Optional[Callable] = None,
) -> History:
    """Successive-halving NAS (beyond the reference, whose SMBO trains every
    sampled architecture at the full epoch budget).

    Rung 0 trains ``n_configs`` random architectures for ``min_epochs``
    epochs; each subsequent rung keeps the top ``1/eta`` by accuracy and
    multiplies the epoch budget by ``eta``.  Total compute is
    ``O(n_configs · min_epochs · log_eta(n_configs))`` — for equal wall
    clock this evaluates ~``eta×`` more architectures than flat search,
    which matters when each trial re-runs the SGAP precompute.

    ``objective(config, epochs=...)`` defaults to the configer's
    ``_configFunction`` with its epoch budget overridden per rung.
    """
    rng = np.random.default_rng(seed)
    if objective is None:
        def objective(config, epochs):
            saved = configer._epochs
            configer._epochs = epochs
            try:
                return configer._configFunction(config)
            finally:
                configer._epochs = saved

    history = History()
    configs = [configer.sample(rng) for _ in range(n_configs)]
    epochs = min_epochs
    rung = 0
    while configs:
        scored = []
        for config in configs:
            t0 = time.time()
            result = objective(config, epochs=epochs)
            elapsed = time.time() - t0
            history.add(config, result["objs"], elapsed)
            scored.append((result["objs"][0], config))
            if verbose:
                objs = history.trials[-1].objs
                print(
                    f"rung {rung} ({epochs} epochs): acc={-objs[0]:.4f} "
                    f"time={objs[1]:.3f}s config={config}"
                )
        if len(configs) == 1:
            break
        scored.sort(key=lambda t: t[0])  # objs[0] = -acc: best first
        configs = [c for _, c in scored[: max(len(configs) // eta, 1)]]
        epochs *= eta
        rung += 1
    return history


def _openbox_optimizer_cls():
    """Resolve OpenBox's SMBO class across API generations.

    Adapter matrix (the argument names drift between releases):

    | openbox | class | objectives kwarg | objective return key |
    |---|---|---|---|
    | ≤ 0.7.x | ``openbox.optimizer.generic_smbo.SMBO`` | ``num_objs`` | ``objs`` |
    | ≥ 0.8   | ``openbox.Optimizer`` | ``num_objectives`` | ``objectives`` |

    Both drifts are handled structurally (constructor signature inspection;
    the wrapped objective returns BOTH keys), so an exact version pin is
    not needed.
    """
    try:
        from openbox import Optimizer  # type: ignore  # new API (>=0.8)

        return Optimizer
    except ImportError:
        from openbox.optimizer.generic_smbo import SMBO  # type: ignore

        return SMBO


def _openbox_history_to_history(result, fallback_trials) -> History:
    """Convert whatever ``bo.run()`` returned into our :class:`History`.

    New OpenBox: ``result.observations`` with ``.config``/``.objectives``;
    old OpenBox: ``result.configurations`` + ``result.perfs``.  When
    neither shape matches, fall back to the trials recorded by the wrapped
    objective (always available — the wrapper logs every call).  The
    wrapper also timed every call, so the recognized paths recover real
    per-trial ``elapsed`` by config lookup instead of recording 0.0
    (which would silently diverge from the built-in optimizers')."""
    def _cfg_val(v):
        # numbers compare as floats, so OpenBox's config dicts match the
        # wrapper's recorded ones across value types (2, 2.0,
        # np.float64(2)); bools stay apart from 0/1; anything else by repr
        if isinstance(v, bool):
            return ("b", v)
        if isinstance(v, (int, float, np.integer, np.floating)):
            return ("n", float(v))
        return ("r", repr(v))

    def _cfg_key(cfg):
        # canonical sorted items: hashable even for list-valued
        # hyperparameters AND drift-tolerant for numeric values
        return tuple(sorted((str(k), _cfg_val(v)) for k, v in cfg.items()))

    def _make_elapsed_of():
        by_cfg = {}
        for cfg, _objs, elapsed in fallback_trials:
            by_cfg.setdefault(_cfg_key(cfg), []).append(elapsed)

        def elapsed_of(cfg) -> float:
            lst = by_cfg.get(_cfg_key(cfg))
            return lst.pop(0) if lst else 0.0

        return elapsed_of

    elapsed_of = _make_elapsed_of()
    history = History()
    obs = getattr(result, "observations", None)
    if obs:
        for o in obs:
            cfg = getattr(o, "config", None)
            objs = getattr(o, "objectives", None)
            if objs is None:
                objs = getattr(o, "objs", None)
            if cfg is None or objs is None:
                break
            cfg = dict(cfg) if not hasattr(cfg, "get_dictionary") else cfg.get_dictionary()
            history.add(cfg, np.asarray(objs, float), elapsed_of(cfg))
        else:
            return history
        history = History()
        elapsed_of = _make_elapsed_of()  # the partial pass consumed entries
    configs = getattr(result, "configurations", None)
    perfs = getattr(result, "perfs", None)
    if configs is not None and perfs is not None:
        for cfg, objs in zip(configs, perfs):
            cfg = cfg.get_dictionary() if hasattr(cfg, "get_dictionary") else dict(cfg)
            history.add(cfg, np.asarray(objs, float), elapsed_of(cfg))
        return history
    for cfg, objs, elapsed in fallback_trials:
        history.add(cfg, objs, elapsed)
    return history


def run_nas(
    configer: ConfigManager,
    max_runs: int,
    optimizer: str = "auto",
    seed: int = 0,
    verbose: bool = True,
    objective: Optional[Callable] = None,
) -> History:
    """NAS driver: OpenBox SMBO when installed and requested, else built-ins.

    ``objective`` defaults to ``configer._configFunction``.  Always returns
    our :class:`History` (OpenBox results are converted), so downstream
    code — ``best_accuracy_trial``, ``pareto_front`` — is backend-agnostic.
    """
    objective = objective or configer._configFunction
    if optimizer == "auto":
        try:
            import openbox  # noqa: F401

            optimizer = "openbox"
        except ImportError:
            optimizer = "evolution"

    if optimizer == "openbox":
        import inspect

        cls = _openbox_optimizer_cls()
        recorded = []

        def objective_both_keys(config):
            """OpenBox calls this; old versions read ``objs``, new read
            ``objectives`` — return both, and record every call so the
            result converts even if the history type is unrecognized."""
            cfg = (
                config.get_dictionary()
                if hasattr(config, "get_dictionary")
                else dict(config)
            )
            t0 = time.time()
            result = objective(cfg)
            objs = np.asarray(
                result.get("objs", result.get("objectives")), float
            )
            recorded.append((cfg, objs, time.time() - t0))
            return {"objs": list(objs), "objectives": list(objs)}

        kwargs = dict(
            num_constraints=0,
            max_runs=max_runs,
            surrogate_type="prf",
            acq_type="ehvi",
            acq_optimizer_type="local_random",
            initial_runs=2 * (len(ARCH_KEYS) + 1),
            init_strategy="sobol",
            ref_point=[-1, 0.00001],
            task_id="sgl_tpu_torch_nas",
            random_state=seed,
        )
        try:
            params = inspect.signature(cls.__init__).parameters
        except (TypeError, ValueError):
            params = {}
        accepts_kwargs = any(
            p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()
        )
        # num_objs (<=0.7) vs num_objectives (>=0.8)
        if "num_objectives" in params:
            kwargs["num_objectives"] = 2
        elif "num_objs" in params or accepts_kwargs:
            kwargs["num_objs"] = 2
        else:
            kwargs["num_objectives"] = 2
        if params and not accepts_kwargs:
            kwargs = {k: v for k, v in kwargs.items() if k in params}
        bo = cls(objective_both_keys, configer._configSpace(), **kwargs)
        result = bo.run()
        return _openbox_history_to_history(result, recorded)

    sugg = (
        RandomSearch(configer, seed)
        if optimizer == "random"
        else EvolutionarySearch(configer, seed)
    )
    history = History()
    for i in range(max_runs):
        config = sugg.suggest(history)
        t0 = time.time()
        result = objective(config)
        history.add(config, result["objs"], time.time() - t0)
        if verbose:
            objs = history.trials[-1].objs
            print(
                f"trial {i + 1}/{max_runs}: acc={-objs[0]:.4f} "
                f"time={objs[1]:.3f}s config={config}"
            )
    return history
