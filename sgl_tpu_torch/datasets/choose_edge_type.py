"""NARS relation-subset selection — counterpart of
``sgl_tpu/datasets/choose_edge_type.py``.

Edge types are ``src__rel__dst`` strings.  :func:`choose_edge_type` picks a
random connected relation subset anchored at the predict class;
:func:`choose_multi_subgraphs` samples distinct subsets with a
coupon-collector bound on retries.  The draws come from
``np.random.default_rng(seed)`` in ``sgl_tpu``'s order, and the candidates
are listed in the same set order, so in one process both packages choose
the same subsets from the same seed.
"""

from __future__ import annotations

import math
import warnings
from typing import List, Sequence, Tuple

import numpy as np


def edge_type_endpoints(edge_type: str) -> Tuple[str, str]:
    parts = edge_type.split("__")
    return parts[0], parts[-1]


def remove_duplicate_edge_types(edge_types: Sequence[str]) -> List[str]:
    """Drop reversed duplicates (``paper__x__author`` after ``author__y__paper``)."""
    unique: List[str] = []
    seen_pairs = set()
    for et in edge_types:
        s, d = edge_type_endpoints(et)
        if (d, s) in seen_pairs:
            continue
        seen_pairs.add((s, d))
        unique.append(et)
    return unique


def choose_edge_type(
    edge_type_num: int,
    edge_types: Sequence[str],
    predict_class: str,
    rng: np.random.Generator,
) -> Tuple[str, ...]:
    """A random connected relation subset touching ``predict_class``,
    sorted; shorter (with a warning) when the schema runs out."""
    explored = {predict_class}
    chosen: List[str] = []
    candidates: List[str] = []
    others = set(edge_types)
    for _ in range(edge_type_num):
        # a set's order, as in sgl_tpu: in one process both packages list the
        # candidates alike (across processes it follows PYTHONHASHSEED)
        movable = [et for et in others if set(edge_type_endpoints(et)) & explored]
        candidates += movable
        others -= set(movable)
        if not candidates:
            warnings.warn(f"Can't find enough ({edge_type_num}) edge types!", UserWarning)
            break
        pick = candidates[int(rng.integers(len(candidates)))]
        chosen.append(pick)
        candidates.remove(pick)
        explored |= set(edge_type_endpoints(pick))
    return tuple(sorted(chosen))


def _combination(n: int, k: int) -> int:
    if n < 0 or k < 0:
        raise ValueError("n < 0 or k < 0!")
    result = 1
    for i in range(k):
        result = result * (n - i) // (i + 1)
    return result


def choose_multi_subgraphs(
    subgraph_num: int,
    edge_type_num: int,
    edge_types: Sequence[str],
    predict_class: str,
    seed: int = 42,
) -> List[Tuple[str, ...]]:
    """``subgraph_num`` distinct relation subsets of ``edge_type_num``
    types; fewer, with a warning, when the retry bound runs out."""
    rng = np.random.default_rng(seed)
    out: List[Tuple[str, ...]] = []
    unique = remove_duplicate_edge_types(edge_types)
    if edge_type_num > len(unique):
        return out
    total = _combination(len(unique), edge_type_num)
    max_steps = 10 * total * (math.log2(total) + 1) if total > 0 else 0
    steps = 0
    for _ in range(subgraph_num):
        while True:
            steps += 1
            if steps > max_steps:
                warnings.warn(f"Can't find enough ({subgraph_num}) subgraphs!", UserWarning)
                break
            combo = choose_edge_type(edge_type_num, unique, predict_class, rng)
            if combo in out:
                continue
            if combo:
                out.append(combo)
            break
    return out


# reference-style aliases
ChooseEdgeType = choose_edge_type
ChooseMultiSubgraphs = choose_multi_subgraphs
