"""NARS relation-subset studies — counterpart of
``sgl_tpu/etc/auto_select_edge_type_for_nars.py``: briefly train Fast NARS
with learnable subgraph weights, read the learned weights and keep the
top-k subgraphs; the weights' stability across seeds; a grid over subset
counts and sizes.  Each study runs its tasks on ``device`` (default: the
GPU).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from sgl_tpu_torch.models.hetero import Fast_NARS_SGC_WithLearnableWeights
from sgl_tpu_torch.tasks.hetero_node_classification import HeteroNodeClassification


def select_top_subgraphs(
    dataset,
    predict_class: str,
    random_subgraph_num: int,
    subgraph_edge_type_num: int,
    top_k: int,
    feat_dim: int,
    output_dim: int,
    probe_epochs: int = 20,
    hidden_dim: int = 64,
    prop_steps: int = 2,
    seed: int = 42,
    device=None,
) -> Tuple[List[Tuple[str, ...]], np.ndarray]:
    """``(top_k subgraph combos, their learned weights)``, heaviest first.
    ``seed`` draws the subsets; the probe task keeps its default seed."""
    subgraph_dict = dataset.nars_preprocess(
        dataset.edge_types, predict_class, random_subgraph_num, subgraph_edge_type_num, seed=seed
    )
    subgraph_list = list(subgraph_dict.items())
    model = Fast_NARS_SGC_WithLearnableWeights(
        prop_steps=prop_steps,
        feat_dim=feat_dim,
        output_dim=output_dim,
        hidden_dim=hidden_dim,
        num_layers=2,
        random_subgraph_num=len(subgraph_list),
    )
    task = HeteroNodeClassification(
        dataset,
        predict_class,
        model,
        lr=0.05,
        weight_decay=5e-5,
        epochs=probe_epochs,
        device=device,
        subgraph_list=subgraph_list,
        record_subgraph_weight=True,
        verbose=False,
    )
    weights = np.asarray(task.subgraph_weight)
    order = np.argsort(-weights)[:top_k]
    return [subgraph_list[i][0] for i in order], weights[order]


def subgraph_weight_stability(dataset, predict_class: str, runs: int = 3, **kw) -> np.ndarray:
    """The top-k learned weights of :func:`select_top_subgraphs` for
    subset seeds ``42 .. 42 + runs - 1``, stacked ``(runs, top_k)``."""
    return np.stack([
        select_top_subgraphs(dataset, predict_class, seed=42 + s, **kw)[1] for s in range(runs)
    ])


def hetero_search(
    dataset,
    predict_class: str,
    subgraph_configs,
    feat_dim: int,
    output_dim: int,
    epochs: int = 30,
    hidden_dim: int = 64,
    prop_steps: int = 2,
    seed: int = 42,
    device=None,
):
    """Grid over ``(random_subgraph_num, subgraph_edge_type_num)`` configs:
    ``{config: best-val test accuracy}``."""
    results = {}
    for cfg in subgraph_configs:
        n_sub, n_et = cfg
        model = Fast_NARS_SGC_WithLearnableWeights(
            prop_steps=prop_steps,
            feat_dim=feat_dim,
            output_dim=output_dim,
            hidden_dim=hidden_dim,
            num_layers=2,
            random_subgraph_num=n_sub,
        )
        task = HeteroNodeClassification(
            dataset,
            predict_class,
            model,
            lr=0.05,
            weight_decay=5e-5,
            epochs=epochs,
            device=device,
            random_subgraph_num=n_sub,
            subgraph_edge_type_num=n_et,
            seed=seed,
            verbose=False,
        )
        results[tuple(cfg)] = task.test_acc
    return results
