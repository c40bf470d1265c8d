"""How ``nars_fixture.json``'s inputs enter the program: a
``HeteroNodeDataset`` over a ``HeteroGraph`` built from them, with no file
read or written, and the task's fixed relation subsets, each sampled once
from that dataset (``subgraph_list``), as NARS's published runs fix
theirs."""

from __future__ import annotations


def dataset(cfg: dict, inputs):
    from sgl_tpu_torch.datasets.base import HeteroNodeDataset
    from sgl_tpu_torch.graph.graph import HeteroGraph

    class BenchHeteroDataset(HeteroNodeDataset):
        def _raw_exists(self) -> bool:
            return True

        def _process(self):
            edges = {tuple(rel.split("__")): pair for rel, pair in inputs.edges.items()}
            return HeteroGraph.build(dict(inputs.node_counts), edges, x_dict=dict(inputs.x),
                                     y_dict={inputs.predict_class: inputs.y})

        def _split(self) -> None:
            self.train_idx, self.val_idx, self.test_idx = inputs.train_idx, inputs.val_idx, inputs.test_idx

        @property
        def num_classes(self) -> int:
            return int(cfg["num_classes"])

    return BenchHeteroDataset("bench_hetero", root="unused", use_cache=False)


def task_args(cfg: dict, ds) -> dict:
    return {"subgraph_list": [(tuple(s), ds.sample_by_edge_type(s)) for s in cfg["subsets"]]}
