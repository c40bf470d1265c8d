"""The component inventory of ``tests/test_parity_inventory.py``, held
against the port (``sgl_tpu_torch``).

Each test of that file has its counterpart here under the same name, with
the same names asserted in the port's modules, minus ``BY_DESIGN``: names
the port does not have because they are JAX's or the TPU's; each is checked
absent, beside the port's counterpart.  Every script of ``examples/`` has
its module in ``sgl_tpu_torch/examples``.

The distributed runtime's TPU devices, dropped by design, are checked absent
from the port's signatures too.

Below the module names, the class members: for every module of ``sgl_tpu``
with a counterpart file in the port, every public method and property
that a class of ``sgl_tpu`` defines (in its own ``sgl_tpu`` classes, not in
Flax's or the standard library's) is on the port's class of the same name
(``hasattr``, so that inheritance counts), minus ``BY_DESIGN_MEMBERS``.
"""

import importlib
import inspect
import os
import pathlib

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name in sgl_tpu -> (port module, the port's counterpart, why)
BY_DESIGN = {
    ("sgl_tpu.kernels", "spmm_pallas"): ("sgl_tpu_torch.kernels", "spmm_csr", "the TPU chunk layout's product"),
    ("sgl_tpu.kernels", "spmm_pallas_streaming"): ("sgl_tpu_torch.kernels", "spmm_csr_streaming", "ditto, by parts"),
    ("sgl_tpu.kernels", "prepare_chunked"): ("sgl_tpu_torch.kernels", "prepare_csr", "the TPU chunk layout"),
    ("sgl_tpu.kernels", "prepare_chunked_parts"): ("sgl_tpu_torch.kernels", "prepare_csr_parts", "ditto, by parts"),
    ("sgl_tpu.kernels", "ChunkedAdj"): ("sgl_tpu_torch.kernels", "CsrAdj", "the TPU chunk layout"),
    ("sgl_tpu.kernels", "ChunkedPart"): ("sgl_tpu_torch.kernels", "CsrPart", "ditto, one part"),
    ("sgl_tpu.tasks.utils", "init_train_state"): ("sgl_tpu_torch.tasks.utils", "make_train_step",
                                                  "JAX train state; the port's modules and optimizer hold it"),
    ("sgl_tpu.utils", "xla_trace"): ("sgl_tpu_torch.utils", "torch_trace", "XLA's profiler"),
    ("sgl_tpu.tasks.utils", "TrainState"): ("sgl_tpu_torch.tasks.utils", "make_train_step",
                                            "JAX train state; the port's modules and optimizer hold it"),
}

# examples/ scripts -> the port's example module
EXAMPLES = {
    "test_nas.py": "nas.py",
    "test_nas_dist.py": "nas_dist.py",
    "test_nodeclass_dist.py": "nodeclass_dist.py",
    "products_scale_demo.py": "products_scale_demo.py",
    "papers100m_pipeline.py": "papers100m_pipeline.py",
    "sgc_pubmed.py": "sgc_pubmed.py",
    "gamlp_products.py": "gamlp_products.py",
    "nafs_link_predict.py": "nafs_link_predict.py",
    "nafs_node_cluster.py": "nafs_node_cluster.py",
    "hetero_nars.py": "hetero_nars.py",
    "graph_classification.py": "graph_classification.py",
    "reproduce_accuracy.py": "reproduce_accuracy.py",
}

_EXCEPTED = {(m.replace("sgl_tpu", "sgl_tpu_torch", 1), n) for m, n in BY_DESIGN}

# class members of sgl_tpu the port does not have, or has with another
# signature: member -> (on the port's class?, why)
BY_DESIGN_MEMBERS = {
    "tree_flatten": (False, "JAX's pytree registration; the port's containers are plain dataclasses"),
    "tree_unflatten": (False, "ditto"),
    "parent": (False, "the Flax module's parent scope, a field Flax adds to every module; torch's "
                      "nn.Module has no parent link"),
    "init": (True, "Flax's init(rng, ...) returns the parameters; the port's init(generator=None) "
                   "re-draws the module's own parameters in place"),
}
# sgl_tpu modules with no counterpart file in the port -> why
NO_COUNTERPART = {
    "sgl_tpu.kernels.pallas_spmm": "the TPU chunk layout and its Pallas kernels (BY_DESIGN's names); "
                                   "the port's CSR kernel is sgl_tpu_torch/kernels/spmm_csr.py",
    "sgl_tpu.utils.compile_cache": "XLA's persistent compilation cache (sgl_tpu_torch/utils/__init__.py)",
}
JAX_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in (pathlib.Path(ROOT) / "sgl_tpu").rglob("*.py")
)
PORTED_MODULES = [m for m in JAX_MODULES if m not in NO_COUNTERPART]


def _public_members(cls) -> dict:
    """Public methods and properties (any descriptor: functions, static and
    class methods, properties, Flax's wrapped ones) that ``cls`` and its
    ``sgl_tpu`` bases define, by name."""
    out = {}
    for base in reversed(cls.__mro__):
        if not base.__module__.startswith("sgl_tpu."):
            continue
        for name, value in vars(base).items():
            if not name.startswith("_") and hasattr(type(value), "__get__") and not inspect.isclass(value):
                out[name] = value
    return out


def _classes(module: str):
    """``(name, sgl_tpu's class, the port's class or None)`` for each public
    class that ``module`` defines, bar ``BY_DESIGN``'s."""
    mod = importlib.import_module(module)
    port = importlib.import_module(module.replace("sgl_tpu", "sgl_tpu_torch", 1))
    for name, cls in sorted(vars(mod).items()):
        if name.startswith("_") or not inspect.isclass(cls) or cls.__module__ != module:
            continue
        if (port.__name__, name) not in _EXCEPTED:
            yield name, cls, getattr(port, name, None)


def _has(module: str, *names: str):
    """``names`` in the port's ``module``, less the by-design ones."""
    mod = importlib.import_module(module)
    names = [n for n in names if (module, n) not in _EXCEPTED]
    missing = [n for n in names if not hasattr(mod, n)]
    assert not missing, f"{module} missing {missing}"


@pytest.mark.parametrize("key", sorted(BY_DESIGN), ids=lambda k: f"{k[0]}.{k[1]}")
def test_not_ported_by_design(key):
    jax_module, name = key
    module, counterpart, _why = BY_DESIGN[key]
    mod = importlib.import_module(module)
    assert not hasattr(mod, name), f"{module}.{name} exists: move it out of BY_DESIGN"
    assert hasattr(mod, counterpart), f"{module}.{counterpart} missing"


def test_2_1_native_kernels():
    _has("sgl_tpu_torch.kernels", "spmm", "sddmm", "spmm_segment", "spmm_pallas", "spmm_pallas_streaming",
         "prepare_chunked", "prepare_chunked_parts", "set_default_backend", "SparseAdj", "ChunkedAdj",
         "ChunkedPart")
    _has("sgl_tpu_torch.graph.native", "native_available", "sort_edges_by_dst", "compute_degrees",
         "normalized_weights", "build_normalized_adj_host", "load_csv_native")


def test_2_2_graph_ops():
    _has("sgl_tpu_torch.ops", "GraphOp", "LaplacianGraphOp", "PprGraphOp", "k_hop_propagate")
    _has("sgl_tpu_torch.graph", "symmetric_normalized_weights", "symmetric_normalized_weights_host",
         "ppr_weights", "ppr_weights_host", "row_normalized_weights")


def test_2_3_message_ops():
    _has("sgl_tpu_torch.ops", "MessageOp", "LastMessageOp", "SumMessageOp", "MeanMessageOp", "MaxMessageOp",
         "MinMessageOp", "ConcatMessageOp", "ProjectedConcatMessageOp", "SimpleWeightedMessageOp",
         "LearnableWeightedMessageOp", "IterateLearnableWeightedMessageOp", "OverSmoothDistanceWeightedOp")
    from sgl_tpu_torch.ops import LearnableWeightedMessageOp

    for kind in ("simple", "simple_allow_neg", "gate", "ori_ref", "jk"):
        LearnableWeightedMessageOp(0, 4, kind, prop_steps=3, feat_dim=8)


def test_2_4_data_structures():
    _has("sgl_tpu_torch.graph", "Graph", "HeteroGraph", "Node", "Edge", "from_scipy", "to_scipy")
    _has("sgl_tpu_torch.datasets", "NodeDataset", "HeteroNodeDataset", "random_split")
    _has("sgl_tpu_torch.datasets.base", "GraphDataset")
    _has("sgl_tpu_torch.graph", "GraphBatch", "batch_graphs")
    _has("sgl_tpu_torch.models", "GraphLevelSGAPModel", "GraphSGC", "GraphSIGN", "segment_readout")
    _has("sgl_tpu_torch.tasks", "GraphClassification")
    from sgl_tpu_torch.datasets.base import HeteroNodeDataset as H

    for m in ("sample_by_edge_type", "sample_by_meta_path", "nars_preprocess"):
        assert hasattr(H, m), m
    _has("sgl_tpu_torch.graph", "random_drop_edges", "biased_drop_edges", "random_drop_nodes", "drop_edges",
         "add_edges", "delete_repeated_edges", "mask_features", "get_subgraph", "sort_edges", "add_self_loops",
         "remove_self_loops")
    _has("sgl_tpu_torch.datasets", "choose_edge_type", "choose_multi_subgraphs", "remove_duplicate_edge_types")


def test_2_5_datasets():
    _has("sgl_tpu_torch.datasets", "Planetoid", "Nell", "Ogbn", "Reddit", "Flickr", "AmazonProduct", "Amazon",
         "Coauthor", "Actor", "WebKB", "Airports", "Twitch", "Facebook", "Github", "Wikics", "LINKXDataset",
         "KarateClub", "OgbnMag", "Acm", "Dblp", "DblpOriginal", "Imdb", "Aminer", "Custom_Homo",
         "Custom_Hetero", "PlantedPartition")
    _has("sgl_tpu_torch.datasets.utils", "download_to", "pkl_read_file", "read_npz")


def test_2_6_models():
    _has("sgl_tpu_torch.models", "SGAPModel", "SGAPNet", "HeteroSGAPModel", "FastHeteroSGAPModel", "SGC", "SIGN",
         "SSGC", "GBP", "GAMLP", "GAMLPRecursive", "NAFS", "PASCA_V1", "PASCA_V2", "PASCA_V3", "SGCDist",
         "GAMLPDist", "NARS_SIGN", "Fast_NARS_SGC_WithLearnableWeights", "IdenticalMapping",
         "LogisticRegression", "MultiLayerPerceptron", "ResMultiLayerPerceptron", "OneDimConvolution",
         "OneDimConvolutionWeightSharedAcrossFeatures", "FastOneDimConvolution")


def test_2_7_tasks():
    _has("sgl_tpu_torch.tasks", "NodeClassification", "HeteroNodeClassification", "NodeClustering",
         "NodeClusteringNAFS", "LinkPredictionGAE", "LinkPredictionNAFS",
         "NodeClassification_With_CorrectAndSmooth", "NodeClassificationWithLabelUse", "NodeClassificationDist",
         "mask_test_edges")
    _has("sgl_tpu_torch.tasks.utils", "set_seed", "accuracy", "add_labels", "adam_l2", "init_train_state")
    _has("sgl_tpu_torch.tasks.clustering_metrics", "clustering_metrics")


def test_2_8_tricks_and_nas():
    _has("sgl_tpu_torch.tricks", "CorrectAndSmooth", "label_propagation", "loge_cross_entropy_loss",
         "loge_bce_loss")
    _has("sgl_tpu_torch.search", "ConfigManager", "SearchModel", "SearchManager", "run_nas", "RandomSearch",
         "EvolutionarySearch", "SearchManagerDist", "SearchModelDist", "ConfigManagerDist")
    _has("sgl_tpu_torch.etc.auto_select_edge_type_for_nars", "select_top_subgraphs",
         "subgraph_weight_stability", "hetero_search")
    _has("sgl_tpu_torch.utils", "GpuWithMaxFreeMem", "device_with_max_free_mem")


def test_2_9_parallelism():
    _has("sgl_tpu_torch.parallel", "make_mesh", "data_sharding", "replicated", "partition_adj",
         "partition_adj_chunked", "make_dist_spmm", "k_hop_propagate_dist", "make_parallel_train_step",
         "replicate_state")


def test_2_9_parallelism_drops_the_tpu_devices():
    """The ring's TPU devices are gone by design: the tile chunks and their
    cost model, empty-tile skipping, the measured pick, interpret mode."""
    from sgl_tpu_torch.parallel import DistChunkedAdj, k_hop_propagate_dist, make_dist_spmm, partition_adj_chunked
    from sgl_tpu_torch.tasks import NodeClassificationDist

    params = inspect.signature(partition_adj_chunked).parameters
    for name in ("chunk", "tile_rows", "skip_empty_tiles", "feat_dim", "feat_dtype", "measure"):
        assert name not in params, name
    for fn in (k_hop_propagate_dist, make_dist_spmm):
        assert "interpret" not in inspect.signature(fn).parameters
    fields = {f for f in DistChunkedAdj.__dataclass_fields__}
    assert not fields & {"chunk_tile", "tile_rows", "tile_mask"}
    assert not hasattr(NodeClassificationDist, "_chunked_partition_kwargs")


def test_5_auxiliary_subsystems():
    _has("sgl_tpu_torch.utils", "StageTimer", "slope_time", "xla_trace")
    _has("sgl_tpu_torch.utils", "HopCheckpointer", "save_train_state", "load_train_state", "save_pytree",
         "load_pytree")
    _has("sgl_tpu_torch.utils", "TrainConfig", "MeshConfig")


def test_every_module_has_a_counterpart_or_a_reason():
    """Each ``sgl_tpu`` module has its file in the port, or is in
    ``NO_COUNTERPART`` (and then has none)."""
    for module in JAX_MODULES:
        rel = pathlib.Path(*module.split(".")[1:])
        exists = (pathlib.Path(ROOT) / "sgl_tpu_torch" / rel).with_suffix(".py").exists() or (
            pathlib.Path(ROOT) / "sgl_tpu_torch" / rel / "__init__.py").exists()
        assert exists != (module in NO_COUNTERPART), module


@pytest.mark.parametrize("module", PORTED_MODULES)
def test_class_members(module):
    """Every public method and property of ``module``'s classes is on the
    port's class, bar ``BY_DESIGN_MEMBERS``."""
    classes = list(_classes(module))
    assert not [name for name, _, port_cls in classes if port_cls is None], "classes missing from the port"
    missing = [f"{name}.{member}" for name, cls, port_cls in classes
               for member in _public_members(cls)
               if member not in BY_DESIGN_MEMBERS and not hasattr(port_cls, member)]
    assert not missing, f"the port lacks {missing}"


@pytest.mark.parametrize("member", sorted(BY_DESIGN_MEMBERS))
def test_members_by_design(member):
    """Each excepted member occurs on some ``sgl_tpu`` class with a port
    counterpart, and is on the port's class exactly when its entry says so;
    the present ones take other arguments than ``sgl_tpu``'s."""
    present, _why = BY_DESIGN_MEMBERS[member]
    seen = 0
    for module in PORTED_MODULES:
        for name, cls, port_cls in _classes(module):
            if member not in _public_members(cls):
                continue
            seen += 1
            assert hasattr(port_cls, member) == present, f"{module}.{name}.{member}"
            if present:
                theirs = inspect.signature(getattr(cls, member)).parameters
                ours = inspect.signature(getattr(port_cls, member)).parameters
                assert list(theirs) != list(ours), f"{module}.{name}.{member}: the same signature"
    assert seen, f"{member}: no sgl_tpu class has it; drop it from BY_DESIGN_MEMBERS"


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_examples_parity(name):
    """Every example script of ``examples/`` that the port has covered has
    its module in ``sgl_tpu_torch/examples``."""
    assert name in os.listdir(os.path.join(ROOT, "examples"))
    assert EXAMPLES[name] in os.listdir(os.path.join(ROOT, "sgl_tpu_torch", "examples"))


def test_examples_cover_every_script():
    """``EXAMPLES`` names every script of ``examples/``."""
    scripts = sorted(f for f in os.listdir(os.path.join(ROOT, "examples")) if f.endswith(".py"))
    assert scripts == sorted(EXAMPLES)
