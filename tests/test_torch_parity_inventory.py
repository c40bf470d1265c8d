"""The component inventory of ``tests/test_parity_inventory.py``, held
against the port (``sgl_tpu_torch``).

Each test of that file has its counterpart here under the same name, with
the same names asserted in the port's modules, minus ``BY_DESIGN``: names
the port does not have because they are JAX's or the TPU's; each is checked
absent, beside the port's counterpart.  Every script of ``examples/`` has
its module in ``sgl_tpu_torch/examples``.

The distributed runtime's TPU devices, dropped by design, are checked absent
from the port's signatures too.
"""

import importlib
import inspect
import os

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
