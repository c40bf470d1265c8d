"""The port stands alone: ``sgl_tpu_torch`` and ``chip_smoke.py`` import
nothing of JAX, Flax, Optax, ``sgl_tpu``, the JAX harnesses in ``dev/``,
scikit-learn, matplotlib, ml_dtypes or networkx (the card's machine has
none of the four), and importing the package needs no CUDA."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SUBPACKAGES = ("datasets", "dev", "etc", "examples", "graph", "kernels", "models", "ops", "parallel", "search", "tasks",
               "tricks", "utils")
MODULES = [
    "sgl_tpu_torch", "sgl_tpu_torch.convert", "sgl_tpu_torch.kernels._build",
    "sgl_tpu_torch.examples.products_scale_demo", "sgl_tpu_torch.dev.exp_spmm",
    "sgl_tpu_torch.dev.exp_gather_dma", "sgl_tpu_torch.dev.exp_acc_alias",
    "sgl_tpu_torch.dev.tune_spmm_csr", "sgl_tpu_torch.dev.tune_segment_reduce", "sgl_tpu_torch.dev.ooc_probe",
    "sgl_tpu_torch.graph.native", "sgl_tpu_torch.graph.transforms", "sgl_tpu_torch.datasets.planetoid",
    "sgl_tpu_torch.datasets.utils", "sgl_tpu_torch.models.homo", "sgl_tpu_torch.ops.message_ops",
    "sgl_tpu_torch.kernels.sparse", "sgl_tpu_torch.tasks.utils", "sgl_tpu_torch.tricks.utils",
    "sgl_tpu_torch.tricks.correct_and_smooth", "sgl_tpu_torch.tasks.correct_and_smooth",
    "sgl_tpu_torch.tasks.node_classification_with_label_use", "sgl_tpu_torch.tasks.inference",
    "sgl_tpu_torch.tasks.clustering_metrics", "sgl_tpu_torch.tasks.node_clustering",
    "sgl_tpu_torch.tasks.link_prediction", "sgl_tpu_torch.graph.batch", "sgl_tpu_torch.datasets.choose_edge_type",
    "sgl_tpu_torch.datasets.hetero_datasets", "sgl_tpu_torch.datasets.tu_dataset", "sgl_tpu_torch.models.hetero",
    "sgl_tpu_torch.models.graph_level", "sgl_tpu_torch.tasks.hetero_node_classification",
    "sgl_tpu_torch.tasks.graph_classification", "sgl_tpu_torch.etc.auto_select_edge_type_for_nars",
    "sgl_tpu_torch.kernels.spmm_ooc", "sgl_tpu_torch.utils.hop_store", "sgl_tpu_torch.examples.papers100m_pipeline",
    "sgl_tpu_torch.search.base_search", "sgl_tpu_torch.search.search_models", "sgl_tpu_torch.search.prop_cache",
    "sgl_tpu_torch.search.auto_search", "sgl_tpu_torch.search.search_config", "sgl_tpu_torch.search.smbo",
    "sgl_tpu_torch.datasets.ogbn", "sgl_tpu_torch.utils.checkpoint", "sgl_tpu_torch.utils.profiling",
    "sgl_tpu_torch.utils.device", "sgl_tpu_torch.examples.nas",
    "sgl_tpu_torch.parallel.mesh", "sgl_tpu_torch.parallel.spmm_dist", "sgl_tpu_torch.parallel.train_dist",
    "sgl_tpu_torch.tasks.node_classification_dist", "sgl_tpu_torch.search.auto_search_dist",
    "sgl_tpu_torch.dev.dist_worker", "sgl_tpu_torch.examples.nodeclass_dist", "sgl_tpu_torch.examples.nas_dist",
    "sgl_tpu_torch.datasets.npz_datasets", "sgl_tpu_torch.datasets.web_datasets", "sgl_tpu_torch.datasets.custom",
    "sgl_tpu_torch.datasets.raw_files", "sgl_tpu_torch.examples.sgc_pubmed", "sgl_tpu_torch.examples.gamlp_products",
    "sgl_tpu_torch.examples.hetero_nars", "sgl_tpu_torch.examples.graph_classification",
    "sgl_tpu_torch.examples.nafs_link_predict", "sgl_tpu_torch.examples.nafs_node_cluster",
    "sgl_tpu_torch.examples.reproduce_accuracy", "sgl_tpu_torch.tasks.tsne", "sgl_tpu_torch.utils.figure",
    "chip_smoke",
] + [
    f"sgl_tpu_torch.{p}" for p in SUBPACKAGES
]
# the top-level packages the port never imports (openbox: only inside the
# search functions that use it)
NEVER = ("jax", "flax", "optax", "sgl_tpu", "sklearn", "matplotlib", "ml_dtypes", "networkx", "openbox")
# word-bounded: ``sgl_tpu_torch`` is not ``sgl_tpu``; ``dev`` and ``exp_*``
# are the JAX harnesses, which the port's ``sgl_tpu_torch.dev`` replaces
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|flax|optax|sgl_tpu|sklearn|matplotlib|ml_dtypes|networkx|dev|exp_\w+)\b", re.M
)
SOURCES = sorted((ROOT / "sgl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_pulls_in_no_jax_or_reference():
    # a fresh interpreter: this test process has JAX loaded by conftest
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {NEVER!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax_or_reference(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, hits


def test_forbidden_pattern_is_word_bounded():
    assert FORBIDDEN.search("from sgl_tpu.graph import Graph")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert not FORBIDDEN.search("from sgl_tpu_torch.graph import Graph")
    assert not FORBIDDEN.search("import jaxlib_free_module")
    assert FORBIDDEN.search("from dev.exp_spmm import build_factored")
    assert FORBIDDEN.search("import dev.exp_gather_dma")
    assert FORBIDDEN.search("from exp_spmm import run_micro9")
    assert not FORBIDDEN.search("from sgl_tpu_torch.dev import exp_spmm")
    assert not FORBIDDEN.search("import devices")
    assert FORBIDDEN.search("from sklearn.cluster import KMeans")
    assert FORBIDDEN.search("    import matplotlib.pyplot as plt")
    assert not FORBIDDEN.search("import sklearn_like")
    assert FORBIDDEN.search("import ml_dtypes")
    assert FORBIDDEN.search("        import networkx as nx")
    assert not FORBIDDEN.search("        from openbox import Optimizer")  # optional, inside a function


def test_optional_openbox_is_imported_only_inside_functions():
    """``search/`` reaches OpenBox only from inside the functions that
    drive it: no module-level import."""
    for path in sorted((ROOT / "sgl_tpu_torch" / "search").glob("*.py")):
        top = re.findall(r"^(?:import|from)\s+openbox\b", path.read_text(), re.M)
        assert not top, path
