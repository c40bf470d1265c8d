"""The port stands alone: ``sgl_tpu_torch`` and ``chip_smoke.py`` import
nothing of JAX, Flax, Optax, ``sgl_tpu`` or the JAX harnesses in ``dev/``,
and importing the package needs no CUDA."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SUBPACKAGES = ("datasets", "dev", "examples", "graph", "kernels", "models", "ops", "tasks", "utils")
MODULES = [
    "sgl_tpu_torch", "sgl_tpu_torch.convert", "sgl_tpu_torch.kernels._build",
    "sgl_tpu_torch.examples.products_scale_demo", "sgl_tpu_torch.dev.exp_spmm",
    "sgl_tpu_torch.dev.exp_gather_dma", "sgl_tpu_torch.dev.exp_acc_alias",
] + [
    f"sgl_tpu_torch.{p}" for p in SUBPACKAGES
]
# word-bounded: ``sgl_tpu_torch`` is not ``sgl_tpu``; ``dev`` and ``exp_*``
# are the JAX harnesses, which the port's ``sgl_tpu_torch.dev`` replaces
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|flax|optax|sgl_tpu|dev|exp_\w+)\b", re.M)
SOURCES = sorted((ROOT / "sgl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_pulls_in_no_jax_or_reference():
    # a fresh interpreter: this test process has JAX loaded by conftest
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'sgl_tpu'))\n"
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
