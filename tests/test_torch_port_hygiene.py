"""Structural rules of the PyTorch port, checked from its sources.

- No module of `ragb_vae_tpu_torch` (nor `chip_smoke.py`) imports jax, flax
  or the JAX package. This is an AST scan: `sys.modules` cannot tell, since
  the test environment preloads jax at interpreter start.
- Every CUDA source names the TPU kernel it replaces and what bounds it on
  the card; the build targets sm_90a.
- Importing the whole package builds nothing and needs no CUDA toolkit.
"""
import ast
import importlib
import pkgutil
import re
from pathlib import Path

import pytest

import ragb_vae_tpu_torch

ROOT = Path(ragb_vae_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ragb_vae_tpu")
SOURCES = sorted(ROOT.rglob("*.py")) + [ROOT.parent / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT.parent)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_every_module_imports_without_a_toolkit():
    from ragb_vae_tpu_torch.ops.kernels import _build

    for info in pkgutil.walk_packages([str(ROOT)], prefix="ragb_vae_tpu_torch."):
        importlib.import_module(info.name)
    assert _build._lib is None  # nothing was compiled or loaded by importing


CU_FILES = sorted((ROOT / "csrc").glob("*.cu"))


def test_there_are_cuda_sources():
    assert {p.name for p in CU_FILES} >= {"resnet_block.cu", "flash_attention.cu"}


@pytest.mark.parametrize("path", CU_FILES, ids=lambda p: p.name)
def test_cuda_source_names_replaced_kernel_and_bound(path):
    text = path.read_text()
    assert "Replaces" in text
    assert re.search(r"ragb_vae_tpu/ops/pallas/\w+\.py", text)
    assert re.search(r"`_\w*kernel`", text), "names the Pallas kernel function"
    assert "What bounds it on the H100" in text


def test_build_targets_sm90a():
    text = (ROOT / "ops" / "kernels" / "_build.py").read_text()
    assert "arch=compute_90a,code=sm_90a" in text
