"""The check that no JAX module was loaded compares whole top-level names,
and nothing the benchmark runs imports JAX, the JAX package, or (in the
reference) the program."""
import ast
from pathlib import Path

import pytest

from perfbench import harness


@pytest.mark.parametrize("modules, found", [
    ({"jax": 1, "jax.numpy": 1}, ["jax", "jax.numpy"]),
    ({"jaxlib.xla_client": 1}, ["jaxlib.xla_client"]),
    ({"flax.linen": 1, "optax": 1}, ["flax.linen", "optax"]),
    ({"ragb_vae_tpu": 1, "ragb_vae_tpu.models": 1}, ["ragb_vae_tpu", "ragb_vae_tpu.models"]),
    ({"ragb_vae_tpu_torch": 1, "ragb_vae_tpu_torch.models.vae": 1}, []),
    ({"jaxtyping": 1, "flaxen": 1, "optaxes": 1, "jax_utils": 1}, []),
])
def test_whole_top_level_names(modules, found):
    assert harness.forbidden_loaded(modules) == found


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


SOURCES = sorted(p for p in harness.HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_sources_import_no_jax(path):
    for name in _imports(path):
        assert name.split(".")[0] not in harness.FORBIDDEN_MODULES, (path, name)


@pytest.mark.parametrize("path", sorted((harness.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name in _imports(path):
        assert name.split(".")[0] != "ragb_vae_tpu_torch", (path, name)


def test_sources_read_nothing_of_the_jax_benchmarks():
    for path in SOURCES:
        text = path.read_text()
        assert "bench.py" not in text.replace("perfbench", "") and "benchmarks/" not in text, path
