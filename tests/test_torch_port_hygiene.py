"""Structural rules of the PyTorch port, checked from its sources.

- No module of `ragb_vae_tpu_torch` (nor `chip_smoke.py`) imports jax, flax
  or the JAX package. This is an AST scan: `sys.modules` cannot tell, since
  the test environment preloads jax at interpreter start.
- Every CUDA source names the TPU kernel it replaces and what bounds it on
  the card; the build targets sm_90a.
- Importing the whole package builds nothing and needs no CUDA toolkit.
- No function that launches a kernel (`*_cuda`) calls a plain version, and
  every call of a plain version outside a `*_plain` function sits on the
  CPU side of an `is_cuda` / device-type test.
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


def test_scan_covers_training_and_parallel():
    scanned = {str(p.relative_to(ROOT)) for p in SOURCES if p.is_relative_to(ROOT)}
    assert {"training/vae_step.py", "parallel/grad_accum.py", "models/lpips.py",
            "models/losses.py", "ops/triplet.py", "ops/metrics.py"} <= scanned


def test_scan_covers_data_and_the_lora_stage():
    scanned = {str(p.relative_to(ROOT)) for p in SOURCES if p.is_relative_to(ROOT)}
    assert {"data/buckets.py", "data/sampler.py", "data/text_alpha_dataset.py", "data/loader.py",
            "data/image_io.py", "training/flux_kontext_textalpha_lora.py"} <= scanned


def _called_names(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            fn = sub.func
            name = fn.id if isinstance(fn, ast.Name) else fn.attr if isinstance(fn, ast.Attribute) else None
            if name:
                yield name, sub


def _mentions_cuda(test: ast.AST) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr == "is_cuda" for n in ast.walk(test))


def _plain_calls_on_cuda_branches(path: Path):
    """(function, callee, line) of every `*_plain` call that a CUDA tensor
    could reach: inside a `*_cuda` function, in the true branch of an
    `if <...>.is_cuda`, or in a conditional expression `a if x.is_cuda else b`
    on its CUDA side."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if fn.name.endswith("_cuda"):
            bad += [(fn.name, name, call.lineno) for name, call in _called_names(fn)
                    if name.endswith("_plain")]
        for node in ast.walk(fn):
            if isinstance(node, ast.If) and _mentions_cuda(node.test):
                for stmt in node.body:
                    bad += [(fn.name, name, call.lineno) for name, call in _called_names(stmt)
                            if name.endswith("_plain")]
            if isinstance(node, ast.IfExp) and _mentions_cuda(node.test):
                names = [n.id for n in ast.walk(node.body) if isinstance(n, ast.Name)]
                bad += [(fn.name, n, node.lineno) for n in names if n.endswith("_plain")]
    return bad


@pytest.mark.parametrize("path", [p for p in SOURCES if p.is_relative_to(ROOT)],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_plain_version_on_a_cuda_branch(path):
    assert not _plain_calls_on_cuda_branches(path)


def test_the_cuda_branch_scan_sees_a_planted_call(tmp_path):
    planted = tmp_path / "planted.py"
    planted.write_text(
        "def f_cuda(x):\n    return g_plain(x)\n\n"
        "def h(x):\n    if x.is_cuda:\n        return g_plain(x)\n    return g_plain(x)\n\n"
        "def k(x):\n    fn = g_plain if x.is_cuda else g_cuda\n    return fn(x)\n")
    found = _plain_calls_on_cuda_branches(planted)
    assert [(f, n) for f, n, _ in found] == [("f_cuda", "g_plain"), ("h", "g_plain"), ("k", "g_plain")]


def test_backward_sources_are_built_with_the_forward():
    assert {"resnet_block_bwd.cu", "conv_taps.cuh"} <= {p.name for p in (ROOT / "csrc").iterdir()}
    from ragb_vae_tpu_torch.ops.kernels import _build

    assert {"ragb_resnet_conv3x3_stats_bwd", "ragb_subpixel_upsample_conv3x3_stats_bwd"} <= set(_build._SIGNATURES)


def test_attention_backward_source_is_built_and_names_both_kernels():
    from ragb_vae_tpu_torch.ops.kernels import _build

    assert {"flash_attention_bwd.cu", "mma.cuh"} <= {p.name for p in _build._sources()}
    assert {"ragb_flash_attention_dq", "ragb_flash_attention_dkv"} <= set(_build._SIGNATURES)
    text = (ROOT / "csrc" / "flash_attention_bwd.cu").read_text()
    assert "`_dq_kernel`" in text and "`_dkv_kernel`" in text
    assert "What bounds it on the H100" in text
    for name in ("ragb_flash_attention_dq", "ragb_flash_attention_dkv"):
        assert f'extern "C" int {name}(' in text
    # every accumulator has one owner: no float atomics, no library product
    assert "atomic" not in text.replace("no float atomic", "") and "cublas" not in text.lower()
