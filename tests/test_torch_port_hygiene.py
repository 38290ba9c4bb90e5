"""Structural rules of the PyTorch port, checked from its sources.

- No module of `ragb_vae_tpu_torch` (nor `chip_smoke.py`, nor the port's
  scripts) imports jax, flax or the JAX package. This is an AST scan: `sys.modules` cannot tell, since
  the test environment preloads jax at interpreter start.
- Every CUDA source names the TPU kernel it replaces and what bounds it on
  the card; the build targets sm_90a.
- Importing the whole package builds nothing and needs no CUDA toolkit.
- No function that launches a kernel (`*_cuda`) calls a plain version, and
  every call of a plain version outside a `*_plain` function sits on the
  CPU side of an `is_cuda` / device-type test.
  `plain_vjp`, which takes a plain version as an argument and differentiates
  it on whatever device its operands lie, is called only from `backward`
  methods (the JAX package differentiates its XLA references the same way).
- No source picks its device with `"cuda" if torch.cuda.is_available() else
  "cpu"`, and no function of the port defaults its `device` argument to the
  CPU: an entry point runs on the card unless the caller names the CPU, and a
  missing card is an error. A loader classmethod (`from_*`) does not default
  `device` to None either: that left its model wherever it was built, the host.
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
PORT_SCRIPTS = [ROOT.parent / "scripts" / name for name in (
    "profile_torch_slice.py", "planted_faults_bwd.py", "quantize_flux_checkpoint_torch.py", "train_torch.py",
    "time_conv_engine.py", "time_int8_matmul.py", "time_conv_bwd.py", "k1_stage_variants.py", "k8_variants.py",
    "serve_torch.py", "convert_qwen_vae_to_rgba_torch.py", "prepare_rgba_vae_init_torch.py",
    "dataset_sanity_check_torch.py", "rgb_vae_sanity_check_torch.py",
    "pp_multicard_check.py", "tp_torchrun_check.py", "dist_multicard_check.py", "export_empty_prompt_torch.py",
    "prepare_rgba_buckets_torch.py", "prism_layer_real_bucketer_torch.py", "prism_layer_pro_bucketer_torch.py",
    "laion_bucket_downloader_torch.py", "time_plain_gaps.py", "record_goldens_torch.py",
    "rehearse_real_geometry_torch.py", "rehearse_aux_assets_torch.py")] + [ROOT.parent / "inference_rgba_flux_torch.py"]
SOURCES = sorted(ROOT.rglob("*.py")) + [ROOT.parent / "chip_smoke.py"] + PORT_SCRIPTS


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


@pytest.mark.parametrize("path", PORT_SCRIPTS, ids=lambda p: p.name)
def test_port_scripts_import_no_jax_script_by_its_bare_name(path):
    """The scripts put `scripts/` on sys.path and import each other by bare
    name; a sibling that is not a port script is a JAX script (for example
    `convert_qwen_vae_to_rgba`), which the scan above would not see."""
    jax_scripts = {p.stem for p in (ROOT.parent / "scripts").glob("*.py")} - {p.stem for p in PORT_SCRIPTS}
    bad = [m for m in _imported_modules(path) if m in jax_scripts]
    assert not bad, f"{path} imports the JAX scripts {bad}"


TEST_MODULES = {p.stem for p in (ROOT.parent / "tests").glob("*.py")}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT.parent)))
def test_no_test_module_imports(path):
    """Nothing of the port imports from `tests/`, as `tests.x` or, with
    `tests/` put on sys.path, by a test module's bare name: the restatements
    there (`tests/torch_vae_ref.py`, `torch_flux_ref.py`) import the JAX
    package's config classes, which the scan above does not see."""
    bad = [m for m in _imported_modules(path) if m.split(".")[0] == "tests" or m.split(".")[0] in TEST_MODULES]
    assert not bad, f"{path} imports {bad} from tests/"


def test_scan_covers_the_front_door():
    scanned = {str(p.relative_to(ROOT.parent)) for p in SOURCES}
    assert {"ragb_vae_tpu_torch/serving_daemon.py", "ragb_vae_tpu_torch/_cli.py", "scripts/serve_torch.py",
            "inference_rgba_flux_torch.py"} <= scanned


TORCH_ENTRY_POINTS = ("ragb-train-torch", "ragb-infer-torch", "ragb-serve-torch")


def _project_scripts() -> dict:
    import tomllib

    return tomllib.loads((ROOT.parent / "pyproject.toml").read_text())["project"]["scripts"]


def test_torch_entry_points_are_the_ones_listed():
    assert {k for k in _project_scripts() if k.endswith("-torch")} == set(TORCH_ENTRY_POINTS)
    assert {"ragb-train", "ragb-infer", "ragb-serve"} <= set(_project_scripts())   # the JAX ones stay


@pytest.mark.parametrize("name", TORCH_ENTRY_POINTS)
def test_torch_entry_point_resolves_to_a_function_of_the_port_cli(name):
    module, _, attr = _project_scripts()[name].partition(":")
    assert module == "ragb_vae_tpu_torch._cli"
    assert callable(getattr(importlib.import_module(module), attr))


def test_every_module_imports_without_a_toolkit():
    from ragb_vae_tpu_torch.ops.kernels import _build

    from ragb_vae_tpu_torch.data import native_io

    for info in pkgutil.walk_packages([str(ROOT)], prefix="ragb_vae_tpu_torch."):
        importlib.import_module(info.name)
    assert _build._lib is None  # nothing was compiled or loaded by importing
    assert not native_io._load_attempted  # nor the PNG codec


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


def test_scan_covers_the_stage1_loop():
    scanned = {str(p.relative_to(ROOT)) for p in SOURCES if p.is_relative_to(ROOT)}
    assert {"config.py", "data/transforms.py", "data/manifest.py", "data/bucket_dataset.py",
            "data/component_dataset.py", "data/multilayer_dataset.py", "models/vae_tiling.py",
            "training/checkpoint.py", "training/rgba_vae_stage.py", "training/__init__.py",
            "utils/metrics_logger.py", "utils/preemption.py", "utils/profiling.py"} <= scanned


def test_winograd_source_is_built_and_names_its_kernel():
    from ragb_vae_tpu_torch.ops.kernels import _build

    assert "resnet_block_wino.cu" in {p.name for p in _build._sources()}
    assert {"ragb_resnet_conv3x3_stats_wino", "ragb_wino_tile_shape"} <= set(_build._SIGNATURES)
    text = (ROOT / "csrc" / "resnet_block_wino.cu").read_text()
    assert "`_wino_kernel`" in text and "wgmma_ss_tb64<" in text and "mma_16816" not in text
    assert 'int ragb_resnet_conv3x3_stats_wino(' in text
    # one block owns its output tile; the product is the kernel's own
    assert "atomicAdd" not in text and "cublas" not in text.lower() and "cudnn" not in text.lower()


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
    names = {p.name for p in (ROOT / "csrc").iterdir()}
    assert "resnet_block_bwd.cu" in names and "conv_taps.cuh" not in names
    from ragb_vae_tpu_torch.ops.kernels import _build

    assert {"ragb_resnet_conv3x3_stats_bwd", "ragb_subpixel_upsample_conv3x3_stats_bwd"} <= set(_build._SIGNATURES)


def test_attention_backward_source_is_built_and_names_both_kernels():
    from ragb_vae_tpu_torch.ops.kernels import _build

    names = {p.name for p in _build._sources()}
    assert "flash_attention_bwd.cu" in names and "mma.cuh" not in names
    names = ("ragb_flash_attention_dq", "ragb_flash_attention_dkv", "ragb_flash_attention_bwd")
    assert set(names) <= set(_build._SIGNATURES)
    text = (ROOT / "csrc" / "flash_attention_bwd.cu").read_text()
    assert "`_dq_kernel`" in text and "`_dkv_kernel`" in text
    assert "What bounds it on the H100" in text
    for name in names:
        assert f'extern "C" int {name}(' in text
    # every accumulator has one owner: no float atomics, no library product
    assert "atomic" not in text.replace("no float atomic", "") and "cublas" not in text.lower()


def _code(path: Path) -> str:
    """A CUDA source without its comments."""
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", path.read_text(), flags=re.S)


@pytest.mark.parametrize("token", ["mma_16816", "ldmatrix", "cp_async16", "mma.sync", "cp.async.ca",
                                   "cp.async.cg", '#include "mma.cuh"'])
def test_attention_backward_has_no_legacy_tensor_core_path(token):
    """K4 and K5 are TMA-fed wgmma kernels: no mma.sync fragment, ldmatrix
    or cp.async staging is left in their source."""
    assert token not in _code(ROOT / "csrc" / "flash_attention_bwd.cu")


@pytest.mark.parametrize("token", ["wgmma_ss<", "wgmma_rs_tb<", "tma_load_3d(", "tma_store_3d(",
                                   "mbar_wait(", "setmaxnreg_dec<", "setmaxnreg_inc<",
                                   "flash_dq_kernel(", "flash_dkv_kernel("])
def test_attention_backward_uses_the_hopper_primitives(token):
    """Both kernels are built on csrc/sm90.cuh: TMA loads into an mbarrier
    ring, a producer warp and consumer warpgroups, wgmma products."""
    code = _code(ROOT / "csrc" / "flash_attention_bwd.cu")
    assert '#include "sm90.cuh"' in code and token in code


SM90_CONV = ROOT / "csrc" / "conv_sm90.cuh"


def test_hopper_conv_engine_is_built_and_names_what_it_replaces():
    """K9, K11 and K12 run on csrc/conv_sm90.cuh: it is one of the library's
    sources (conv_kernels.cu includes it and routes all three entry points
    through it, each in its own mode, and includes the wmma template no
    more), its note names the TPU kernels and what bounds it, and the K9
    wrapper sizes its partials from the engine's tile."""
    import inspect

    from ragb_vae_tpu_torch.ops.kernels import _build
    from ragb_vae_tpu_torch.ops.kernels import resnet_block as rb

    assert SM90_CONV in _build._sources()
    assert "ragb_conv_sm90_tile_shape" in _build._SIGNATURES
    entries = _code(ROOT / "csrc" / "conv_kernels.cu")
    assert '#include "conv_sm90.cuh"' in entries and '#include "conv_taps.cuh"' not in entries
    assert all(f"launch_conv_sm90<{mode}>(" in entries for mode in ("CONV_SAME", "CONV_DOWN", "CONV_ACT"))
    assert "launch_conv<" not in entries
    text = SM90_CONV.read_text()
    assert "ragb_vae_tpu/ops/pallas/conv3x3.py:39" in text and "`_conv_kernel`" in text
    assert "ragb_vae_tpu/ops/pallas/resnet_block.py:1622" in text and "`_downsample_kernel`" in text
    assert "ragb_vae_tpu/ops/pallas/resnet_block.py:69" in text
    assert "ragb_vae_tpu/ops/pallas/fused_gn_silu_conv.py:45" in text
    assert "What bounds it on the H100" in text and "bytes bound it" in text
    wrapper = inspect.getsource(rb.downsample_conv3x3_stats_cuda)
    assert '_tile_shape("ragb_conv_sm90_tile_shape")' in wrapper and "_tile_shape()" not in wrapper
    # one block owns its output tile; the product is the kernel's own
    assert "atomic" not in _code(SM90_CONV) and "cublas" not in text.lower() and "cudnn" not in text.lower()


@pytest.mark.parametrize("token", ["wgmma_ss_tb<", "tma_load_4d(", "tma_load_3d(", "tma_store_4d(",
                                   "mbar_wait_or_trap(", "mbar_arrive_expect_tx(", "setmaxnreg_dec<",
                                   "setmaxnreg_inc<", "conv_sm90_kernel<"])
def test_hopper_conv_engine_uses_the_hopper_primitives(token):
    """The engine is built on csrc/sm90.cuh: TMA loads into mbarrier rings, a
    producer warp and consumer warpgroups, wgmma products, a TMA store."""
    code = _code(SM90_CONV)
    assert '#include "sm90.cuh"' in code and token in code


@pytest.mark.parametrize("ptx", ["wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                                 "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes",
                                 "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"])
def test_hopper_conv_engine_primitives_are_wgmma_and_bulk_tensor_copies(ptx):
    assert ptx in _code(ROOT / "csrc" / "sm90.cuh")


@pytest.mark.parametrize("token", ["wmma::", "mma_sync", "mma.sync", "mma_16816", "ldmatrix", "cp_async16",
                                   "cp.async.ca", "cp.async.cg", '#include "mma.cuh"'])
def test_hopper_conv_engine_has_no_legacy_tensor_core_path(token):
    """No wmma or mma.sync fragment, ldmatrix or cp.async staging in the
    engine, K1's and K12's activation mode included (the wmma template is
    another file, which the engine no longer includes)."""
    assert token not in _code(SM90_CONV)


INT8_SRC = ROOT / "csrc" / "int8_matmul.cu"


@pytest.mark.parametrize("token", ["int8_wgmma_kernel<", "int8_gemv_kernel<", "tma_load_3d(", "tma_store_3d(",
                                   "mbar_wait_or_trap(", "mbar_arrive_expect_tx(", "wgmma_rs<", "setmaxnreg_dec<",
                                   "setmaxnreg_inc<", "stmatrix_x4_trans(", "CU_TENSOR_MAP_DATA_TYPE_UINT8",
                                   "CU_TENSOR_MAP_SWIZZLE_64B"])
def test_int8_matmul_uses_the_hopper_primitives(token):
    """K10's tensor-core kernel is built on csrc/sm90.cuh: TMA loads of x and
    of the int8 weights into an mbarrier ring, a producer warp and consumer
    warpgroups, register-A wgmma over the converted weights, a TMA store."""
    code = _code(INT8_SRC)
    assert '#include "sm90.cuh"' in code and token in code


@pytest.mark.parametrize("token", ["wmma::", "mma_sync", "mma.sync", "mma_16816", "ldmatrix", "cp_async16",
                                   "cp.async.ca", "cp.async.cg", '#include "mma.cuh"'])
def test_int8_matmul_has_no_legacy_tensor_core_path(token):
    """No mma.sync fragment, ldmatrix or cp.async staging is left in K10."""
    assert token not in _code(INT8_SRC)


@pytest.mark.parametrize("ptx", ["wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16",
                                 "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16"])
def test_int8_matmul_primitives_are_in_sm90(ptx):
    assert ptx in _code(ROOT / "csrc" / "sm90.cuh")


def test_int8_matmul_register_a_wgmma_takes_k_major_b():
    """The register-A wgmma has one body per N whose last immediate is the
    transpose-B flag: 1 for the MN-major V of P V, 0 for the K-major rows of x."""
    code = _code(ROOT / "csrc" / "sm90.cuh")
    assert "wgmma_rs_imm<1>(d, a, desc_b, scale_d);" in code and "wgmma_rs_imm<0>(d, a, desc_b, scale_d);" in code
    assert code.count('"n"(TB)') == 2


def _bf16_value(bits: int) -> float:
    import struct

    return struct.unpack("<f", struct.pack("<I", (bits & 0xFFFF) << 16))[0]


def test_int8_to_bf16_conversion_is_exact_for_every_byte():
    """K10's int8x2_to_bf16x2: (q & 0x7F) | 0x4300 plus (q & 0x80) | 0xC300,
    both bf16, is q for each of the 256 bytes, and both terms and the sum are
    exact in bf16 (the add rounds nothing). The constants are the source's."""
    code = _code(INT8_SRC)
    for const in ("0x007F007Fu", "0x43004300u", "0x00800080u", "0xC300C300u", "0x3F803F80u", "0x4140"):
        assert const in code
    for q in range(-128, 128):
        byte = q & 0xFF
        mag, off = (byte & 0x7F) | 0x4300, (byte & 0x80) | 0xC300
        assert _bf16_value(mag) == 128 + (byte & 0x7F)
        assert _bf16_value(off) == -(128 + (byte & 0x80))
        assert _bf16_value(mag) + _bf16_value(off) == q
    assert _bf16_value(0x3F80) == 1.0


@pytest.mark.parametrize("s", range(4))
def test_int8_weight_fragment_read_is_bank_conflict_free(s):
    """K10's consumers read their A fragments from the 64-byte-swizzled int8
    box with 2-byte loads: lane (g, t) of warp w takes bytes 2t (and 2t + 8)
    of k-step s of row 16 w + g (and + 8), at chunk s ^ ((row >> 1) & 3). In
    every such load the 32 lanes touch 16 distinct 4-byte words in 16
    distinct banks (lanes 2t and 2t + 1 share a word), so no load of a warp
    waits on a bank conflict."""
    assert "((s ^ (r >> 1)) & 3) * 16 + 2 * t" in _code(INT8_SRC)
    for warp in range(8):                      # 64 w + 16 warp over both consumer warpgroups
        for h in range(2):
            for hi in (0, 8):
                words = set()
                for g in range(8):
                    for t in range(4):
                        r = 16 * warp + g + 8 * h
                        words.add((r * 64 + ((s ^ (r >> 1)) & 3) * 16 + 2 * t + hi) // 4)
                assert len(words) == 16 and len({w % 32 for w in words}) == 16


def test_int8_gemv_x_swizzle_is_bank_conflict_free():
    """The skinny kernel's x chunk swizzle, k ^ (((k >> 5) & 3) << 2), is a
    permutation of 4-float pieces inside each 64-float row segment, and the
    eight lanes of a shared-memory phase that read piece j (lane l at k =
    16 l + 4 j) land in eight distinct 16-byte bank groups."""
    assert "k ^ (((k >> 5) & 3) << 2)" in _code(INT8_SRC)
    swz = lambda k: k ^ (((k >> 5) & 3) << 2)
    assert sorted(swz(k) for k in range(0, 2048, 4)) == list(range(0, 2048, 4))
    for j in range(4):
        for phase in range(4):
            groups = {(swz(16 * lane + 4 * j) // 4) % 8 for lane in range(8 * phase, 8 * phase + 8)}
            assert len(groups) == 8


def _planted_faults_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location("planted_faults_bwd", ROOT.parent / "scripts" / "planted_faults_bwd.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _planted_faults():
    return _planted_faults_module().FAULTS


@pytest.mark.parametrize("fault", _planted_faults(), ids=lambda f: f[0])
def test_planted_fault_replaces_one_line_of_its_source(fault):
    """`scripts/planted_faults_bwd.py` plants each fault by replacing text
    that occurs exactly once in its source (a CUDA file, or for K6's padding
    trap the wrapper): a fault whose text drifted out of the source would
    stop the script on the card."""
    label, source, old, new = fault[:4]
    text = _planted_faults_module().source_path(ROOT, source).read_text()
    assert text.count(old) == 1 and old != new, label


def test_k6_faults_share_a_selector():
    """`--only 'resnet conv backward'` selects every K6 fault: the three that
    came with the first design (two of them now planted in the new sources),
    the data and weight gradients' six and dskip's one."""
    k6 = [f for f in _planted_faults() if "resnet conv backward" in f[0]]
    assert len(k6) == 9
    assert {f[1] for f in k6} == {"wgrad_sm90.cuh", "conv_sm90.cuh", "resnet_block_bwd.cu",
                                  "ops/kernels/resnet_block.py"}


def test_scan_covers_the_int8_path_and_the_stand_alone_convs():
    scanned = {str(p.relative_to(ROOT)) for p in SOURCES if p.is_relative_to(ROOT)}
    assert {"ops/kernels/int8_matmul.py", "ops/kernels/conv3x3.py", "ops/kernels/fused_gn_silu_conv.py",
            "models/quantize.py", "inference.py", "serving.py"} <= scanned
    assert all(p.exists() for p in PORT_SCRIPTS)


def test_int8_and_conv_sources_are_built_and_name_their_kernels():
    from ragb_vae_tpu_torch.ops.kernels import _build

    assert {"int8_matmul.cu", "conv_kernels.cu"} <= {p.name for p in _build._sources()}
    assert {"ragb_int8_matmul", "ragb_conv3x3_same", "ragb_fused_gn_silu_conv3x3",
            "ragb_downsample_conv3x3_stats"} <= set(_build._SIGNATURES)
    convs = (ROOT / "csrc" / "conv_kernels.cu").read_text()
    assert all(name in convs for name in ("`_downsample_kernel`", "`_conv_kernel`", "`_kernel`"))
    int8 = (ROOT / "csrc" / "int8_matmul.cu").read_text()
    assert 'extern "C" int ragb_int8_matmul(' in int8
    # one block owns an output tile and loops over K itself; the product is the kernel's own
    for text in (convs, int8):
        assert "atomicAdd" not in text and "cublas" not in text.lower() and "cudnn" not in text.lower()


SILENT_CPU = re.compile(r"is_available\(\)\s*else\s*[\"']cpu[\"']")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT.parent)))
def test_no_silent_fallback_to_the_cpu(path):
    assert not SILENT_CPU.search(path.read_text()), f"{path} picks the CPU when no card is found"


def test_the_silent_fallback_scan_sees_a_planted_line():
    assert SILENT_CPU.search('device = "cuda" if torch.cuda.is_available() else "cpu"')
    assert SILENT_CPU.search("torch.device('cuda' if torch.cuda.is_available()  else 'cpu')")
    assert not SILENT_CPU.search('if not torch.cuda.is_available():\n    raise SystemExit("no card")')


def _cpu_device_defaults(path: Path):
    """(function, line) of every function whose `device` argument defaults to the CPU."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        positional = fn.args.posonlyargs + fn.args.args
        pairs = list(zip(positional[len(positional) - len(fn.args.defaults):], fn.args.defaults))
        pairs += [(a, d) for a, d in zip(fn.args.kwonlyargs, fn.args.kw_defaults) if d is not None]
        for arg, default in pairs:
            names = [n.value for n in ast.walk(default) if isinstance(n, ast.Constant)]
            if arg.arg == "device" and "cpu" in names:
                bad.append((fn.name, fn.lineno))
    return bad


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT.parent)))
def test_no_device_argument_defaults_to_the_cpu(path):
    assert not _cpu_device_defaults(path)


def test_the_device_default_scan_sees_planted_signatures(tmp_path):
    planted = tmp_path / "planted.py"
    planted.write_text(
        'def f(x, device="cpu"):\n    return x\n\n'
        'def g(x, *, seed=0, device=torch.device("cpu")):\n    return x\n\n'
        'def h(x, device="cuda", kind="cpu"):\n    return x\n\n'
        'def k(x, device=None):\n    return x\n')
    assert [name for name, _ in _cpu_device_defaults(planted)] == ["f", "g"]
    # the two constructors a user calls and the tree-level draw default to the card
    import inspect

    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel
    from ragb_vae_tpu_torch.models.quantize import random_quantized_params_like

    for fn in (FluxTextAlphaModel.random, FluxTextAlphaModel.from_pretrained, random_quantized_params_like):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def _host_loader_defaults(path: Path):
    """(function, line) of every `from_*` classmethod whose `device`
    argument defaults to None."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) or not fn.name.startswith("from_"):
            continue
        if not any(getattr(d, "id", None) == "classmethod" for d in fn.decorator_list):
            continue
        positional = fn.args.posonlyargs + fn.args.args
        pairs = list(zip(positional[len(positional) - len(fn.args.defaults):], fn.args.defaults))
        pairs += [(a, d) for a, d in zip(fn.args.kwonlyargs, fn.args.kw_defaults) if d is not None]
        if any(a.arg == "device" and isinstance(d, ast.Constant) and d.value is None for a, d in pairs):
            bad.append((fn.name, fn.lineno))
    return bad


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT.parent)))
def test_no_loader_leaves_its_model_on_the_host(path):
    assert not _host_loader_defaults(path)


def test_the_loader_scan_sees_planted_classmethods(tmp_path):
    planted = tmp_path / "planted.py"
    planted.write_text(
        "class M:\n"
        "    @classmethod\n    def from_pretrained_rgb(cls, path, *, device=None):\n        return cls()\n\n"
        "    @classmethod\n    def from_dir(cls, path, device='cuda'):\n        return cls()\n\n"
        "    def from_other(self, device=None):\n        return self\n")
    assert [name for name, _ in _host_loader_defaults(planted)] == ["from_pretrained_rgb"]
    import inspect

    from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE

    assert inspect.signature(RgbaVAE.from_pretrained_rgb).parameters["device"].default == "cuda"


def _plain_vjp_callers(path: Path):
    """Names of the functions that call `plain_vjp`."""
    tree = ast.parse(path.read_text(), filename=str(path))
    return [fn.name for fn in ast.walk(tree) if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
            for name, _ in _called_names(fn) if name == "plain_vjp"]


def test_plain_vjp_is_called_only_from_backward_methods(tmp_path):
    callers = {str(p.relative_to(ROOT)): _plain_vjp_callers(p) for p in SOURCES if p.is_relative_to(ROOT)}
    callers = {k: v for k, v in callers.items() if v}
    assert callers == {"ops/kernels/resnet_block.py": ["backward"], "ops/kernels/conv3x3.py": ["backward"],
                       "ops/kernels/fused_gn_silu_conv.py": ["backward"]}
    planted = tmp_path / "planted.py"
    planted.write_text("def forward(ctx, x):\n    return plain_vjp(f_plain, (x,), (x,))\n")
    assert _plain_vjp_callers(planted) == ["forward"]


# ---------------------------------------------------------------------------
# K6, the resnet-block conv backward, on the Hopper kernels
# ---------------------------------------------------------------------------
BWD_SRC = ROOT / "csrc" / "resnet_block_bwd.cu"
WGRAD_SRC = ROOT / "csrc" / "wgrad_sm90.cuh"


def _k6_entry() -> str:
    """The body of K6's C entry point, without comments."""
    code = _code(BWD_SRC)
    start = code.index("int ragb_resnet_conv3x3_stats_bwd(")
    return code[start:code.index("int ragb_subpixel_upsample_conv3x3_stats_bwd(")]


@pytest.mark.parametrize("call", ["launch_conv_sm90<CONV_BWD>(", "launch_wgrad_sm90<3>(", "launch_wgrad_sm90<1>(",
                                  "launch_dye(", "launch_conv_sm90<CONV_1X1>("])
def test_k6_entry_runs_the_hopper_kernels(call):
    """K6's data gradient runs on the conv engine (BWD epilogue), its weight
    gradient and dws on the TMA + wgmma weight-gradient kernel, dskip on the
    engine's one-tap mode."""
    assert call in _k6_entry()


@pytest.mark.parametrize("token", ["launch_conv<MODE_CONV3", "EPI_BWD_ACT", "launch_wgrad<", "wgrad_kernel<",
                                   "WG_CONV3", "WG_CONV1", "wmma", "mma_sync", "mma.sync"])
def test_k6_entry_launches_no_wmma_kernel(token):
    """Nothing on K6's path is a wmma kernel: dskip's 1x1 conv, the last
    launch_conv, is the engine's one-tap mode."""
    entry = _k6_entry()
    assert token not in entry
    assert "launch_conv<" not in entry and "MODE_CONV1" not in entry and "launch_conv_sm90<CONV_1X1>(" in entry


@pytest.mark.parametrize("token", ["WG_CONV3", "WG_CONV1", "EPI_BWD_ACT", "act_x"])
def test_first_k6_design_is_gone(token):
    """The wmma weight gradient's 3x3 and 1x1 modes and the wmma template's
    backward epilogue have no launch left, and no code."""
    for path in sorted((ROOT / "csrc").iterdir()):
        assert token not in _code(path), path.name


@pytest.mark.parametrize("token", ["wgmma_ss_tatb<", "tma_load_4d(", "mbar_wait_or_trap(", "mbar_arrive_expect_tx(",
                                   "named_barrier_sync(", "wgrad_sm90_kernel<", "sum_slices_kernel<<<"])
def test_k6_weight_gradient_uses_the_hopper_primitives(token):
    code = _code(WGRAD_SRC)
    assert '#include "sm90.cuh"' in code and token in code


@pytest.mark.parametrize("token", ["wmma::", "mma_sync", "mma.sync", "mma_16816", "ldmatrix", "cp_async16",
                                   "cp.async.ca", "cp.async.cg", "atomic"])
def test_k6_weight_gradient_has_no_legacy_path_and_no_atomics(token):
    assert token not in _code(WGRAD_SRC)


def test_k6_sources_name_what_they_replace_and_their_bound():
    for path in (WGRAD_SRC, SM90_CONV, BWD_SRC):
        text = path.read_text()
        assert "ragb_vae_tpu/ops/pallas/resnet_block.py:952" in text or "`_bwd_kernel`" in text, path.name
        assert "What bounds it on the H100" in text, path.name
    assert WGRAD_SRC in _build_sources()


def _build_sources():
    from ragb_vae_tpu_torch.ops.kernels import _build

    return _build._sources()


def test_transposed_a_wgmma_sets_both_transpose_immediates():
    """The weight gradient's operands are both MN-major (pixels are NHWC's
    outer dimension): its wgmma sets imm-trans-a and imm-trans-b to 1."""
    code = _code(ROOT / "csrc" / "sm90.cuh")
    body = code[code.index("void wgmma_ss_tatb<128>"):]
    body = body[:body.index("}\n")]
    assert "p, 1, 1, 1, 1;" in body and "m64n128k16.f32.bf16.bf16" in body


@pytest.mark.parametrize("token", ["template <int MODE>", "tma_store_4d(&amap", "e_full",
                                   "act_chain(", "stats_reduce_kernel<<<"])
def test_conv_engine_carries_k6_data_gradient(token):
    """K6's data gradient is the engine's BWD mode: the forward's x by TMA
    into the drained ring, the chain rule in the epilogue, dx and A by TMA
    stores, the (d_t * x, d_t) partials summed in a fixed order."""
    assert token in _code(SM90_CONV)


# ---------------------------------------------------------------------------
# K1 and K12 on the conv engine's activation mode (CONV_ACT)
# ---------------------------------------------------------------------------
def _c_entry(path: Path, name: str) -> str:
    """The body of the C entry point `name` in `path`, comments stripped."""
    code = _code(path)
    start = code.index(f"int {name}(")
    return code[start:code.index("\n}\n", start)]


@pytest.mark.parametrize("path,name", [("resnet_block.cu", "ragb_resnet_conv3x3_stats"),
                                       ("conv_kernels.cu", "ragb_fused_gn_silu_conv3x3")])
def test_k1_and_k12_entries_launch_the_conv_engine(path, name):
    """K1's and K12's C entries launch the engine's activation mode, and no
    wmma template."""
    entry = _c_entry(ROOT / "csrc" / path, name)
    assert "launch_conv_sm90<CONV_ACT>(" in entry and "launch_conv<" not in entry and "ConvArgs" not in entry
    assert '#include "conv_sm90.cuh"' in _code(ROOT / "csrc" / path)


@pytest.mark.parametrize("path", sorted((ROOT / "csrc").glob("*.cu*")), ids=lambda p: p.name)
def test_no_wmma_conv3_mode_is_left(path):
    """The wmma template's 3x3 mode (K1's and K12's first design) has no
    launch left, and no code."""
    assert "MODE_CONV3" not in _code(path)


@pytest.mark.parametrize("pattern", [r"\bMODE_CONV3\b", r"\bMODE_CONV1\b", r"\bEPI_FWD\b", r"\bConvArgs\b",
                                     r"\bconv_taps_kernel\b", r"\bTapGeometry\b", r"\bconv_smem_bytes\b",
                                     r"\blaunch_conv<", r"\bWinoArgs\b", r"\bnvcuda\b", r"<mma\.h>"])
def test_wmma_template_is_gone(pattern):
    """The wmma template (conv_taps.cuh: its 1x1 mode was K6's dskip, its
    other modes K1's, K2's, K7's and K12's first designs), its argument
    struct and the first Winograd kernel's are gone from every source, and
    nothing includes <mma.h>."""
    assert not (ROOT / "csrc" / "conv_taps.cuh").exists() and not (ROOT / "csrc" / "mma.cuh").exists()
    for path in sorted((ROOT / "csrc").iterdir()):
        assert not re.search(pattern, _code(path)), (path.name, pattern)


def test_k1_wrapper_sizes_its_partials_from_the_engine_tile():
    import inspect

    from ragb_vae_tpu_torch.ops.kernels import resnet_block as rb

    wrapper = inspect.getsource(rb.conv3x3_stats_cuda)
    assert '_tile_shape("ragb_conv_sm90_tile_shape")' in wrapper and "_tile_shape()" not in wrapper


def _activation_stage() -> str:
    """The activation of a thread's rows (`act_live`, `act_coeffs`,
    `act_rows`) and the producer warps' loop over the slabs, comments
    stripped."""
    code = _code(SM90_CONV)
    start = code.index("bool act_live(")
    body = code[start:code.index("__global__", start)]
    start = code.index("ACT && threadIdx.x >= L::CONSUMERS + 32")
    return body + code[start:code.index("setmaxnreg_inc<", start)]


@pytest.mark.parametrize("token", ["mbar_wait_or_trap(a_full(", "fence_proxy_async();", "mbar_arrive(a_ready(",
                                   "lc ^ (r & 7)", "(unsigned)hh < (unsigned)H", "c * 64 + 8 * lc < C", "act_pair("])
def test_activation_stage_writes_the_slab_in_shared_memory(token):
    """K1's activation stage waits for each TMA slab, rewrites it in place
    (the logical chunk found through the 128-byte swizzle, 0 outside the
    image and past channel C), fences it to the async proxy and signals the
    consumers on a barrier of its own."""
    assert token in _activation_stage()


@pytest.mark.parametrize("token", ["fence_proxy_async(", "mbar_wait_or_trap(", "tma_load_4d(", "tma_load_3d(",
                                   "wgmma_ss_tb<", "a_ready(", "&amap", "&pmap", "proj_steps", "CONV_ACT",
                                   "act_row(chunk + 1, tap * L::TAP_ROWS / L::TAPS,"])
def test_conv_engine_activation_mode_uses_the_hopper_primitives(token):
    """The activation mode is the engine's: TMA loads (the raw slab, the
    skip's projection box, ws), mbarrier rings whose waits trap, the proxy
    fence between the stage's writes and wgmma, the consumers' share of the
    next slab done while a tap's wgmma runs; no wmma (the engine's
    legacy-path test covers the file)."""
    code = _code(SM90_CONV)
    assert token in code and "wmma::" not in code


def test_k1_faults_share_a_selector():
    """`--only 'resnet conv forward'` selects K1's seven planted faults, all
    in the conv engine, each held to K1's lines of chip_smoke's kernel phase."""
    k1 = [f for f in _planted_faults() if "resnet conv forward" in f[0]]
    assert len(k1) == 7
    assert {f[1] for f in k1} == {"conv_sm90.cuh"}
    assert all(f[4] == ("resnet_conv3x3_stats ",) for f in k1)


def _stage_variants(script: str = "k1_stage_variants"):
    import importlib.util
    import sys

    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(script, ROOT.parent / "scripts" / f"{script}.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path
    return module.VARIANTS


@pytest.mark.parametrize("variant", _stage_variants(), ids=lambda v: v[0])
def test_stage_variant_replaces_text_that_occurs_once(variant):
    """`scripts/k1_stage_variants.py` builds each variant by replacing text
    that occurs exactly once in `conv_sm90.cuh`: a variant whose text drifted
    out of the source would stop the script on the card."""
    text = SM90_CONV.read_text()
    for old, new in variant[1]:
        assert text.count(old) == 1 and old != new, variant[0]


@pytest.mark.parametrize("variant", _stage_variants("k8_variants"), ids=lambda v: v[0])
def test_k8_variant_replaces_text_that_occurs_once(variant):
    """`scripts/k8_variants.py` builds each variant (with k1_stage_variants'
    builder) by replacing text that occurs exactly once in
    `resnet_block_wino.cu`."""
    text = (ROOT / "csrc" / "resnet_block_wino.cu").read_text()
    for old, new in variant[1]:
        assert text.count(old) == 1 and old != new, variant[0]


def _dx_boxes():
    import importlib.util

    spec = importlib.util.spec_from_file_location("time_conv_bwd", ROOT.parent / "scripts" / "time_conv_bwd.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.DX_BOXES


@pytest.mark.parametrize("replacement", _dx_boxes(), ids=lambda r: r[0][:40])
def test_dx_boxes_variant_replaces_text_that_occurs_once(replacement):
    """`scripts/time_conv_bwd.py --dx-boxes` builds K7's box-per-tap dx from
    a copy of `conv_sm90.cuh` by these replacements; a text that drifted
    out of the source would stop the script on the card."""
    old, new = replacement
    assert SM90_CONV.read_text().count(old) == 1 and old != new


# ---------------------------------------------------------------------------
# K2 and K7, the sub-pixel upsample conv and its backward, on the Hopper kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("path,name,calls", [
    ("resnet_block.cu", "ragb_subpixel_upsample_conv3x3_stats", ["launch_conv_sm90<CONV_UP>("]),
    ("resnet_block_bwd.cu", "ragb_subpixel_upsample_conv3x3_stats_bwd",
     ["launch_conv_sm90<CONV_UP_DX>(", "launch_wgrad_sm90<SUBPIXEL_TAPS>(", "launch_dye("]),
])
def test_k2_and_k7_entries_launch_the_hopper_kernels(path, name, calls):
    """K2's C entry launches the conv engine's CONV_UP mode; K7's the dye
    pass, the engine's CONV_UP_DX mode for dx and the TMA + wgmma weight
    gradient's sub-pixel variant for dWf."""
    entry = _c_entry(ROOT / "csrc" / path, name)
    assert all(call in entry for call in calls)


@pytest.mark.parametrize("name", ["ragb_subpixel_upsample_conv3x3_stats", "ragb_subpixel_upsample_conv3x3_stats_bwd"])
@pytest.mark.parametrize("token", ["launch_conv<", "wgrad_kernel<", "launch_wgrad<", "ConvArgs", "wmma", "mma_sync"])
def test_k2_and_k7_entries_launch_no_wmma_kernel(name, token):
    path = ROOT / "csrc" / ("resnet_block_bwd.cu" if name.endswith("_bwd") else "resnet_block.cu")
    assert token not in _c_entry(path, name)


@pytest.mark.parametrize("token", ["MODE_SUBPIXEL", "MODE_DOWN4", "WgradArgs", "ragb_conv_tile_shape", "wgrad_kernel<",
                                   "wgrad_smem_bytes", "launch_wgrad<", "WG_SUBPIXEL"])
def test_first_k2_and_k7_design_is_gone(token):
    """The wmma template's sub-pixel and stride-2 4x4 modes, the wmma weight
    gradient and the wmma tile's export have no launch left, and no code."""
    for path in sorted((ROOT / "csrc").iterdir()):
        assert token not in _code(path), path.name
    assert token not in (ROOT / "ops" / "kernels" / "_build.py").read_text()


def test_resnet_block_forward_no_longer_includes_the_wmma_template():
    assert '#include "conv_taps.cuh"' not in _code(ROOT / "csrc" / "resnet_block.cu")


def test_k2_wrapper_sizes_its_partials_from_the_engine_tile():
    import inspect

    from ragb_vae_tpu_torch.ops.kernels import resnet_block as rb

    wrapper = inspect.getsource(rb.upsample_conv3x3_stats_cuda)
    assert '_tile_shape("ragb_conv_sm90_tile_shape")' in wrapper and "_tile_shape()" not in wrapper


@pytest.mark.parametrize("token", ["CONV_UP", "CONV_UP_DX", "y_view(parity)", "L::w_tap(tap, parity)", "L::a_origin(tap, w0, h0)",
                                   "view_strides", "(UP ? 4 : 1) * tiles_w * tiles_h"])
def test_conv_engine_carries_k2_and_k7_dx(token):
    """K2 and K7's dx are the engine's CONV_UP and CONV_UP_DX modes: per k-step
    the A box's origin and the weights' tap come from the mode, K2 stores
    through a strided view of y per parity and keeps one partial row per
    (parity, tile)."""
    assert token in _code(SM90_CONV)


def test_k2_and_k7_sources_name_what_they_replace_and_their_bound():
    for path in (SM90_CONV, WGRAD_SRC):
        text = path.read_text()
        assert "`_subpixel_bwd_kernel`" in text and ":2003" in text, path.name
        assert "What bounds it on the H100" in text, path.name
    assert "ragb_vae_tpu/ops/pallas/resnet_block.py:231" in SM90_CONV.read_text()
    assert "`_subpixel_kernel`" in SM90_CONV.read_text()


@pytest.mark.parametrize("token", ["SUBPIXEL_TAPS", "L::UP ? 2 * w0 + pb : w0", "dstride", "GROUPS = UP ? 8 : TAPS"])
def test_weight_gradient_carries_k7s_groups(token):
    """K7's dWf is wgrad_sm90.cuh's 2-tap variant: 8 groups (pa, pb, u), dye's
    parity pixels through a box at traversal stride 2 along W."""
    assert token in _code(WGRAD_SRC)


def test_k7_faults_share_a_selector():
    """`--only 'sub-pixel'` selects the ten K2 and K7 faults, each held to
    K2's or K7's lines of chip_smoke's kernel phase."""
    faults = [f for f in _planted_faults() if "sub-pixel" in f[0]]
    assert len(faults) == 10
    assert {f[1] for f in faults} == {"conv_sm90.cuh", "wgrad_sm90.cuh"}
    assert all(f[4] in (("subpixel_upsample_conv3x3_stats ",), ("subpixel_upsample_conv3x3_stats_bwd",))
               for f in faults)


# ---------------------------------------------------------------------------
# K6's dskip on the conv engine's one-tap mode, K8 on wgmma: no wmma or
# mma.sync is left in the port
# ---------------------------------------------------------------------------
WINO_SRC = ROOT / "csrc" / "resnet_block_wino.cu"


@pytest.mark.parametrize("token", ["wmma", "mma_sync", "mma.sync", "mma_16816", "ldmatrix", "cp_async16",
                                   "cp.async.ca", "cp.async.cg", '#include "mma.cuh"', '#include "conv_taps.cuh"'])
@pytest.mark.parametrize("path", sorted((ROOT / "csrc").glob("*.cu*")), ids=lambda p: p.name)
def test_no_legacy_tensor_core_path_is_left(path, token):
    """Every kernel of the port runs on wgmma fed by TMA: no wmma or mma.sync
    fragment, ldmatrix or cp.async staging is left in any source."""
    assert token not in _code(path)


@pytest.mark.parametrize("token", ["wgmma_ss_tb64<", "tma_load_4d(", "tma_load_3d(", "tma_store_4d(",
                                   "mbar_wait_or_trap(", "mbar_arrive_expect_tx(", "setmaxnreg_dec<",
                                   "setmaxnreg_inc<", "named_barrier_sync(", "fence_proxy_async(",
                                   "stats_reduce_kernel<<<", "wino_act_kernel<<<"])
def test_winograd_kernel_uses_the_hopper_primitives(token):
    """K8 is built on csrc/sm90.cuh: TMA loads of the activated slab, U's
    tiles and the skip into mbarrier rings, a producer thread and two
    consumer warpgroups, wgmma products, TMA stores, the fixed-order
    statistics reduce; the activation is a pass of its own."""
    code = _code(WINO_SRC)
    assert '#include "conv_sm90.cuh"' in code and token in code


@pytest.mark.parametrize("token", ["wgmma_ss_tb64<S>(", "wgmma_ss_tb64<Q == 0 ? 1 : -1>(", "IntC<0>", "IntC<1>",
                                   "mu * 4 + (s & 3)", "{1, 2, 2, 1}"])
def test_winograd_kernel_folds_the_output_rows_into_its_products(token):
    """K8 takes the JAX package's row fold: warpgroup p's products of a step
    are V[p + i] U[p + i] with the signs of -U2 and -U3 from wgmma's
    imm-scale-b (p a compile-time constant of the warpgroup's code), U's 16
    unsigned tiles by (mu, nu), and the projection's skip pixels (2 ty + p,
    2 tx + q) read at traversal strides."""
    assert token in _code(WINO_SRC)


def test_signed_wgmma_passes_its_sign_as_imm_scale_b():
    """wgmma_ss_tb64's sign is the instruction's imm-scale-b, an immediate,
    with B MN-major (imm-trans-b 1)."""
    code = _code(ROOT / "csrc" / "sm90.cuh")
    body = code[code.index("void wgmma_ss_tb64("):]
    body = body[:body.index("}\n")]
    assert "p, 1, %35, 0, 1;" in body and '"n"(SB)' in body and "m64n64k16.f32.bf16.bf16" in body


@pytest.mark.parametrize("token", ["CONV_1X1", "L::ONE", "tma_store_commit()", "tma_store_wait_read()",
                                   "wgmma_ss<BN>(", "item += gridDim.y"])
def test_conv_engine_carries_k6_dskip(token):
    """dskip is the engine's one-tap mode: ws as it lies is the K-major B
    operand (wgmma_ss, not the weights' MN-major wgmma_ss_tb), and a block
    walks its tiles with a TMA store in flight beside the next tile's
    products."""
    assert token in _code(SM90_CONV)


def test_k6_wrapper_passes_ws_as_it_lies():
    """dskip reads ws (Cs, N) itself as ws^T's K-major operand: the wrapper
    makes no transposed copy."""
    import inspect

    from ragb_vae_tpu_torch.ops.kernels import resnet_block as rb

    src = inspect.getsource(rb.conv3x3_stats_bwd_cuda)
    assert "wst" not in src and "ws.to(x.dtype).t()" not in src and "ws = ws.to(x.dtype).contiguous()" in src


def test_scan_covers_the_parallel_axes_and_the_png_codec():
    scanned = {str(p.relative_to(ROOT)) for p in SOURCES if p.is_relative_to(ROOT)}
    assert {f"parallel/{name}.py" for name in ("mesh", "sharding", "zero_step")} <= scanned
    assert {"data/native_io.py", "ops/kernels/_build.py", "utils/preemption.py"} <= scanned
    assert "build_rgba_io" in (ROOT / "ops" / "kernels" / "_build.py").read_text()


def _string_constants(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value


def test_nothing_of_the_port_builds_into_the_jax_package():
    """The port builds its kernels and its PNG codec under `<repo>/build/`
    only: the JAX package's `native/Makefile` writes its library into
    `ragb_vae_tpu/data/`, which the port must never build, load or write."""
    from ragb_vae_tpu_torch.ops.kernels import _build

    build = ROOT.parent / "build"
    for target in (_build.BUILD_DIR, _build.HOST_BUILD_DIR, _build.library_path(), _build.rgba_io_path()):
        assert target.resolve().is_relative_to(build), target
        assert not target.resolve().is_relative_to(ROOT.parent / "ragb_vae_tpu")
    assert _build.RGBA_IO_SOURCE.resolve().is_relative_to(ROOT / "csrc")
    for path in SOURCES:
        bad = [s for s in _string_constants(path) if "_libragb_io" in s or "Makefile" in s
               or s in ("make", "native")]
        assert not bad, f"{path} names the JAX package's native build: {bad}"


def test_the_scan_catches_a_build_into_the_jax_package(tmp_path):
    planted = tmp_path / "planted.py"
    planted.write_text('import subprocess\nsubprocess.run(["make", "-C", "native"])\n')
    assert [s for s in _string_constants(planted) if s in ("make", "native")] == ["make", "native"]


# ---------------------------------------------------------------------------
# every launch runs on its tensor's device (`_build.launch`)
# ---------------------------------------------------------------------------
KERNEL_WRAPPERS = sorted(p for p in (ROOT / "ops" / "kernels").glob("*.py") if p.name not in ("_build.py", "__init__.py"))
HOST_EXPORTS = ("ragb_error_string", "ragb_wino_tile_shape", "ragb_conv_sm90_tile_shape")


def _unguarded_library_uses(path: Path):
    """(what, line) of every way `path` reaches the library other than
    `_build.launch` and `_build.query`: `library()`, `stream_ptr`, or an
    export called as an attribute. -> (uses, exports launched through launch)."""
    bad, launched = [], set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Attribute) and (node.attr in ("library", "stream_ptr", "_stream_ptr")
                                                or node.attr.startswith("ragb_")):
            bad.append((node.attr, node.lineno))
        elif isinstance(node, ast.Name) and node.id in ("library", "stream_ptr", "_stream_ptr"):
            bad.append((node.id, node.lineno))
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "launch"
              and node.args and isinstance(node.args[0], ast.Constant)):
            launched.add(node.args[0].value)
    return bad, launched


@pytest.mark.parametrize("path", KERNEL_WRAPPERS, ids=lambda p: p.name)
def test_kernel_wrappers_launch_only_through_the_device_guard(path):
    bad, _ = _unguarded_library_uses(path)
    assert not bad, f"{path.name} reaches the kernel library around `_build.launch`: {bad}"


def test_every_launcher_export_is_launched_through_the_guard():
    from ragb_vae_tpu_torch.ops.kernels import _build

    launched = set().union(*(_unguarded_library_uses(p)[1] for p in KERNEL_WRAPPERS))
    assert launched == set(_build._SIGNATURES) - set(HOST_EXPORTS)
    assert not hasattr(_build, "stream_ptr")     # the raw stream is taken only inside `launch`


def test_the_guard_scan_sees_planted_calls(tmp_path):
    planted = tmp_path / "planted.py"
    planted.write_text(
        "err = _build.library().ragb_conv3x3_same(x, ctypes.c_void_p(_build.stream_ptr(x.device)))\n"
        "lib = library()\n"
        "err = _build.launch('ragb_int8_matmul', x.device, x)\n")
    bad, launched = _unguarded_library_uses(planted)
    assert sorted(what for what, _ in bad) == ["library", "library", "ragb_conv3x3_same", "stream_ptr"]
    assert launched == {"ragb_int8_matmul"}


@pytest.mark.parametrize("current,target", [(0, 1), (1, 1), (2, None)])
def test_launch_makes_the_tensor_device_current_for_the_call(monkeypatch, current, target):
    """On a fake CUDA runtime: the launcher runs with the tensor's device
    current and that device's stream appended; the caller's device is
    restored; nothing is switched when it is current already (an index-less
    device is the current one)."""
    import ctypes

    import torch

    from ragb_vae_tpu_torch.ops.kernels import _build

    state = {"device": current, "sets": []}

    def set_device(i):
        state["sets"].append(i)
        state["device"] = i

    seen = []

    class FakeLibrary:
        def ragb_int8_matmul(self, *args):
            seen.append((state["device"], args))
            return 0

    # a CPU build of torch has none of these: raising=False adds them
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: state["device"], raising=False)
    monkeypatch.setattr(torch._C, "_cuda_setDevice", set_device, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 1000 + i, raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: state["device"])
    monkeypatch.setattr(_build, "library", lambda: FakeLibrary())
    device = torch.device("cuda") if target is None else torch.device("cuda", target)
    assert _build.launch("ragb_int8_matmul", device, 7) == 0
    want = current if target is None else target
    (ran_on, args), = seen
    assert ran_on == want and args[0] == 7 and isinstance(args[1], ctypes.c_void_p) and args[1].value == 1000 + want
    assert state["device"] == current
    assert state["sets"] == ([] if want == current else [want, current])
