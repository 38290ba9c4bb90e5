"""The port's public surface, held name for name against the JAX package's.

The JAX side is read from its sources by AST, so nothing of JAX is imported.
Every name is one of three things: present in the port, in `RENAMED` (the
port's counterpart under another name or in another module), or in
`NOT_PORTED` with its reason, which cites ROADMAP.md's item 7 or queue C.

- Each name that a `ragb_vae_tpu/**/__init__.py` re-exports (its `__all__`,
  or the lazy map of the top-level package) against the twin package
  (`ops/pallas` is `ops/kernels` in the port).
- Each public top-level function or class, and each public method of a
  class, of every JAX module against its twin module (same path, or
  `MOVED_MODULES`).
- Each flag of every JAX command line parser against its port twin's parser,
  which is taken from the port's entry point as it parses.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_public_surface.py -q
"""
import argparse
import ast
import importlib
import pkgutil
import sys
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_ROOT = REPO / "ragb_vae_tpu"
PORT = "ragb_vae_tpu_torch"
PORT_ROOT = REPO / PORT
SCRIPTS = REPO / "scripts"

# JAX module (path under ragb_vae_tpu/) -> its twin's path under the port
MOVED_MODULES = {
    "ops/buckets.py": "data/buckets.py",
    **{f"ops/pallas/{m}.py": f"ops/kernels/{m}.py"
       for m in ("conv3x3", "flash_attention", "fused_gn_silu_conv", "int8_matmul", "resnet_block")},
}
MOVED_PACKAGES = {"ops.pallas": "ops.kernels"}

_GSPMD = ("item 7: a GSPMD placement; the port's axes are process groups (parallel/mesh.py::Mesh) with "
          "explicit collectives, and no array carries a sharding")
_SLICING = "item 7: the lax.map slicing workaround; vae_slicing is accepted and has no effect"
_FLAX = ("item 7: Flax / optax parameter-tree mechanics; the port's modules own their parameters and a "
         "torch optimizer owns its state")

# JAX qualified name (under ragb_vae_tpu) -> the port's counterpart, "module:attr" under ragb_vae_tpu_torch
RENAMED = {
    "data.loader.device_prefetch": "data.loader:cuda_prefetch",   # a device, not a sharding; pinned side stream
    "models.flux_transformer.QDense": "models.flux_transformer:QLinear",
    "models.flux_transformer.default_attention": "ops.kernels.flash_attention:attention",
    "models.flux_transformer.exact_attention": "ops.kernels.flash_attention:attention_plain",
    "models.flux_weights.is_lora_path": "models.flux_weights:is_lora_key",   # state-dict keys, not tree paths
    "models.lpips.LPIPSParams": "models.lpips:LPIPS",
    "models.lpips.lpips_features": "models.lpips:LPIPS.features",
    "models.weights.torch_state_to_flax_params": "models.weights:params_to_flax",
    "models.weights.flax_params_to_torch_state": "models.weights:params_from_flax",
    "ops.pallas.flash_attention.chunked_attention_3d": "ops.kernels.flash_attention:attention_plain",
    "ops.pallas.flash_attention.flash_attention_fwd_3d": "ops.kernels.flash_attention:flash_attention_cuda",
    "ops.pallas.flash_attention.flash_attention_bwd_3d": "ops.kernels.flash_attention:flash_attention_bwd_cuda",
    # `ops.kernels.int8_matmul` is the submodule, which a package-level function would shadow
    "ops.pallas.int8_matmul.int8_matmul": "ops.kernels.int8_matmul:int8_matmul",
    "parallel.bootstrap.build_tp_mesh": "parallel.bootstrap:build_tp_group",
    "parallel.pipeline.PipelinedFluxTransformer.place_params": "parallel.pipeline:PipelinedFluxTransformer.place_",
    "parallel.tensor_parallel.shard_transformer_params": "parallel.tensor_parallel:shard_transformer_",
}

# JAX qualified name (a module, or a name in one) -> why the port has no counterpart
NOT_PORTED = {
    "utils.compilation_cache": "item 7: the persistent XLA compilation cache is XLA-only",
    "utils.profiling.maybe_start_server": "item 7: jax.profiler's live-capture gRPC server; torch.profiler has none",
    "parallel.mesh.DATA_AXIS": "item 7: the name of a GSPMD mesh axis; the port's axes are process groups "
                               "and no spec names them",
    "parallel.mesh.slice_groups": "item 7: a multi-slice mesh, TPU slices split over DCN",
    "parallel.mesh.create_hybrid_mesh": "item 7: a multi-slice mesh, TPU slices split over DCN",
    "parallel.mesh.batch_sharding": _GSPMD,
    "parallel.mesh.replicated": _GSPMD,
    "parallel.mesh.shard_batch": _GSPMD,
    "parallel.mesh.put_global_batch": _GSPMD,
    "parallel.sharding.replicated_tree": _GSPMD,
    "parallel.sharding.shard_tree": _GSPMD,
    "parallel.tensor_parallel.transformer_param_specs": _GSPMD,
    "parallel.tensor_parallel.sharded_sample_fn": "queue C (one process per device for --tp): every rank runs "
                                                  "FluxTextAlphaModel.sample on its shard",
    "training.vae_step.memory_kind_shardings": _GSPMD + "; init_train_state(offload=) keeps the state on the host",
    "training.vae_step.host_offload_shardings": _GSPMD + "; init_train_state(offload=) keeps the state on the host",
    "parallel.zero_step.init_zero2_state": "item 7: optax ZeRO-2 state; parallel/zero_step.py::ZeroAdamW stands",
    "parallel.zero_step.make_zero2_train_step": "item 7: optax ZeRO-2 step; parallel/zero_step.py::ZeroAdamW stands",
    "parallel.zero_step.zero2_optimizer": "item 7: optax ZeRO-2 optimizer; parallel/zero_step.py::ZeroAdamW stands",
    "parallel.pipeline.PipelineLoraTrainer.place_params": _FLAX,
    "parallel.pipeline.PipelineLoraTrainer.init": _FLAX,
    "models.flux_weights.split_lora_params": _FLAX + " (flux_weights.lora_state / load_lora_state)",
    "models.flux_weights.merge_params": _FLAX + " (flux_weights.lora_state / load_lora_state)",
    "models.rgba_vae.RgbaVAE.init_params": _FLAX,
    "models.vae.AutoencoderKL.setup": _FLAX,
    "models.rgba_vae.RgbaVAE.enable_slicing": _SLICING,
    "models.rgba_vae.RgbaVAE.disable_slicing": _SLICING,
    "models.vae_tiling.sliced_apply": _SLICING,
    "models.vae_tiling.sharded_sliced_apply": _SLICING,
    "ops.pallas.int8_matmul.enable": "queue C (int8): no enable(); the int8 route is the only one on the card",
}

# public names that are instance attributes in the port, with a factory of an instance
INSTANCE_ATTRIBUTES = {
    "utils.metrics_logger.MetricsLogger.path": lambda: importlib.import_module(
        f"{PORT}.utils.metrics_logger").MetricsLogger(None),
}


def _dotted(rel: Path) -> str:
    return ".".join(rel.with_suffix("").parts) if rel.parts else ""


def _resolve(obj, dotted: str):
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def _port_module(rel: str):
    return importlib.import_module(f"{PORT}.{rel}" if rel else PORT)


def _renamed_target(key: str):
    module, attr = RENAMED[key].split(":")
    return _resolve(_port_module(module), attr)


def _covered(key: str) -> bool:
    if key in RENAMED:
        _renamed_target(key)        # raises if the counterpart went away
        return True
    return key in NOT_PORTED


# ---------------------------------------------------------------------------
# the JAX side, by AST
# ---------------------------------------------------------------------------
def _reexports(init: Path):
    """[(name, JAX module it comes from)] of one `__init__.py`: its `__all__`
    (an alias assigned in the package comes from the package), or the keys
    of the lazy map in its `__getattr__`."""
    package = _dotted(init.parent.relative_to(JAX_ROOT))
    tree = ast.parse(init.read_text())
    source = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                source[alias.asname or alias.name] = node.module.removeprefix("ragb_vae_tpu").lstrip(".")
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return [(e.value, source.get(e.value, package)) for e in node.value.elts]
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            return [(k.value, v.value.removeprefix("ragb_vae_tpu").lstrip(".")) for k, v in zip(node.keys, node.values)]
    return []


def _public_names(path: Path):
    """Public top-level functions and classes, and `Class.method` for each
    public method (properties included) of a public class."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{sub.name}" for sub in node.body
                          if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and not sub.name.startswith("_")]
    return names


def _add_argument_calls(tree):
    return [node for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument"]


def _flags(path: Path, seen=None):
    """Option strings of every `add_argument` in `path`; a file with none
    (a shim) takes those of the JAX modules and sibling scripts it imports."""
    seen = set() if seen is None else seen
    seen.add(path)
    tree = ast.parse(path.read_text())
    found = {a.value for node in _add_argument_calls(tree)
             for a in node.args if isinstance(a, ast.Constant) and str(a.value).startswith("-")}
    if found:
        return found
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            parts = node.module.split(".")
            if parts[0] == "ragb_vae_tpu":
                target = REPO.joinpath(*parts).with_suffix(".py")
            else:
                target = path.parent / f"{node.module}.py"
            if target.exists() and target not in seen:
                found |= _flags(target, seen)
    return found


JAX_INITS = sorted(JAX_ROOT.rglob("__init__.py"))
JAX_MODULES = sorted(p for p in JAX_ROOT.rglob("*.py") if p.name != "__init__.py")
# the JAX package's scripts: those with a `_torch` twin and those that import the package
JAX_SCRIPTS = sorted(p for p in SCRIPTS.glob("*.py") if not p.stem.endswith("_torch") and (
    (SCRIPTS / f"{p.stem}_torch.py").exists()
    or any(n.module.split(".")[0] == "ragb_vae_tpu" for n in ast.walk(ast.parse(p.read_text()))
           if isinstance(n, ast.ImportFrom) and n.module)))


def _twin_package(init: Path) -> str:
    rel = _dotted(init.parent.relative_to(JAX_ROOT))
    return MOVED_PACKAGES.get(rel, rel)


def _twin_module(path: Path):
    rel = path.relative_to(JAX_ROOT).as_posix()
    twin = PORT_ROOT / MOVED_MODULES.get(rel, rel)
    return twin if twin.exists() else None


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("init", JAX_INITS, ids=lambda p: str(p.parent.relative_to(REPO)))
def test_every_package_reexport_has_a_counterpart(init):
    names = _reexports(init)
    assert names, f"no re-exports read from {init}"
    jax_package = _dotted(init.parent.relative_to(JAX_ROOT))
    package = _port_module(_twin_package(init))
    missing = []
    for name, source in names:
        value = getattr(package, name, None)
        if value is not None and not isinstance(value, types.ModuleType):     # a submodule is no re-export
            continue
        if not any(_covered(k) for k in (f"{jax_package}.{name}".lstrip("."), f"{source}.{name}")):
            missing.append(name)
    assert not missing, f"{package.__name__} lacks {missing} (JAX {init.relative_to(REPO)})"


@pytest.mark.parametrize("path", JAX_MODULES, ids=lambda p: str(p.relative_to(JAX_ROOT)))
def test_every_public_name_of_a_module_has_a_counterpart(path):
    key = _dotted(path.relative_to(JAX_ROOT))
    twin = _twin_module(path)
    if twin is None:
        assert key in NOT_PORTED, f"{path.relative_to(REPO)} has no twin in the port"
        return
    module = importlib.import_module(f"{PORT}.{_dotted(twin.relative_to(PORT_ROOT))}")
    missing = []
    for name in _public_names(path):
        qualified = f"{key}.{name}"
        try:
            _resolve(module, name)
            continue
        except AttributeError:
            pass
        if qualified in INSTANCE_ATTRIBUTES:
            _resolve(INSTANCE_ATTRIBUTES[qualified](), name.split(".")[-1])
            continue
        if not _covered(qualified):
            missing.append(name)
    assert not missing, f"{module.__name__} lacks {missing} (JAX {path.relative_to(REPO)})"


PORT_PACKAGES = sorted(p.parent for p in PORT_ROOT.rglob("__init__.py") if "csrc" not in p.parts)


@pytest.mark.parametrize("path", PORT_PACKAGES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_package_level_name_shadows_a_submodule(path):
    """A lazy export named like a submodule would replace the module in its
    package once looked up, and `from package import submodule` would then
    hand out the function."""
    package = _port_module(_dotted(path.relative_to(PORT_ROOT)))
    submodules = {m.name for m in pkgutil.iter_modules([str(path)])}
    assert not submodules & set(getattr(package, "__all__", ()))


def test_the_maps_name_real_jax_names_and_cite_the_roadmap():
    known = set()
    for path in JAX_MODULES:
        key = _dotted(path.relative_to(JAX_ROOT))
        known.add(key)
        known |= {f"{key}.{name}" for name in _public_names(path)}
    for init in JAX_INITS:
        known |= {f"{source}.{name}" for name, source in _reexports(init)}
    known |= {f"scripts/{p.name}" for p in JAX_SCRIPTS}
    stale = sorted((set(RENAMED) | set(NOT_PORTED) | set(INSTANCE_ATTRIBUTES)) - known)
    assert not stale, f"map entries that name no JAX name: {stale}"
    assert not set(RENAMED) & set(NOT_PORTED)
    for key, reason in NOT_PORTED.items():
        assert reason.startswith(("item 7", "queue C")), f"{key}: {reason!r} cites neither item 7 nor queue C"


class _Parser(Exception):
    pass


def _port_parser(monkeypatch, call) -> argparse.ArgumentParser:
    """The parser a port entry point builds, taken at its parse call."""
    def grab(self, *args, **kwargs):
        raise _Parser(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_known_args", grab)
    monkeypatch.setattr(sys, "argv", ["prog"])
    with pytest.raises(_Parser) as info:
        call()
    return info.value.args[0]


def _main_of(directory: Path, name: str):
    """Calls `main()` of the script `<directory>/<name>.py`; sys.path as it was after."""
    def call():
        saved = list(sys.path)
        sys.path.insert(0, str(directory))
        try:
            module = importlib.import_module(name)
        finally:
            sys.path[:] = saved
        module.main()
    return call


def _package_call(module, function, *args):
    return lambda: getattr(importlib.import_module(f"{PORT}.{module}"), function)(*args)


CLI_PAIRS = {
    "ragb_vae_tpu/inference.py": _package_call("inference", "parse_args", []),
    "ragb_vae_tpu/serving_daemon.py": _package_call("serving_daemon", "parse_args", []),
    "ragb_vae_tpu/_cli.py": _package_call("_cli", "run_training", []),
    "ragb_vae_tpu/training/flux_kontext_textalpha_lora.py": _package_call(
        "training.flux_kontext_textalpha_lora", "parse_args", []),
    "inference_rgba_flux.py": _main_of(REPO, "inference_rgba_flux_torch"),
    **{f"scripts/{p.name}": _main_of(SCRIPTS, f"{p.stem}_torch") for p in JAX_SCRIPTS
       if f"scripts/{p.name}" not in NOT_PORTED},
}


def test_every_jax_command_line_has_a_twin():
    jax_clis = {str(p.relative_to(REPO)) for p in JAX_MODULES if _add_argument_calls(ast.parse(p.read_text()))}
    jax_clis |= {f"scripts/{p.name}" for p in JAX_SCRIPTS} | {"inference_rgba_flux.py"}
    assert jax_clis - set(NOT_PORTED) == set(CLI_PAIRS)


@pytest.mark.parametrize("jax_cli", sorted(CLI_PAIRS))
def test_port_parser_accepts_every_jax_flag(monkeypatch, jax_cli):
    flags = _flags(REPO / jax_cli)
    assert flags, f"no flags read from {jax_cli}"
    parser = _port_parser(monkeypatch, CLI_PAIRS[jax_cli])
    missing = sorted(f for f in flags if f not in parser._option_string_actions)
    assert not missing, f"the port's twin of {jax_cli} does not accept {missing}"
