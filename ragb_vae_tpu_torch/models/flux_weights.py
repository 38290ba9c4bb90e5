"""FLUX transformer weight interop: diffusers checkpoints and the JAX tree.

Counterpart of `ragb_vae_tpu/models/flux_weights.py` (peft LoRA import and
export are not ported yet). The port's modules carry the diffusers keys, so
a `transformer/` checkpoint (single-file or sharded) loads as it is. The key
map between diffusers names and the JAX package's flax paths is copied from
the JAX package (which the port must not import); it backs
`params_from_flax` / `params_to_flax`, which move one set of weights between
the two packages.
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig
from ragb_vae_tpu_torch.models.weights import load_torch_state, save_torch_state

StateDict = Dict[str, torch.Tensor]

# flax module leaf-names built as LoraDense (frozen kernel under "base")
LORA_TARGET_LEAVES = {
    "to_q", "to_k", "to_v", "to_out_0",
    "add_q_proj", "add_k_proj", "add_v_proj", "to_add_out",
    "net_0_proj", "net_2",
}

_BLOCK_RE = re.compile(r"^(transformer_blocks|single_transformer_blocks)\.(\d+)\.")
_LORA_LEAVES = {"lora_a": "lora_A", "lora_b": "lora_B"}


def _normalize_torch_key(key: str) -> str:
    """diffusers dotted path -> the flax module path (still dotted)."""
    if key.startswith("transformer."):
        key = key[len("transformer."):]
    key = _BLOCK_RE.sub(lambda m: f"{m.group(1)}_{m.group(2)}.", key)
    key = key.replace(".to_out.0.", ".to_out_0.")
    key = key.replace(".net.0.proj.", ".net_0_proj.")
    key = key.replace(".net.2.", ".net_2.")
    if key.startswith("norm_out.linear."):
        key = key.replace("norm_out.linear.", "norm_out_linear.")
    return key


def torch_key_to_flux_path(key: str, ndim: int) -> Tuple[Tuple[str, ...], bool]:
    """diffusers (or port) key -> (flax param path, needs_transpose); ((), False) skips."""
    parts = _normalize_torch_key(key).split(".")
    leaf, module = parts[-1], parts[:-1]
    if not module:
        return (), False
    if leaf in ("lora_A", "lora_B"):
        return tuple(module + [leaf.lower()]), True
    if module[-1] in LORA_TARGET_LEAVES:
        module = module + ["base"]
    if leaf == "weight":
        if ndim == 2:
            return tuple(module + ["kernel"]), True
        return tuple(module + ["weight"]), False
    if leaf == "bias":
        return tuple(module + ["bias"]), False
    return (), False


def flux_path_to_torch_key(path: Tuple[str, ...]) -> Tuple[Optional[str], bool]:
    """flax param path -> (port key, needs_transpose)."""
    parts = list(path)
    leaf, module = parts[-1], parts[:-1]
    if module and module[-1] == "base":
        module = module[:-1]
    if leaf == "kernel":
        torch_leaf, transpose = "weight", True
    elif leaf in ("weight", "bias"):
        torch_leaf, transpose = leaf, False
    elif leaf in _LORA_LEAVES:
        torch_leaf, transpose = _LORA_LEAVES[leaf], True
    else:
        return None, False
    name = ".".join(module)
    name = re.sub(r"^(transformer_blocks|single_transformer_blocks)_(\d+)\.", r"\1.\2.", name)
    name = name.replace(".net_0_proj", ".net.0.proj").replace(".net_2", ".net.2")
    if name.endswith(".to_out_0"):
        name = name[: -len(".to_out_0")] + ".to_out.0"
    if name == "norm_out_linear":
        name = "norm_out.linear"
    return f"{name}.{torch_leaf}", transpose


def _iter_leaves(tree: dict, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _iter_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set_path(tree: dict, path: Tuple[str, ...], value) -> None:
    node = tree
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[path[-1]] = value


def params_from_flax(tree: dict) -> StateDict:
    """The JAX package's FluxTransformer2D tree (nested dicts of arrays) ->
    the port's state dict (fp32 CPU tensors; Dense kernels (in, out) ->
    (out, in)). Loads with `strict=True`."""
    state: StateDict = {}
    for path, value in _iter_leaves(tree):
        key, transpose = flux_path_to_torch_key(path)
        if key is None:
            continue
        arr = np.asarray(value, dtype=np.float32)
        state[key] = torch.from_numpy(np.ascontiguousarray(arr.T if transpose else arr))
    return state


def params_to_flax(state: StateDict) -> dict:
    """Inverse of `params_from_flax`: port state dict -> the JAX tree (numpy)."""
    tree: dict = {}
    for key, value in state.items():
        arr = value.detach().float().cpu().numpy()
        path, transpose = torch_key_to_flux_path(key, arr.ndim)
        if path:
            _set_path(tree, path, np.ascontiguousarray(arr.T if transpose else arr))
    return tree


def flux_state_to_params(state: Dict[str, Union[np.ndarray, torch.Tensor]]) -> StateDict:
    """A diffusers FluxTransformer2DModel state dict (optionally with the
    `transformer.` prefix) -> the port's state dict of fp32 tensors."""
    out: StateDict = {}
    for key, value in state.items():
        if key.startswith("transformer."):
            key = key[len("transformer."):]
        out[key] = torch.as_tensor(value).float()
    return out


def params_to_flux_state(state: StateDict) -> StateDict:
    """The port's state dict -> diffusers checkpoint keys (LoRA adapters,
    which peft stores in a separate file, are left out)."""
    return {k: v for k, v in state.items() if not k.endswith((".lora_A", ".lora_B"))}


# ---------------------------------------------------------------------------
# Checkpoint files (single-file or sharded)
# ---------------------------------------------------------------------------
_WEIGHT_CANDIDATES = (
    "diffusion_pytorch_model.safetensors",
    "diffusion_pytorch_model.bin",
    "pytorch_model.safetensors",
    "pytorch_model.bin",
)


def _load_state_maybe_sharded(directory: Path) -> StateDict:
    index_files = list(directory.glob("*.safetensors.index.json")) + list(
        directory.glob("*.bin.index.json")
    )
    if index_files:
        index = json.loads(index_files[0].read_text())
        state: StateDict = {}
        for shard in sorted(set(index["weight_map"].values())):
            state.update(load_torch_state(directory / shard))
        return state
    for name in _WEIGHT_CANDIDATES:
        if (directory / name).exists():
            return load_torch_state(directory / name)
    raise FileNotFoundError(f"No transformer weights found in {directory}.")


def load_flux_transformer_params(
    model_path: Union[str, Path], subfolder: Optional[str] = "transformer"
) -> Tuple[FluxTransformerConfig, StateDict]:
    directory = Path(model_path) / subfolder if subfolder else Path(model_path)
    config = FluxTransformerConfig.from_json(directory / "config.json")
    return config, flux_state_to_params(_load_state_maybe_sharded(directory))


def save_flux_transformer_params(
    config: FluxTransformerConfig, state: StateDict, output_dir: Union[str, Path]
) -> None:
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    cfg = {
        "_class_name": "FluxTransformer2DModel",
        **{k: (list(v) if isinstance(v, tuple) else v) for k, v in config.__dict__.items()},
    }
    (out / "config.json").write_text(json.dumps(cfg, indent=2))
    save_torch_state(params_to_flux_state(state), out / _WEIGHT_CANDIDATES[0])
