"""FLUX transformer weight interop: diffusers checkpoints and the JAX tree.

Counterpart of `ragb_vae_tpu/models/flux_weights.py`. The port's modules
carry the diffusers keys, so a `transformer/` checkpoint (single-file or
sharded) loads as it is. The key map between diffusers names and the JAX
package's flax paths is copied from the JAX package (which the port must not
import); it backs `params_from_flax` / `params_to_flax`, which move one set
of weights between the two packages, an int8 tree's `kernel_q` /
`kernel_scale` included (`weight_q` / `weight_scale` on the port's modules,
`weight_q` transposed to (out, in)). LoRA adapters live on the module
(`lora_parameters`, `lora_state`, `load_lora_state`) and travel in peft's
file format, which both packages read and write.
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig
from ragb_vae_tpu_torch.models.weights import iter_torch_state, save_torch_state

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
    if leaf == "weight_q":
        return tuple(module + ["kernel_q"]), True
    if leaf == "weight_scale":
        return tuple(module + ["kernel_scale"]), False
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
    elif leaf == "kernel_q":
        torch_leaf, transpose = "weight_q", True
    elif leaf == "kernel_scale":
        torch_leaf, transpose = "weight_scale", False
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


def iter_leaves(tree: dict, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from iter_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set_path(tree: dict, path: Tuple[str, ...], value) -> None:
    node = tree
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[path[-1]] = value


def params_from_flax(tree: dict) -> StateDict:
    """The JAX package's FluxTransformer2D tree (nested dicts of arrays or
    tensors) -> the port's state dict (fp32 tensors, int8 for `kernel_q`;
    Dense kernels (in, out) -> (out, in); a tensor stays on its device).
    Loads with `strict=True` into a transformer of the tree's weight mode."""
    state: StateDict = {}
    for path, value in iter_leaves(tree):
        key, transpose = flux_path_to_torch_key(path)
        if key is None:
            continue
        if isinstance(value, torch.Tensor):
            t = value.to(torch.int8 if path[-1] == "kernel_q" else torch.float32)
        else:
            t = torch.from_numpy(np.asarray(value, dtype=np.int8 if path[-1] == "kernel_q" else np.float32))
        state[key] = (t.t() if transpose else t).contiguous()
    return state


def params_to_flax(state: StateDict) -> dict:
    """Inverse of `params_from_flax`: port state dict -> the JAX tree (numpy;
    fp32, int8 for `kernel_q`)."""
    tree: dict = {}
    for key, value in state.items():
        value = value.detach().cpu()
        arr = (value if value.dtype == torch.int8 else value.float()).numpy()
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
    return {k: v for k, v in state.items() if not is_lora_key(k)}


# ---------------------------------------------------------------------------
# LoRA adapters on a module, and peft interop
# ---------------------------------------------------------------------------
def is_lora_key(key: str) -> bool:
    return key.rsplit(".", 1)[-1] in ("lora_A", "lora_B")


def lora_parameters(module: torch.nn.Module) -> Dict[str, torch.nn.Parameter]:
    """The module's adapters by name (`<linear>.lora_A` / `.lora_B`), in module
    order: what the optimizer trains (the lora half of `split_lora_params`)."""
    return {k: p for k, p in module.named_parameters() if is_lora_key(k)}


def lora_state(module: torch.nn.Module) -> StateDict:
    """Detached fp32 CPU copies of the adapters. Only the adapters are
    fetched: the frozen base never leaves the device."""
    return {k: p.detach().to("cpu", torch.float32, copy=True) for k, p in lora_parameters(module).items()}


@torch.no_grad()
def load_lora_state(module: torch.nn.Module, state: StateDict) -> None:
    """Copy `state` into the module's adapters (the counterpart of
    `merge_params`); the key sets and shapes must agree."""
    params = lora_parameters(module)
    if set(params) != set(state):
        missing, extra = sorted(set(params) - set(state)), sorted(set(state) - set(params))
        raise KeyError(f"LoRA state does not fit the module: missing {missing[:3]} "
                       f"({len(missing)}), unexpected {extra[:3]} ({len(extra)})")
    for key, p in params.items():
        if p.shape != state[key].shape:
            raise ValueError(f"{key}: adapter shape {tuple(state[key].shape)} != {tuple(p.shape)}")
        p.copy_(state[key])


def lora_params_to_peft_state(lora: StateDict) -> StateDict:
    """Adapters by module name -> peft `transformer.<mod>.lora_A.weight`
    (r, in) / `lora_B.weight` (out, r), the key format
    FluxPipeline.save_lora_weights writes (the port's layout already)."""
    return {f"transformer.{key}.weight": value.detach().float().cpu() for key, value in lora.items()}


def peft_state_to_lora_params(state: Dict[str, Union[np.ndarray, torch.Tensor]]) -> StateDict:
    """A peft LoRA state dict -> adapters by module name. The `transformer.`
    prefix and peft's nested `.default` adapter names are stripped; keys that
    are no adapter are skipped."""
    lora: StateDict = {}
    for key, value in state.items():
        for marker, leaf in ((".lora_A.", "lora_A"), (".lora_B.", "lora_B")):
            if marker in key:
                name = key.split(marker)[0].replace(".default", "")
                if name.startswith("transformer."):
                    name = name[len("transformer."):]
                lora[f"{name}.{leaf}"] = torch.as_tensor(value).float()
    return lora


def lora_grads_to_flax(module: torch.nn.Module) -> dict:
    """The adapters' `.grad` in the JAX lora tree's layout (lora_a (in, r),
    lora_b (r, out), numpy): what `jax.grad` over the lora tree returns."""
    tree: dict = {}
    for key, p in lora_parameters(module).items():
        if p.grad is None:
            raise ValueError(f"{key} has no gradient")
        path, _ = torch_key_to_flux_path(key, 2)
        _set_path(tree, path, np.ascontiguousarray(p.grad.detach().float().cpu().numpy().T))
    return tree


# ---------------------------------------------------------------------------
# Checkpoint files (single-file or sharded)
# ---------------------------------------------------------------------------
_WEIGHT_CANDIDATES = (
    "diffusion_pytorch_model.safetensors",
    "diffusion_pytorch_model.bin",
    "pytorch_model.safetensors",
    "pytorch_model.bin",
)


def _weight_files(directory: Path):
    index_files = list(directory.glob("*.safetensors.index.json")) + list(
        directory.glob("*.bin.index.json")
    )
    if index_files:
        index = json.loads(index_files[0].read_text())
        return [directory / shard for shard in sorted(set(index["weight_map"].values()))]
    for name in _WEIGHT_CANDIDATES:
        if (directory / name).exists():
            return [directory / name]
    raise FileNotFoundError(f"No transformer weights found in {directory}.")


def load_flux_transformer_params(
    model_path: Union[str, Path], subfolder: Optional[str] = "transformer", *, take=None
) -> Tuple[FluxTransformerConfig, StateDict]:
    """(config, the port's fp32 state dict) of a diffusers checkpoint, read
    one tensor at a time. With `take(key, full) -> part` (a tensor-parallel
    rank's slice) each entry is cut and copied as it is read, so the host
    never holds more than this rank's part and one full tensor."""
    directory = Path(model_path) / subfolder if subfolder else Path(model_path)
    config = FluxTransformerConfig.from_json(directory / "config.json")
    state: StateDict = {}
    for path in _weight_files(directory):
        for key, value in iter_torch_state(path):
            key = key[len("transformer."):] if key.startswith("transformer.") else key
            full = value.float()
            part = full if take is None else take(key, full)
            state[key] = part.clone() if part.numel() != full.numel() else part
    return config, state


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
