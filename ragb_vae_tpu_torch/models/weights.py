"""VAE weight interop: diffusers checkpoints and the JAX package's trees.

Counterpart of `ragb_vae_tpu/models/weights.py`. The port's modules already
carry the diffusers state-dict keys, so a checkpoint loads as it is; the key
map between those keys and the JAX package's flax paths (copied from the
JAX package, which the port must not import) serves `params_from_flax` /
`params_to_flax`, which move one set of weights between the two packages.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig

StateDict = Dict[str, torch.Tensor]

WEIGHT_FILENAMES = ("diffusion_pytorch_model.safetensors", "pytorch_model.bin")


# ---------------------------------------------------------------------------
# Checkpoint files
# ---------------------------------------------------------------------------
def load_torch_state(weight_file: Union[str, Path]) -> StateDict:
    """Read a .safetensors or torch .bin checkpoint into CPU tensors."""
    weight_file = Path(weight_file)
    if weight_file.suffix == ".safetensors":
        from safetensors.torch import load_file

        return dict(load_file(str(weight_file)))
    state = torch.load(weight_file, map_location="cpu", weights_only=True)
    return {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}


def iter_torch_state(weight_file: Union[str, Path]):
    """(key, CPU tensor) of every entry of a .safetensors or torch .bin
    checkpoint, one at a time: a .safetensors file is read a tensor at a
    time, a .bin file is memory-mapped."""
    weight_file = Path(weight_file)
    if weight_file.suffix == ".safetensors":
        from safetensors import safe_open

        with safe_open(str(weight_file), framework="pt") as handle:
            for key in handle.keys():
                yield key, handle.get_tensor(key)
        return
    state = torch.load(weight_file, map_location="cpu", weights_only=True, mmap=True)
    yield from ((k, v) for k, v in state.items() if isinstance(v, torch.Tensor))


def save_torch_state(state: StateDict, weight_file: Union[str, Path]) -> None:
    from safetensors.torch import save_file

    Path(weight_file).parent.mkdir(parents=True, exist_ok=True)
    save_file({k: v.detach().cpu().contiguous() for k, v in state.items()}, str(weight_file))


# ---------------------------------------------------------------------------
# Key map: diffusers names <-> the JAX package's flax module paths
# ---------------------------------------------------------------------------
_TORCH_TO_FLAX_RULES = [
    (re.compile(r"down_blocks\.(\d+)\.resnets\.(\d+)"), r"down_blocks_\1_resnets_\2"),
    (re.compile(r"down_blocks\.(\d+)\.downsamplers\.0"), r"down_blocks_\1_downsample"),
    (re.compile(r"up_blocks\.(\d+)\.resnets\.(\d+)"), r"up_blocks_\1_resnets_\2"),
    (re.compile(r"up_blocks\.(\d+)\.upsamplers\.0"), r"up_blocks_\1_upsample"),
    (re.compile(r"mid_block\.resnets\.(\d+)"), r"mid_block.resnets_\1"),
    (re.compile(r"mid_block\.attentions\.0"), r"mid_block.attention"),
    (re.compile(r"to_out\.0"), r"to_out"),
]

_FLAX_TO_TORCH_RULES = [
    (re.compile(r"down_blocks_(\d+)_resnets_(\d+)"), r"down_blocks.\1.resnets.\2"),
    (re.compile(r"down_blocks_(\d+)_downsample"), r"down_blocks.\1.downsamplers.0"),
    (re.compile(r"up_blocks_(\d+)_resnets_(\d+)"), r"up_blocks.\1.resnets.\2"),
    (re.compile(r"up_blocks_(\d+)_upsample"), r"up_blocks.\1.upsamplers.0"),
    (re.compile(r"mid_block\.resnets_(\d+)"), r"mid_block.resnets.\1"),
    (re.compile(r"mid_block\.attention\b"), r"mid_block.attentions.0"),
    (re.compile(r"\bto_out\b"), r"to_out.0"),
]


def torch_key_to_flax_path(key: str, ndim: int) -> Tuple[Tuple[str, ...], Optional[Tuple[int, ...]]]:
    """diffusers key -> (flax tree path, transpose axes or None)."""
    name = key
    for pat, repl in _TORCH_TO_FLAX_RULES:
        name = pat.sub(repl, name)
    parts = name.split(".")
    leaf = parts[-1]
    transpose = None
    if leaf == "weight":
        if ndim == 4:  # conv OIHW -> HWIO
            leaf, transpose = "kernel", (2, 3, 1, 0)
        elif ndim == 2:  # linear (out, in) -> (in, out)
            leaf, transpose = "kernel", (1, 0)
        else:  # norm scale
            leaf = "scale"
    return tuple(parts[:-1] + [leaf]), transpose


def flax_path_to_torch_key(path: Tuple[str, ...], ndim: int) -> Tuple[str, Optional[Tuple[int, ...]]]:
    """flax tree path -> (diffusers key, transpose axes or None)."""
    parts = list(path)
    leaf = parts[-1]
    transpose = None
    if leaf == "kernel":
        leaf = "weight"
        transpose = (3, 2, 0, 1) if ndim == 4 else (1, 0)
    elif leaf == "scale":
        leaf = "weight"
    name = ".".join(parts[:-1] + [leaf])
    for pat, repl in _FLAX_TO_TORCH_RULES:
        name = pat.sub(repl, name)
    return name, transpose


def _iter_leaves(tree: dict, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _iter_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set_path(tree: dict, path: Tuple[str, ...], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def params_from_flax(tree: dict) -> StateDict:
    """The JAX package's VAE parameter tree (nested dicts of arrays) -> the
    port's state dict (fp32 CPU tensors): conv kernels HWIO -> OIHW, dense
    kernels (in, out) -> (out, in). Loads with `strict=True`; the module's
    own dtype and device are kept, so an fp32 module (training's master
    parameters) receives the values unrounded."""
    state: StateDict = {}
    for path, value in _iter_leaves(tree):
        arr = np.asarray(value, dtype=np.float32)
        key, transpose = flax_path_to_torch_key(path, arr.ndim)
        if transpose is not None:
            arr = arr.transpose(transpose)
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def params_to_flax(state: StateDict, *, strip_prefix: str = "vae.") -> dict:
    """Inverse of `params_from_flax`: a diffusers-keyed state dict -> the
    JAX package's tree of fp32 numpy arrays. Keys may carry the `vae.` prefix
    the reference writes into `rgba_vae.pt`."""
    tree: dict = {}
    for key, value in state.items():
        if strip_prefix and key.startswith(strip_prefix):
            key = key[len(strip_prefix):]
        arr = value.detach().float().cpu().numpy()
        path, transpose = torch_key_to_flax_path(key, arr.ndim)
        if transpose is not None:
            arr = arr.transpose(transpose)
        _set_path(tree, path, np.ascontiguousarray(arr))
    return tree


def grads_to_flax(module: torch.nn.Module) -> dict:
    """The gradients a backward left in `module`'s parameters, as the JAX
    package's tree of fp32 numpy arrays (kernels transposed like the
    parameters themselves), so a test compares gradient trees leaf by leaf.
    Raises on a parameter without a gradient."""
    missing = [name for name, p in module.named_parameters() if p.grad is None]
    if missing:
        raise ValueError(f"parameters without a gradient: {missing}")
    return params_to_flax({name: p.grad for name, p in module.named_parameters()}, strip_prefix="")


# ---------------------------------------------------------------------------
# RGB -> RGBA widening
# ---------------------------------------------------------------------------
def adapt_params_to_rgba(
    state: StateDict, config: AutoencoderConfig, *, alpha_bias_init: float = 0.0
) -> Tuple[StateDict, AutoencoderConfig]:
    """Widen encoder.conv_in (in 3->4) and decoder.conv_out (out 3->4) with a
    zero alpha path (OIHW: conv_in widens axis 1, conv_out axis 0 and its
    bias). No-op on convs that are already 4 wide."""
    state = dict(state)
    cfg = AutoencoderConfig(**{**config.__dict__})
    k = state["encoder.conv_in.weight"]
    if k.shape[1] != 4:
        widened = torch.zeros((k.shape[0], 4) + tuple(k.shape[2:]), dtype=k.dtype)
        widened[:, :3] = k
        state["encoder.conv_in.weight"] = widened
    k = state["decoder.conv_out.weight"]
    if k.shape[0] != 4:
        widened = torch.zeros((4,) + tuple(k.shape[1:]), dtype=k.dtype)
        widened[:3] = k
        state["decoder.conv_out.weight"] = widened
        bias = state.get("decoder.conv_out.bias", torch.zeros(3, dtype=k.dtype))
        new_bias = torch.zeros(4, dtype=bias.dtype)
        new_bias[:3] = bias
        new_bias[3] = alpha_bias_init
        state["decoder.conv_out.bias"] = new_bias
    cfg.in_channels = 4
    cfg.out_channels = 4
    return state, cfg


def assert_finite_convs(state: StateDict) -> None:
    for name in ("encoder.conv_in.weight", "decoder.conv_out.weight"):
        if not torch.isfinite(state[name]).all():
            raise RuntimeError(f"{name} contains NaN/Inf after loading checkpoint.")


# ---------------------------------------------------------------------------
# High-level load / save
# ---------------------------------------------------------------------------
def _locate_weight_file(directory: Path) -> Path:
    for filename in WEIGHT_FILENAMES:
        if (directory / filename).exists():
            return directory / filename
    raise FileNotFoundError(f"No weight file ({WEIGHT_FILENAMES}) in {directory}")


def load_autoencoder_params(
    model_path: Union[str, Path],
    subfolder: Optional[str] = None,
    *,
    adapt_to_rgba: bool = False,
    alpha_bias_init: float = 0.0,
) -> Tuple[AutoencoderConfig, StateDict]:
    """Load an HF-format AutoencoderKL dir into (config, state dict).

    Accepts bare diffusers keys and the `vae.`-prefixed keys of the
    reference's `rgba_vae.pt`. With `adapt_to_rgba`, RGB checkpoints are
    widened; checkpoints whose convs are already 4 wide load untouched."""
    ckpt_dir = Path(model_path) / subfolder if subfolder else Path(model_path)
    if not ckpt_dir.exists():
        raise FileNotFoundError(f"Checkpoint directory not found: {ckpt_dir}")
    config = AutoencoderConfig.from_json(ckpt_dir / "config.json")
    state = {
        (k[len("vae."):] if k.startswith("vae.") else k): v.float()
        for k, v in load_torch_state(_locate_weight_file(ckpt_dir)).items()
    }
    if state["encoder.conv_in.weight"].shape[1] == 4:
        config.in_channels = 4
        config.out_channels = 4
    elif adapt_to_rgba:
        state, config = adapt_params_to_rgba(state, config, alpha_bias_init=alpha_bias_init)
    assert_finite_convs(state)
    return config, state


def save_autoencoder_params(
    config: AutoencoderConfig, state: StateDict, output_dir: Union[str, Path]
) -> None:
    """Export to HF format: config.json + diffusion_pytorch_model.safetensors."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    config.to_json(out / "config.json")
    save_torch_state(state, out / WEIGHT_FILENAMES[0])
