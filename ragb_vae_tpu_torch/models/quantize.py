"""Weight-only int8 quantisation of the FLUX transformer's linears.

Counterpart of `ragb_vae_tpu/models/quantize.py`. Every Dense kernel becomes
int8 with one fp32 scale per output channel (symmetric, scale = max|w| / 127
per column); everything else (biases, LoRA adapters, RMSNorm weights) passes
through untouched. Each layer multiplies by its int8 weights directly
(`ops/kernels/int8_matmul.py`): no whole weight is dequantised.

The functions work on tensors where they live (torch ops, one kernel at a
time), so a model already on the card is quantised there. Trees are nested
dicts in the JAX package's names and layout ({kernel: (in, out)} ->
{kernel_q, kernel_scale}), and the on-disk format (`quantization.json`,
`quantized_params.npz` with flat `a/b/c` keys, `config.json`) interchanges
with the JAX package in both directions. `quantize_module_` rewrites a built
`FluxTransformer2D` in place instead.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ragb_vae_tpu_torch.device import resolve_device

PyTree = Any

_QUANT_MARKER = "quantization.json"
_QUANT_WEIGHTS = "quantized_params.npz"
_PATH_SEP = "/"


def _is_dense_params(node: Any) -> bool:
    return isinstance(node, dict) and "kernel" in node and getattr(node["kernel"], "ndim", 0) == 2


def quantize_kernel(kernel, device=None, reduce_absmax=None) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8 of a kernel (in, out):
    scale = max|w| / 127 per column (1 for an all-zero column). `torch.round`
    rounds half to even, as `np.round` does. The arithmetic runs where the
    kernel lives, or on `device` when one is named, and the result stays
    there. `reduce_absmax(absmax)` turns the per-column max of these rows
    into that of the whole kernel: a row shard of a tensor-parallel layer
    (some of the input rows) passes the max over its model group, so its int8
    rows and its scale are the whole kernel's, bit for bit (max is exact)."""
    w = torch.as_tensor(kernel).to(device=device, dtype=torch.float32)
    absmax = w.abs().amax(dim=0)
    if reduce_absmax is not None:
        absmax = reduce_absmax(absmax)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return {"kernel_q": q, "kernel_scale": scale}


def dequantize_kernel(kernel_q, kernel_scale) -> torch.Tensor:
    return torch.as_tensor(kernel_q).float() * torch.as_tensor(kernel_scale).float()[None, :]


def quantize_transformer_params(params: PyTree, device=None) -> PyTree:
    """Rewrite every Dense {kernel, bias?} of a FLUX transformer tree to
    {kernel_q, kernel_scale, bias?}; other leaves keep their values. Each
    kernel is quantised where it lives, or moved to `device` first (one float
    kernel there at a time)."""

    def walk(node: Any) -> Any:
        if _is_dense_params(node):
            out = dict(node)
            out.update(quantize_kernel(out.pop("kernel"), device))
            return out
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(params)


def random_quantized_params_like(shape_tree: PyTree, seed: int = 0, device="cuda") -> PyTree:
    """Random int8 params matching an UNQUANTISED tree's shapes (leaves need
    only a `.shape`), drawn leaf by leaf on `device` from `seed`: the
    quantised tree of a model too large to build in bf16 first. Scales are
    3 / sqrt(in) / 127, about what a quantised lecun-normal layer carries, so
    activations stay O(1)."""
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(seed)

    def walk(node: Any) -> Any:
        if _is_dense_params(node):
            in_f, features = node["kernel"].shape
            out = {
                "kernel_q": torch.randint(-127, 128, (in_f, features), generator=gen, device=device,
                                          dtype=torch.int8),
                "kernel_scale": torch.full((features,), 3.0 / np.sqrt(in_f) / 127.0,
                                           dtype=torch.float32, device=device),
            }
            if "bias" in node:
                out["bias"] = torch.zeros(tuple(node["bias"].shape), dtype=torch.float32, device=device)
            return out
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return torch.randn(tuple(node.shape), generator=gen, device=device) * 0.02

    return walk(shape_tree)


@torch.no_grad()
def quantize_module_(transformer: torch.nn.Module, device=None, dtype=None) -> torch.nn.Module:
    """Turn every linear of a built `FluxTransformer2D` (or of one of its
    modules: a pipeline stage's block) into its int8 form in
    place, one layer at a time, on the device it lives on or on `device` (the
    float weight is freed as soon as its int8 copy exists). `dtype`: what the
    linears then compute in (default: each weight's own); the AdaLN
    modulation stays fp32. An FSDP-sharded transformer quantises its parts
    (`parallel/fsdp.py::quantize_sharded_`)."""
    from ragb_vae_tpu_torch.models.flux_transformer import Fp32Linear, QLinear

    if getattr(transformer, "fsdp", None) is not None:
        from ragb_vae_tpu_torch.parallel.fsdp import quantize_sharded_

        return quantize_sharded_(transformer, device, dtype)
    for module in transformer.modules():
        if isinstance(module, QLinear):
            module.quantize_(device, None if isinstance(module, Fp32Linear) else dtype)
    if hasattr(transformer, "weight_quant"):     # not a pipeline stage's block
        transformer.weight_quant = "int8"
    return transformer


# ---------------------------------------------------------------------------
# On-disk quantised checkpoints (flat npz: safetensors' torch-key mapping
# cannot carry the {kernel_q, kernel_scale} split)
# ---------------------------------------------------------------------------
def is_quantized_checkpoint(directory) -> bool:
    return (Path(directory) / _QUANT_MARKER).exists()


def save_quantized_transformer(config, qparams: PyTree, output_dir) -> None:
    """config.json + quantized_params.npz (flat `a/b/c` keys, dtypes kept) +
    the marker file."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    flat: Dict[str, np.ndarray] = {}

    def walk(node: Any, prefix: str) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{_PATH_SEP}{k}" if prefix else k)
        else:
            flat[prefix] = node.detach().cpu().numpy() if isinstance(node, torch.Tensor) else np.asarray(node)

    walk(qparams, "")
    np.savez(out / _QUANT_WEIGHTS, **flat)
    cfg = {k: (list(v) if isinstance(v, tuple) else v) for k, v in config.__dict__.items()}
    (out / "config.json").write_text(json.dumps(cfg, indent=2))
    (out / _QUANT_MARKER).write_text(
        json.dumps({"format": "weight_only_int8", "scheme": "per_output_channel_symmetric"})
    )


def load_quantized_transformer(directory) -> Tuple[Any, PyTree]:
    """Inverse of `save_quantized_transformer` -> (FluxTransformerConfig,
    nested tree of numpy arrays)."""
    from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig

    d = Path(directory)
    if not is_quantized_checkpoint(d):
        raise FileNotFoundError(f"{d} is not a quantized checkpoint (no {_QUANT_MARKER}).")
    config = FluxTransformerConfig.from_json(d / "config.json")
    data = np.load(d / _QUANT_WEIGHTS)
    params: Dict[str, Any] = {}
    for key in data.files:
        node = params
        parts = key.split(_PATH_SEP)
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = data[key]
    return config, params
