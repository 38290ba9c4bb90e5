"""How the harness builds the system under test: the program's own classes
(`ragb_vae_tpu_torch`), loaded with the weights the harness drew.

Every module is built on the meta device and takes the drawn tensors by
`load_state_dict(assign=True)`, so no weight is drawn, cast or copied by the
program; the reference draws the same tensors again from the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from perfbench.reference import weights as W

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# streams of the generator per kind of input (weights.draw_state / draw_like)
STREAM = {"flux": 1, "vae": 2, "prompt": 3, "pooled": 4, "lora": 5, "lpips": 6, "images": 7, "pairs": 8}


def vae_config(cfg: dict):
    from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig

    known = {f.name for f in dataclasses.fields(AutoencoderConfig)}
    return AutoencoderConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items() if k in known})


def transformer_config(cfg: dict):
    from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig

    known = {f.name for f in dataclasses.fields(FluxTransformerConfig)}
    return FluxTransformerConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items() if k in known})


def flux_state(cfg: dict, seed: int, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    return W.draw_state(W.flux_leaves(cfg["transformer"]), seed, device, {"model": dtype, "fp32": torch.float32},
                        stream=STREAM["flux"])


def vae_state(cfg: dict, seed: int, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    return W.draw_state(W.vae_leaves(cfg["vae"]), seed, device, {"model": dtype, "fp32": torch.float32},
                        stream=STREAM["vae"])


def prompt_embeddings(cfg: dict, seed: int, device):
    t = cfg["transformer"]
    prompt = W.draw_like(seed, STREAM["prompt"], (1, cfg["prompt_len"], t["joint_attention_dim"]), device)
    pooled = W.draw_like(seed, STREAM["pooled"], (1, t["pooled_projection_dim"]), device)
    return prompt, pooled


def build_rgba_vae(cfg: dict, state, *, dtype, compute_dtype=None, remat=False, fused: bool, **loss_kw):
    from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE

    vae = RgbaVAE(vae_config(cfg["vae"]), dtype=dtype, compute_dtype=compute_dtype, fused=fused, remat=remat,
                  device="meta", **loss_kw)
    vae.module.load_state_dict(state, strict=True, assign=True)
    vae.module.set_compute_dtype(compute_dtype)
    return vae


def build_textalpha_model(cfg: dict, seed: int, device, *, dtype: torch.dtype, remat: bool = False,
                          lora_rank: int = 0, lora_alpha: float = 0.0):
    """The program's FluxTextAlphaModel over the drawn transformer, VAE and
    prompt embeddings; `lora_rank` attaches the program's adapters and loads
    the drawn A matrices (B = 0)."""
    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel
    from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformer2D, add_lora, freeze_base_parameters
    from ragb_vae_tpu_torch.models.scheduler import FlowMatchEulerConfig, FlowMatchEulerScheduler

    transformer = FluxTransformer2D(transformer_config(cfg["transformer"]), remat=remat, device="meta", dtype=dtype)
    state = flux_state(cfg, seed, device, dtype)
    transformer.load_state_dict(state, strict=True, assign=True)
    del state
    vae = build_rgba_vae(cfg, vae_state(cfg, seed, device, dtype), dtype=dtype, fused=device.type == "cuda")
    prompt, pooled = prompt_embeddings(cfg, seed, device)
    sched = FlowMatchEulerScheduler(FlowMatchEulerConfig(**cfg["scheduler"]))
    model = FluxTextAlphaModel(transformer.eval(), vae, sched, prompt, pooled,
                               torch.zeros((cfg["prompt_len"], 3), device=device),
                               guidance_scale=cfg["guidance_scale"], lora_rank=lora_rank, lora_alpha=lora_alpha,
                               dtype=dtype)
    if lora_rank > 0:
        add_lora(transformer, lora_rank, lora_alpha, torch.Generator(device).manual_seed(0))
        drawn = lora_state(cfg, seed, device, lora_rank)
        with torch.no_grad():
            for name, p in transformer.named_parameters():
                if name in drawn:
                    p.copy_(drawn[name])
        freeze_base_parameters(transformer)
        model.vae.module.requires_grad_(False)
    return model


def lora_state(cfg: dict, seed: int, device, rank: int) -> Dict[str, torch.Tensor]:
    return W.draw_state(W.lora_leaves(cfg["transformer"], rank), seed, device, {"fp32": torch.float32},
                        stream=STREAM["lora"])


def lpips_state(seed: int, device) -> Dict[str, torch.Tensor]:
    return W.draw_state(W.lpips_leaves(), seed, device, {"fp32": torch.float32}, stream=STREAM["lpips"])


def build_lpips(seed: int, device, compute_dtype: Optional[torch.dtype]):
    """The program's LPIPS module over the drawn VGG16 weights, and its perceptual loss."""
    from ragb_vae_tpu_torch.models.lpips import LPIPS, make_perceptual_loss

    state = lpips_state(seed, device)
    convs = {int(k[4:].split("_")[0]): {} for k in state if k.startswith("conv")}
    for k, v in state.items():
        if k.startswith("conv"):
            idx, kind = k[4:].split("_")
            convs[int(idx)][kind] = v
    lins = [state[f"lin{k}"] for k in range(5)]
    model = LPIPS(convs, lins).to(device)
    return make_perceptual_loss(model, compute_dtype=compute_dtype, remat=True)
