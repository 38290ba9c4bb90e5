"""FLUX-Kontext text-alpha model, serving side: transformer + RGBA VAE +
flow-matching sampler.

Counterpart of `ragb_vae_tpu/models/flux_kontext_textalpha.py`
(construction, `from_pretrained`, `encode_latents`, `_transformer_pred`,
`sampling_schedule`, `sample_latents_from_noise` and `sample`; the training
loss and LoRA loading are not ported yet). It keeps the reference's quirks:

- in-context conditioning by concatenating the packed cond and target token
  streams, with the SAME latent image-id grid repeated for both halves;
- fresh noise injected at every denoising step
  (`noisy_target = (1-σ)·latents + σ·noise_i`);
- the guidance tensor (3.5) only when the transformer is guidance-distilled.

All randomness comes from an explicit `torch.Generator`, drawn in a fixed
order: posterior eps, initial latents, then one noise tensor per step.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformer2D, FluxTransformerConfig
from ragb_vae_tpu_torch.models.flux_weights import load_flux_transformer_params
from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
from ragb_vae_tpu_torch.models.scheduler import (
    FlowMatchEulerConfig,
    FlowMatchEulerScheduler,
    calc_mu,
)
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
from ragb_vae_tpu_torch.models.weights import load_autoencoder_params
from ragb_vae_tpu_torch.ops.packing import pack_latents, prepare_latent_image_ids, unpack_latents

Tensor = torch.Tensor

EMPTY_PROMPT_FILE = "empty_prompt_embeds.npz"


def load_scheduler(model_path: Union[str, Path]) -> FlowMatchEulerScheduler:
    cfg_path = Path(model_path) / "scheduler" / "scheduler_config.json"
    config = FlowMatchEulerConfig.from_json(cfg_path) if cfg_path.exists() else FlowMatchEulerConfig()
    return FlowMatchEulerScheduler(config)


def load_empty_prompt(model_path: Union[str, Path]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(prompt_embeds, pooled_prompt_embeds, text_ids) from the precomputed
    `empty_prompt_embeds.npz` beside the checkpoint (the text encoders are
    not ported)."""
    path = Path(model_path) / EMPTY_PROMPT_FILE
    if not path.exists():
        raise FileNotFoundError(
            f"{path} not found: the port reads the empty-prompt embeddings only from "
            f"{EMPTY_PROMPT_FILE} (write it with the JAX package's save_empty_prompt_embeds)."
        )
    data = np.load(path)
    return data["prompt_embeds"], data["pooled_prompt_embeds"], data["text_ids"]


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise parameters in place at lecun-normal scale, as the JAX
    initializers do: weights ~ N(0, 1/fan_in), biases 0, norm scales 1,
    LoRA B 0. Draws follow `named_parameters` order, so a seed fixes them."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "lora_B" or leaf == "bias":
            p.zero_()
        elif p.ndim == 1:
            p.fill_(1.0)
        elif leaf == "lora_A":
            p.normal_(0.0, 1.0 / p.shape[0], generator=generator)  # std 1/rank, as peft
        else:
            p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()), generator=generator)


class FluxTextAlphaModel:
    """Transformer module + RgbaVAE + scheduler + empty-prompt embeddings."""

    def __init__(
        self,
        transformer: FluxTransformer2D,
        vae: RgbaVAE,
        scheduler: FlowMatchEulerScheduler,
        prompt_embeds: Tensor,          # (1, txt_seq, joint_dim)
        pooled_prompt_embeds: Tensor,   # (1, pooled_dim)
        text_ids: Tensor,               # (txt_seq, 3)
        *,
        guidance_scale: float = 3.5,
        dtype: torch.dtype = torch.float32,
    ):
        self.transformer = transformer
        self.transformer_config = transformer.config
        self.vae = vae
        self.scheduler = scheduler
        device = self.device
        self.prompt_embeds = torch.as_tensor(prompt_embeds, dtype=torch.float32).to(device)
        self.pooled_prompt_embeds = torch.as_tensor(pooled_prompt_embeds, dtype=torch.float32).to(device)
        self.text_ids = torch.as_tensor(text_ids, dtype=torch.float32).to(device)
        self.guidance_scale = guidance_scale
        self.dtype = dtype
        self.vae_scale_factor = vae.config.spatial_scale_factor
        self.scaling_factor = float(vae.config.scaling_factor)
        self.shift_factor = float(vae.config.shift_factor)

    @property
    def device(self) -> torch.device:
        return self.transformer.x_embedder.weight.device

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    @classmethod
    def random(
        cls,
        t_config: FluxTransformerConfig,
        vae_config: AutoencoderConfig,
        *,
        seed: int = 0,
        device: Union[str, torch.device] = "cpu",
        dtype: torch.dtype = torch.float32,
        fused: bool = False,
        prompt_len: int = 512,
    ) -> "FluxTextAlphaModel":
        """A model with random weights and random prompt embeddings, all
        drawn from `seed` on `device`. Modules are built on the meta device
        and materialised directly on `device` in `dtype`, so a full-size
        transformer never exists in host memory."""
        device = torch.device(device)
        gen = torch.Generator(device).manual_seed(seed)
        transformer = FluxTransformer2D(t_config, device="meta", dtype=dtype).to_empty(device=device)
        vae = RgbaVAE(vae_config, dtype=dtype, fused=fused, device="meta")
        vae.module.to_empty(device=device)
        init_random_(transformer, gen)
        init_random_(vae.module, gen)
        prompt = torch.randn((1, prompt_len, t_config.joint_attention_dim), generator=gen, device=device)
        pooled = torch.randn((1, t_config.pooled_projection_dim), generator=gen, device=device)
        text_ids = torch.zeros((prompt_len, 3), device=device)
        return cls(transformer.eval(), vae, FlowMatchEulerScheduler(), prompt, pooled, text_ids,
                   dtype=dtype)

    @classmethod
    def from_pretrained(
        cls,
        model_path: Union[str, Path],
        *,
        vae_path: Union[str, Path],
        vae_subfolder: str = "ae",
        dtype: torch.dtype = torch.float32,
        device: Union[str, torch.device] = "cpu",
        fused: bool = False,
    ) -> "FluxTextAlphaModel":
        """Transformer from `<model_path>/transformer`, scheduler config and
        `empty_prompt_embeds.npz` from `model_path`, RGBA VAE from
        `<vae_path>/<vae_subfolder>` (or `vae_path` itself)."""
        t_config, t_state = load_flux_transformer_params(model_path)
        try:
            v_config, v_state = load_autoencoder_params(vae_path, vae_subfolder, adapt_to_rgba=True)
        except FileNotFoundError:
            v_config, v_state = load_autoencoder_params(vae_path, None, adapt_to_rgba=True)
        transformer = FluxTransformer2D(t_config, device="meta", dtype=dtype)
        vae = RgbaVAE(v_config, dtype=dtype, fused=fused, device="meta")
        for module, state in ((transformer, t_state), (vae.module, v_state)):
            # each parameter keeps the dtype its module declared (fp32 for the
            # AdaLN modulation, `dtype` elsewhere)
            want = {k: p.dtype for k, p in module.state_dict().items()}
            module.load_state_dict({k: v.to(want.get(k, dtype)) for k, v in state.items()},
                                   strict=True, assign=True)
        transformer.to(device)
        vae.module.to(device)
        prompt, pooled, text_ids = load_empty_prompt(model_path)
        return cls(transformer.eval(), vae, load_scheduler(model_path), torch.from_numpy(prompt),
                   torch.from_numpy(pooled), torch.from_numpy(text_ids), dtype=dtype)

    # ------------------------------------------------------------------
    # Core helpers
    # ------------------------------------------------------------------
    def encode_latents(self, x: Tensor, eps: Tensor) -> Tensor:
        """[0,1] NHWC image -> scaled/shifted fp32 latent (B, h, w, C), the
        posterior sampled with the standard-normal draw `eps`."""
        posterior = self.vae.encode((x * 2.0 - 1.0).to(self.dtype))
        latents = posterior.sample(eps, dtype=torch.float32)
        return (latents - self.shift_factor) * self.scaling_factor

    def decode_latents(self, latents: Tensor) -> Tensor:
        """Sampler latents -> [0,1] fp32 NHWC image."""
        decoded = self.vae.decode((latents / self.scaling_factor + self.shift_factor).to(self.dtype))
        return torch.clamp((decoded.float() + 1.0) / 2.0, 0.0, 1.0)

    def _guidance(self, batch_size: int) -> Optional[Tensor]:
        if not self.transformer_config.guidance_embeds:
            return None
        return torch.full((batch_size,), self.guidance_scale, dtype=torch.float32, device=self.device)

    def _transformer_pred(self, packed: Tensor, timestep: Tensor, img_ids: Tensor, batch_size: int) -> Tensor:
        prompt = self.prompt_embeds.expand(batch_size, -1, -1).to(self.dtype)
        pooled = self.pooled_prompt_embeds.expand(batch_size, -1).to(self.dtype)
        return self.transformer(
            hidden_states=packed,
            encoder_hidden_states=prompt,
            pooled_projections=pooled,
            timestep=timestep,
            img_ids=img_ids,
            txt_ids=self.text_ids,
            guidance=self._guidance(batch_size),
        )

    # ------------------------------------------------------------------
    # Sampling
    # ------------------------------------------------------------------
    def sampling_schedule(self, num_inference_steps: int) -> FlowMatchEulerScheduler:
        """Inference schedule, dynamic-shift μ from the VAE sample size."""
        sched = FlowMatchEulerScheduler(self.scheduler.config)
        sample = self.vae.config.sample_size or 256
        h = max(int(sample // self.vae_scale_factor), 1)
        sched.set_timesteps(num_inference_steps, mu=calc_mu(self.scheduler.config, h * h))
        return sched

    def sample_latents_from_noise(
        self,
        cond_latent: Tensor,
        init_noise: Tensor,
        step_noises: Tensor,
        *,
        return_trajectory: bool = False,
    ):
        """Deterministic core of `sample`: all noise is injected.

        `init_noise` initialises the latents; `step_noises` is
        (num_steps, B, h, w, C), one fresh tensor per denoising step. With
        `return_trajectory` the (num_steps, B, h, w, C) latents after each
        Euler step come back beside the final latents."""
        num_steps = step_noises.shape[0]
        sched = self.sampling_schedule(num_steps)
        bsz, latent_h, latent_w = cond_latent.shape[:3]
        device = cond_latent.device
        ids_single = prepare_latent_image_ids(latent_h // 2, latent_w // 2, device=device)
        img_ids = torch.cat([ids_single, ids_single], dim=0)
        packed_cond = pack_latents(cond_latent.to(self.dtype))
        seq_cond = packed_cond.shape[1]

        latents = init_noise.float()
        trajectory = []
        for i in range(num_steps):
            sigma = float(sched.sigmas[i])
            # the reference's quirk: fresh noise injected at EVERY step
            noisy_target = (1.0 - sigma) * latents + sigma * step_noises[i].float()
            packed = torch.cat([packed_cond, pack_latents(noisy_target.to(self.dtype))], dim=1)
            timestep = torch.full((bsz,), float(sched.timesteps[i]) / 1000.0, device=device)
            pred = self._transformer_pred(packed, timestep, img_ids, bsz)
            pred_target = unpack_latents(pred[:, seq_cond:, :].float(), latent_h, latent_w)
            latents = sched.step(pred_target, i, latents)
            if return_trajectory:
                trajectory.append(latents)
        if return_trajectory:
            return latents, torch.stack(trajectory)
        return latents

    def draw_noise(
        self, lat_shape, num_steps: int, generator: torch.Generator
    ) -> Tuple[Tensor, Tensor, Tensor]:
        """(eps, init, step_noises) for one request, drawn in that order."""
        kw = {"generator": generator, "device": self.device, "dtype": torch.float32}
        eps = torch.randn(lat_shape, **kw)
        init = torch.randn(lat_shape, **kw)
        steps = torch.randn((num_steps,) + tuple(lat_shape), **kw)
        return eps, init, steps

    def latent_shape(self, height: int, width: int) -> Tuple[int, int, int]:
        f = self.vae_scale_factor
        return (height // f, width // f, self.vae.config.latent_channels)

    @torch.inference_mode()
    def sample(self, gt: Tensor, *, num_inference_steps: int = 20,
               generator: Optional[torch.Generator] = None) -> Tensor:
        """(B, H, W, 4) [0,1] condition -> (B, H, W, 4) [0,1] text-alpha
        prediction. Each sample's noise is drawn from `generator` in order."""
        gt = gt.to(self.device)
        lat_shape = self.latent_shape(gt.shape[1], gt.shape[2])
        draws = [self.draw_noise(lat_shape, num_inference_steps, generator) for _ in range(gt.shape[0])]
        eps, init, steps = (torch.stack(t) for t in zip(*draws))
        cond = self.encode_latents(gt, eps)
        latents = self.sample_latents_from_noise(cond, init, steps.transpose(0, 1))
        return self.decode_latents(latents)
