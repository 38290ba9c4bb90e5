"""Plain float32 FLUX.1 transformer, flow-match sampler and text-alpha loss.

Written from the published architecture (diffusers' FluxTransformer2DModel,
FlowMatchEulerDiscreteScheduler) and the text-alpha stage's conventions (the
packed condition and target streams share one latent id grid, fresh noise
at every sampling step, guidance 3.5, logit-normal timesteps, a mean-squared
flow-matching loss). It reads a state dict under diffusers' keys (the
tensors `weights.draw_state` makes, any dtype, read in float32), and
imports nothing of the program. Tensors are (B, S, C) token streams and
(B, H, W, C) latents.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.numerics import Numerics

Tensor = torch.Tensor
State = Dict[str, Tensor]


# ---------------------------------------------------------------------------
# Scheduler (FlowMatchEulerDiscreteScheduler with dynamic shifting)
# ---------------------------------------------------------------------------
def schedule_mu(sched: dict, image_seq_len: int) -> float:
    seq = max(min(int(image_seq_len), sched["max_image_seq_len"]), sched["base_image_seq_len"])
    m = (sched["max_shift"] - sched["base_shift"]) / (sched["max_image_seq_len"] - sched["base_image_seq_len"])
    return float(seq * m + sched["base_shift"] - m * sched["base_image_seq_len"])


def schedule(sched: dict, num_steps: int, mu: float) -> Tuple[np.ndarray, np.ndarray]:
    """(timesteps (num_steps,), sigmas (num_steps + 1,) ending in 0), float32."""
    n = sched["num_train_timesteps"]
    base = np.linspace(1, n, n, dtype=np.float64)[::-1] / n
    t = np.linspace(base[0] * n, base[-1] * n, num_steps, dtype=np.float64) / n
    sigmas = math.exp(mu) / (math.exp(mu) + (1.0 / t - 1.0))
    return (sigmas * n).astype(np.float32), np.concatenate([sigmas, [0.0]]).astype(np.float32)


# ---------------------------------------------------------------------------
# Packing and ids
# ---------------------------------------------------------------------------
def pack(lat: Tensor) -> Tensor:
    """(B, H, W, C) -> (B, H/2 * W/2, C*4), feature = c*4 + 2*dh + dw."""
    b, h, w, c = lat.shape
    return lat.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4).reshape(b, (h // 2) * (w // 2), c * 4)


def unpack(tok: Tensor, h: int, w: int) -> Tensor:
    b, _, f = tok.shape
    return tok.reshape(b, h // 2, w // 2, f // 4, 2, 2).permute(0, 1, 4, 2, 5, 3).reshape(b, h, w, f // 4)


def image_ids(h2: int, w2: int, device) -> Tensor:
    rows = torch.arange(h2, device=device, dtype=torch.float32)[:, None].expand(h2, w2)
    cols = torch.arange(w2, device=device, dtype=torch.float32)[None, :].expand(h2, w2)
    return torch.stack([torch.zeros_like(rows), rows, cols], dim=-1).reshape(h2 * w2, 3)


# ---------------------------------------------------------------------------
# The transformer
# ---------------------------------------------------------------------------
def _sinusoid(t: Tensor, dim: int = 256) -> Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = 1000.0 * t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _rope(ids: Tensor, axes: Sequence[int]) -> Tuple[Tensor, Tensor]:
    cos, sin = [], []
    for axis, dim in enumerate(axes):
        freqs = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float32, device=ids.device) / dim))
        ang = ids[:, axis:axis + 1].float() * freqs[None]
        cos.append(torch.cos(ang).repeat_interleave(2, dim=-1))
        sin.append(torch.sin(ang).repeat_interleave(2, dim=-1))
    return torch.cat(cos, dim=-1), torch.cat(sin, dim=-1)


def _rotate(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    pairs = x.reshape(*x.shape[:-1], -1, 2)
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(x.shape)
    return x * cos + rot * sin


def _ln(x: Tensor) -> Tensor:
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


def _rms(x: Tensor, w: Tensor) -> Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-6) * w.float()


class FluxReference:
    """The transformer over state `P` (and LoRA adapters `lora`, keys
    `<linear>.lora_A` / `.lora_B`, scaled by alpha / rank) in `num`'s
    arithmetic. `remat` recomputes each block in the backward (memory only)."""

    def __init__(self, P: State, cfg: dict, num: Numerics, *, lora: Optional[State] = None,
                 lora_scale: float = 0.0, remat: bool = False):
        self.P, self.cfg, self.num = P, cfg, num
        self.lora, self.lora_scale, self.remat = lora or {}, lora_scale, remat
        self.heads = cfg["num_attention_heads"]

    def lin(self, x: Tensor, name: str) -> Tensor:
        y = self.num.linear(x, self.P[f"{name}.weight"], self.P.get(f"{name}.bias"))
        a = self.lora.get(f"{name}.lora_A")
        if a is not None:
            y = y + self.lora_scale * self.num.linear(self.num.linear(x, a), self.lora[f"{name}.lora_B"])
        return y

    def _mlp(self, x: Tensor, name: str) -> Tensor:
        return self.lin(F.silu(self.lin(x, f"{name}.linear_1")), f"{name}.linear_2")

    def _heads(self, x: Tensor) -> Tensor:
        b, s, _ = x.shape
        return x.reshape(b, s, self.heads, -1).transpose(1, 2)

    def _merge(self, x: Tensor) -> Tensor:
        b, h, s, d = x.shape
        return x.transpose(1, 2).reshape(b, s, h * d)

    def _qkv(self, x: Tensor, p: str, names=("to_q", "to_k", "to_v"), norms=("norm_q", "norm_k")):
        q = _rms(self._heads(self.lin(x, f"{p}.{names[0]}")), self.P[f"{p}.{norms[0]}.weight"])
        k = _rms(self._heads(self.lin(x, f"{p}.{names[1]}")), self.P[f"{p}.{norms[1]}.weight"])
        return q, k, self._heads(self.lin(x, f"{p}.{names[2]}"))

    def _double(self, i: int, img: Tensor, txt: Tensor, temb: Tensor, cos: Tensor, sin: Tensor):
        p = f"transformer_blocks.{i}"
        e = self.lin(F.silu(temb), f"{p}.norm1.linear")[:, None].chunk(6, dim=-1)
        c = self.lin(F.silu(temb), f"{p}.norm1_context.linear")[:, None].chunk(6, dim=-1)
        n_img = _ln(img) * (1 + e[1]) + e[0]
        n_txt = _ln(txt) * (1 + c[1]) + c[0]
        q, k, v = self._qkv(n_img, f"{p}.attn")
        tq, tk, tv = self._qkv(n_txt, f"{p}.attn", ("add_q_proj", "add_k_proj", "add_v_proj"),
                               ("norm_added_q", "norm_added_k"))
        out = self._merge(self.num.attention(_rotate(torch.cat([tq, q], 2), cos, sin),
                                             _rotate(torch.cat([tk, k], 2), cos, sin), torch.cat([tv, v], 2)))
        s = txt.shape[1]
        img = img + e[2] * self.lin(out[:, s:], f"{p}.attn.to_out.0")
        img = img + e[5] * self._ff(_ln(img) * (1 + e[4]) + e[3], f"{p}.ff")
        txt = txt + c[2] * self.lin(out[:, :s], f"{p}.attn.to_add_out")
        txt = txt + c[5] * self._ff(_ln(txt) * (1 + c[4]) + c[3], f"{p}.ff_context")
        return img, txt

    def _ff(self, x: Tensor, p: str) -> Tensor:
        return self.lin(F.gelu(self.lin(x, f"{p}.net.0.proj"), approximate="tanh"), f"{p}.net.2")

    def _single(self, i: int, x: Tensor, temb: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
        p = f"single_transformer_blocks.{i}"
        shift, scale, gate = self.lin(F.silu(temb), f"{p}.norm.linear")[:, None].chunk(3, dim=-1)
        n = _ln(x) * (1 + scale) + shift
        mlp = F.gelu(self.lin(n, f"{p}.proj_mlp"), approximate="tanh")
        q, k, v = self._qkv(n, f"{p}.attn")
        attn = self._merge(self.num.attention(_rotate(q, cos, sin), _rotate(k, cos, sin), v))
        return x + gate * self.lin(torch.cat([attn, mlp], dim=-1), f"{p}.proj_out")

    def _block(self, fn, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def __call__(self, hidden: Tensor, prompt: Tensor, pooled: Tensor, timestep: Tensor, img_ids: Tensor,
                 txt_ids: Tensor, guidance: Optional[Tensor]) -> Tensor:
        cfg = self.cfg
        img = self.lin(hidden.float(), "x_embedder")
        txt = self.lin(prompt.float(), "context_embedder")
        temb = self._mlp(_sinusoid(timestep), "time_text_embed.timestep_embedder")
        if cfg["guidance_embeds"]:
            temb = temb + self._mlp(_sinusoid(guidance), "time_text_embed.guidance_embedder")
        temb = temb + self._mlp(pooled.float(), "time_text_embed.text_embedder")
        cos, sin = _rope(torch.cat([txt_ids, img_ids], dim=0), cfg["axes_dims_rope"])
        for i in range(cfg["num_layers"]):
            img, txt = self._block(self._double, i, img, txt, temb, cos, sin)
        x = torch.cat([txt, img], dim=1)
        for i in range(cfg["num_single_layers"]):
            x = self._block(self._single, i, x, temb, cos, sin)
        x = x[:, txt.shape[1]:]
        scale, shift = self.lin(F.silu(temb), "norm_out.linear")[:, None].chunk(2, dim=-1)
        return self.lin(_ln(x) * (1 + scale) + shift, "proj_out")


def run_transformer(flux: FluxReference, cond: Tensor, target: Tensor, t: Tensor, prompt: Tensor,
                    pooled: Tensor, guidance_scale: float) -> Tensor:
    """The prediction for the target half of the packed (cond, target) stream,
    unpacked to (B, h, w, C); `t` (B,) in [0, 1]."""
    b, h, w, _ = target.shape
    ids = image_ids(h // 2, w // 2, target.device)
    packed = torch.cat([pack(cond), pack(target)], dim=1)
    guidance = torch.full((b,), guidance_scale, device=target.device) if flux.cfg["guidance_embeds"] else None
    txt_ids = torch.zeros((prompt.shape[1], 3), device=target.device)
    pred = flux(packed, prompt.expand(b, -1, -1), pooled.expand(b, -1), t, torch.cat([ids, ids]), txt_ids, guidance)
    return unpack(pred[:, (h // 2) * (w // 2):], h, w)


def sample_latents(flux: FluxReference, sched: dict, mu: float, cond: Tensor, init: Tensor, step_noises: Tensor,
                   prompt: Tensor, pooled: Tensor, guidance_scale: float) -> Tensor:
    """Euler flow-match sampling with fresh noise at every step:
    x_t = (1 - s_i) x + s_i n_i, x <- x + (s_{i+1} - s_i) v(x_t, t_i)."""
    timesteps, sigmas = schedule(sched, step_noises.shape[0], mu)
    lat = init.float()
    for i in range(step_noises.shape[0]):
        s = float(sigmas[i])
        noisy = (1.0 - s) * lat + s * step_noises[i].float()
        t = torch.full((lat.shape[0],), float(timesteps[i]) / 1000.0, device=lat.device)
        v = run_transformer(flux, cond, noisy, t, prompt, pooled, guidance_scale)
        lat = lat + (float(sigmas[i + 1]) - s) * v
    return lat


def flow_matching_loss(flux: FluxReference, sched: dict, mu: float, cond: Tensor, target: Tensor, noise: Tensor,
                       u: Tensor, prompt: Tensor, pooled: Tensor, guidance_scale: float) -> Tensor:
    """(B,) per-pair loss: the timestep index floor(u * N) clipped into the
    N-step training schedule, x_t = (1 - s) x + s n, mean of (v - (n - x))^2."""
    n = sched["num_train_timesteps"]
    timesteps, sigmas = schedule(sched, n, mu)
    idx = torch.clamp((u * n).long(), 0, n - 1).cpu().numpy()
    t = torch.as_tensor(timesteps[idx], device=target.device)
    s = torch.as_tensor(sigmas[idx], device=target.device).reshape(-1, 1, 1, 1)
    noisy = (1.0 - s) * target + s * noise
    v = run_transformer(flux, cond, noisy, t / 1000.0, prompt, pooled, guidance_scale)
    return ((v - (noise - target)) ** 2).reshape(v.shape[0], -1).mean(dim=1)
