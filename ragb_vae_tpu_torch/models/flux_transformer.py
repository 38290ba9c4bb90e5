"""FluxTransformer2DModel-compatible DiT in PyTorch.

Counterpart of `ragb_vae_tpu/models/flux_transformer.py` (weight mode
"none"; int8 storage is not ported yet). Module and parameter names are the
diffusers state-dict keys. Packed latent tokens and text tokens are (B, S, C).

Precision follows the JAX package: linears run in the compute dtype; the
AdaLN modulation, LayerNorm, RMSNorm statistics, RoPE and timestep
embeddings run in fp32. Attention goes through the flash kernel
(`ops/kernels/flash_attention.py`) on CUDA.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ragb_vae_tpu_torch.ops.kernels.flash_attention import attention

Tensor = torch.Tensor
Rope = Tuple[Tensor, Tensor]


@dataclasses.dataclass
class FluxTransformerConfig:
    """Mirrors FluxTransformer2DModel's config.json."""

    patch_size: int = 1
    in_channels: int = 64
    out_channels: Optional[int] = None
    num_layers: int = 19
    num_single_layers: int = 38
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    pooled_projection_dim: int = 768
    guidance_embeds: bool = True
    axes_dims_rope: Tuple[int, ...] = (16, 56, 56)

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def from_json(cls, path: Union[str, Path]) -> "FluxTransformerConfig":
        raw = json.loads(Path(path).read_text())
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in raw.items() if k in known}
        return cls(**kwargs)

    @classmethod
    def tiny(cls) -> "FluxTransformerConfig":
        """Small config for tests (same as the JAX package's)."""
        return cls(
            in_channels=16,
            num_layers=2,
            num_single_layers=2,
            attention_head_dim=32,
            num_attention_heads=2,
            joint_attention_dim=32,
            pooled_projection_dim=16,
            guidance_embeds=True,
            axes_dims_rope=(8, 12, 12),
        )


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------
def timestep_embedding(
    t: Tensor, dim: int = 256, *, max_period: float = 10000.0, scale: float = 1000.0,
    flip_sin_to_cos: bool = True,
) -> Tensor:
    """diffusers get_timestep_embedding (timesteps arrive divided by 1000)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = scale * t.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


def rope_frequencies(ids: Tensor, axes_dims: Sequence[int], theta: float = 10000.0) -> Rope:
    """3-axis rotary cos/sin (seq, head_dim) from position ids (seq, 3), fp32."""
    cos_parts, sin_parts = [], []
    pos = ids.float()
    for axis, dim in enumerate(axes_dims):
        freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=ids.device) / dim))
        angles = pos[:, axis : axis + 1] * freqs[None, :]
        cos_parts.append(torch.cos(angles).repeat_interleave(2, dim=-1))
        sin_parts.append(torch.sin(angles).repeat_interleave(2, dim=-1))
    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def apply_rotary_emb(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """Rotate adjacent pairs: x*cos + rot(x)*sin, rot(x0, x1) = (-x1, x0)."""
    xf = x.float()
    pairs = xf.reshape(*x.shape[:-1], -1, 2)
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(xf.shape)
    return (xf * cos + rot * sin).to(x.dtype)


class LoraDense(nn.Linear):
    """nn.Linear with an optional rank-r LoRA bypass,
    y = x W^T + b + (alpha/r) (x A^T) B^T (A: (r, in), B: (out, r));
    with rank 0 it is a plain linear whose keys are diffusers' own."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = True,
                 lora_rank: int = 0, lora_alpha: float = 0.0, device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=dtype)
        self.lora_rank = lora_rank
        self.scaling = lora_alpha / lora_rank if lora_rank > 0 else 0.0
        if lora_rank > 0:
            self.lora_A = nn.Parameter(torch.empty(lora_rank, in_features, device=device, dtype=dtype))
            self.lora_B = nn.Parameter(torch.zeros(out_features, lora_rank, device=device, dtype=dtype))
            nn.init.normal_(self.lora_A, std=1.0 / lora_rank)

    def forward(self, x: Tensor) -> Tensor:
        x = x.to(self.weight.dtype)
        y = F.linear(x, self.weight, self.bias)
        if self.lora_rank > 0:
            y = y + self.scaling * F.linear(F.linear(x, self.lora_A), self.lora_B)
        return y


class Fp32Linear(nn.Linear):
    """Linear with fp32 parameters and fp32 math whatever the model dtype: the
    AdaLN modulation, which the JAX package runs as `QDense(dtype=float32)`
    over fp32 parameters. Storing them in fp32 (3.2 B of FLUX.1's 11.9 B
    parameters) costs 6.4 GB of device memory and saves an fp32 copy of every
    modulation weight at every call."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__(in_features, out_features, device=device, dtype=torch.float32)

    def forward(self, x: Tensor) -> Tensor:
        return F.linear(x.float(), self.weight, self.bias)


class MLPEmbedder(nn.Module):
    """linear_1 -> SiLU -> linear_2."""

    def __init__(self, in_dim: int, dim: int, **kw):
        super().__init__()
        self.linear_1 = LoraDense(in_dim, dim, **kw)
        self.linear_2 = LoraDense(dim, dim, **kw)

    def forward(self, x: Tensor) -> Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class CombinedTimestepEmbeddings(nn.Module):
    """timestep (+ guidance) sinusoid MLPs + pooled-text MLP, summed."""

    def __init__(self, cfg: FluxTransformerConfig, **kw):
        super().__init__()
        dim = cfg.inner_dim
        self.timestep_embedder = MLPEmbedder(256, dim, **kw)
        self.guidance_embedder = MLPEmbedder(256, dim, **kw) if cfg.guidance_embeds else None
        self.text_embedder = MLPEmbedder(cfg.pooled_projection_dim, dim, **kw)

    def forward(self, timestep: Tensor, guidance: Optional[Tensor], pooled: Tensor) -> Tensor:
        dtype = self.text_embedder.linear_1.weight.dtype
        temb = self.timestep_embedder(timestep_embedding(timestep).to(dtype))
        if self.guidance_embedder is not None:
            if guidance is None:
                raise ValueError("guidance_embeds=True requires a guidance tensor.")
            temb = temb + self.guidance_embedder(timestep_embedding(guidance).to(dtype))
        return temb + self.text_embedder(pooled.to(dtype))


# ---------------------------------------------------------------------------
# Attention pieces
# ---------------------------------------------------------------------------
class RMSNorm(nn.Module):
    """Per-head-dim RMSNorm with fp32 statistics (eps 1e-6)."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x: Tensor) -> Tensor:
        xf = x.float()
        normed = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (normed * self.weight.float()).to(x.dtype)


def _layer_norm(x: Tensor) -> Tensor:
    """Affine-free LayerNorm in fp32 (eps 1e-6)."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6)


def _split_heads(x: Tensor, heads: int) -> Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, heads, -1).transpose(1, 2)


def _merge_heads(x: Tensor) -> Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


class JointAttention(nn.Module):
    """Double-stream joint attention: txt tokens prepended to img tokens,
    RoPE over the joint sequence."""

    def __init__(self, cfg: FluxTransformerConfig, **kw):
        super().__init__()
        dim, hd = cfg.inner_dim, cfg.attention_head_dim
        nkw = {k: v for k, v in kw.items() if k in ("device", "dtype")}
        self.heads = cfg.num_attention_heads
        self.to_q, self.to_k, self.to_v = (LoraDense(dim, dim, **kw) for _ in range(3))
        self.norm_q, self.norm_k = RMSNorm(hd, **nkw), RMSNorm(hd, **nkw)
        self.add_q_proj, self.add_k_proj, self.add_v_proj = (LoraDense(dim, dim, **kw) for _ in range(3))
        self.norm_added_q, self.norm_added_k = RMSNorm(hd, **nkw), RMSNorm(hd, **nkw)
        self.to_out = nn.ModuleList([LoraDense(dim, dim, **kw)])
        self.to_add_out = LoraDense(dim, dim, **kw)

    def forward(self, img: Tensor, txt: Tensor, rope: Rope) -> Tuple[Tensor, Tensor]:
        h = self.heads
        q = self.norm_q(_split_heads(self.to_q(img), h))
        k = self.norm_k(_split_heads(self.to_k(img), h))
        v = _split_heads(self.to_v(img), h)
        tq = self.norm_added_q(_split_heads(self.add_q_proj(txt), h))
        tk = self.norm_added_k(_split_heads(self.add_k_proj(txt), h))
        tv = _split_heads(self.add_v_proj(txt), h)
        cos, sin = rope
        q = apply_rotary_emb(torch.cat([tq, q], dim=2), cos, sin)
        k = apply_rotary_emb(torch.cat([tk, k], dim=2), cos, sin)
        v = torch.cat([tv, v], dim=2)
        out = _merge_heads(attention(q, k, v))
        s_txt = txt.shape[1]
        return self.to_out[0](out[:, s_txt:]), self.to_add_out(out[:, :s_txt])


class SingleAttention(nn.Module):
    """Single-stream attention: qkv + q/k RMSNorm, no output projection."""

    def __init__(self, cfg: FluxTransformerConfig, **kw):
        super().__init__()
        dim, hd = cfg.inner_dim, cfg.attention_head_dim
        nkw = {k: v for k, v in kw.items() if k in ("device", "dtype")}
        self.heads = cfg.num_attention_heads
        self.to_q, self.to_k, self.to_v = (LoraDense(dim, dim, **kw) for _ in range(3))
        self.norm_q, self.norm_k = RMSNorm(hd, **nkw), RMSNorm(hd, **nkw)

    def forward(self, x: Tensor, rope: Rope) -> Tensor:
        h = self.heads
        cos, sin = rope
        q = apply_rotary_emb(self.norm_q(_split_heads(self.to_q(x), h)), cos, sin)
        k = apply_rotary_emb(self.norm_k(_split_heads(self.to_k(x), h)), cos, sin)
        v = _split_heads(self.to_v(x), h)
        return _merge_heads(attention(q, k, v))


class _GeluProj(nn.Module):
    def __init__(self, dim: int, inner: int, **kw):
        super().__init__()
        self.proj = LoraDense(dim, inner, **kw)

    def forward(self, x: Tensor) -> Tensor:
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    """net.0.proj -> GELU(tanh) -> net.2 (diffusers FeedForward 'gelu-approximate')."""

    def __init__(self, dim: int, mult: int = 4, **kw):
        super().__init__()
        self.net = nn.ModuleList([_GeluProj(dim, dim * mult, **kw), nn.Identity(),
                                  LoraDense(dim * mult, dim, **kw)])

    def forward(self, x: Tensor) -> Tensor:
        return self.net[2](self.net[0](x))


class AdaLayerNormZero(nn.Module):
    """silu(temb) -> fp32 Linear(n*dim); affine-free LayerNorm modulated by the
    first (shift, scale); the remaining chunks come back as gates."""

    def __init__(self, dim: int, n_chunks: int = 6, device=None):
        super().__init__()
        self.n_chunks = n_chunks
        self.linear = Fp32Linear(dim, n_chunks * dim, device=device)

    def forward(self, x: Tensor, temb: Tensor):
        emb = self.linear(F.silu(temb.float()))[:, None, :]
        chunks = emb.chunk(self.n_chunks, dim=-1)
        shift, scale = chunks[0], chunks[1]
        out = (_layer_norm(x) * (1.0 + scale) + shift).to(x.dtype)
        return (out, *[c.to(x.dtype) for c in chunks[2:]])


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
class FluxTransformerBlock(nn.Module):
    def __init__(self, cfg: FluxTransformerConfig, **kw):
        super().__init__()
        self.norm1 = AdaLayerNormZero(cfg.inner_dim, device=kw["device"])
        self.norm1_context = AdaLayerNormZero(cfg.inner_dim, device=kw["device"])
        self.attn = JointAttention(cfg, **kw)
        self.ff = FeedForward(cfg.inner_dim, **kw)
        self.ff_context = FeedForward(cfg.inner_dim, **kw)

    def forward(self, img: Tensor, txt: Tensor, temb: Tensor, rope: Rope) -> Tuple[Tensor, Tensor]:
        norm_img, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(img, temb)
        norm_txt, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(txt, temb)
        attn_img, attn_txt = self.attn(norm_img, norm_txt, rope)

        img = img + gate_msa * attn_img
        norm2 = (_layer_norm(img) * (1.0 + scale_mlp) + shift_mlp).to(img.dtype)
        img = img + gate_mlp * self.ff(norm2)

        txt = txt + c_gate_msa * attn_txt
        norm2_c = (_layer_norm(txt) * (1.0 + c_scale_mlp) + c_shift_mlp).to(txt.dtype)
        txt = txt + c_gate_mlp * self.ff_context(norm2_c)
        return img, txt


class FluxSingleTransformerBlock(nn.Module):
    def __init__(self, cfg: FluxTransformerConfig, **kw):
        super().__init__()
        nkw = {k: v for k, v in kw.items() if k in ("device", "dtype")}
        dim = cfg.inner_dim
        self.norm = AdaLayerNormZero(dim, n_chunks=3, device=nkw["device"])
        self.proj_mlp = LoraDense(dim, 4 * dim, **nkw)
        self.attn = SingleAttention(cfg, **kw)
        self.proj_out = LoraDense(5 * dim, dim, **nkw)

    def forward(self, x: Tensor, temb: Tensor, rope: Rope) -> Tensor:
        norm_x, gate = self.norm(x, temb)
        mlp = F.gelu(self.proj_mlp(norm_x), approximate="tanh")
        attn_out = self.attn(norm_x, rope)
        return x + gate * self.proj_out(torch.cat([attn_out, mlp], dim=-1))


class AdaLayerNormContinuous(nn.Module):
    """silu(temb) -> fp32 Linear(2*dim) -> (scale, shift) over an affine-free LayerNorm."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.linear = Fp32Linear(dim, 2 * dim, device=device)

    def forward(self, x: Tensor, temb: Tensor) -> Tensor:
        emb = self.linear(F.silu(temb.float()))[:, None, :]
        scale, shift = emb.chunk(2, dim=-1)
        return _layer_norm(x) * (1.0 + scale) + shift


# ---------------------------------------------------------------------------
# The transformer
# ---------------------------------------------------------------------------
class FluxTransformer2D(nn.Module):
    """Forward signature mirrors the diffusers call (hidden_states are
    pre-packed latent tokens; ids carry no batch dim)."""

    def __init__(self, config: FluxTransformerConfig, *, lora_rank: int = 0,
                 lora_alpha: float = 0.0, device=None, dtype=None):
        super().__init__()
        cfg = config
        self.config = cfg
        nkw = {"device": device, "dtype": dtype}
        kw = {**nkw, "lora_rank": lora_rank, "lora_alpha": lora_alpha}
        dim = cfg.inner_dim
        self.x_embedder = LoraDense(cfg.in_channels, dim, **nkw)
        self.context_embedder = LoraDense(cfg.joint_attention_dim, dim, **nkw)
        self.time_text_embed = CombinedTimestepEmbeddings(cfg, **nkw)
        self.transformer_blocks = nn.ModuleList(
            [FluxTransformerBlock(cfg, **kw) for _ in range(cfg.num_layers)]
        )
        self.single_transformer_blocks = nn.ModuleList(
            [FluxSingleTransformerBlock(cfg, **kw) for _ in range(cfg.num_single_layers)]
        )
        self.norm_out = AdaLayerNormContinuous(dim, device=device)
        self.proj_out = LoraDense(dim, cfg.out_channels or cfg.in_channels, **nkw)

    def forward(
        self,
        hidden_states: Tensor,          # (B, img_seq, in_channels)
        encoder_hidden_states: Tensor,  # (B, txt_seq, joint_attention_dim)
        pooled_projections: Tensor,     # (B, pooled_projection_dim)
        timestep: Tensor,               # (B,) already divided by 1000
        img_ids: Tensor,                # (img_seq, 3)
        txt_ids: Tensor,                # (txt_seq, 3)
        guidance: Optional[Tensor] = None,  # (B,)
    ) -> Tensor:
        cfg = self.config
        img = self.x_embedder(hidden_states)
        txt = self.context_embedder(encoder_hidden_states)
        temb = self.time_text_embed(timestep, guidance, pooled_projections)
        rope = rope_frequencies(torch.cat([txt_ids, img_ids], dim=0), cfg.axes_dims_rope)
        for block in self.transformer_blocks:
            img, txt = block(img, txt, temb, rope)
        x = torch.cat([txt, img], dim=1)  # txt first
        for block in self.single_transformer_blocks:
            x = block(x, temb, rope)
        x = x[:, txt.shape[1]:]
        x = self.norm_out(x, temb).to(self.proj_out.weight.dtype)
        return self.proj_out(x)
