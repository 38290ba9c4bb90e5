"""FluxTransformer2DModel-compatible DiT in PyTorch.

Counterpart of `ragb_vae_tpu/models/flux_transformer.py`. Module and
parameter names are the diffusers state-dict keys. Packed latent tokens and
text tokens are (B, S, C).

Precision follows the JAX package: linears run in the compute dtype; the
AdaLN modulation, LayerNorm, RMSNorm statistics, RoPE and timestep
embeddings run in fp32. Attention goes through the flash kernel
(`ops/kernels/flash_attention.py`) on CUDA.

`weight_quant="int8"` stores every linear the JAX package builds from
`QDense` as int8 weights with one fp32 scale per output channel (buffers
`weight_q` (out, in), `weight_scale`, fp32 `bias`; none of them a parameter)
and multiplies through `ops/kernels/int8_matmul.py`, so no weight is ever
dequantised. LoRA adapters stay fp32 parameters beside an int8 base.

Under tensor parallelism (`parallel/tensor_parallel.py::shard_transformer_`)
each linear may hold a column or a row shard over a model group (`tp`, a
`parallel/mesh.py::Mesh`): `in_features` / `out_features` stay the layer's
full sizes, the tensors are this rank's slices, and the attention modules run
on their H / T heads.

Under FSDP (`parallel/fsdp.py::shard_base_`) the frozen leaves hold this
rank's part over the data group and `FluxTransformer2D.fsdp` gathers each
unit (a block; an embedder, `norm_out`, `proj_out`) for the call. Under
sequence parallelism (`forward(seq=)`, `parallel/sequence_parallel.py`) the
token streams and their ids are this rank's 1/sp, and attention gathers k and
v over the sequence group.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ragb_vae_tpu_torch.ops.kernels.flash_attention import attention
from ragb_vae_tpu_torch.ops.kernels.int8_matmul import int8_matmul
from ragb_vae_tpu_torch.parallel.mesh import Mesh, all_reduce
from ragb_vae_tpu_torch.parallel.tensor_parallel import gather_last, region_in, region_out, take

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


WEIGHT_QUANT_MODES = ("none", "int8")


class QLinear(nn.Module):
    """Linear layer with optional weight-only int8 storage (the JAX
    package's `QDense`).

    weight_quant="none": `weight` (out, in) and `bias` parameters in `dtype`,
    initialised as nn.Linear initialises them, computed with F.linear.
    weight_quant="int8": buffers `weight_q` (out, in) int8, `weight_scale`
    (out,) fp32 and `bias` (out,) fp32; y = (x @ weight_q^T) * scale + bias
    with fp32 accumulation and one rounding to `dtype`.

    The compute dtype of an int8 layer is fixed when it is built or
    quantised (`dtype=`): no float weight is left to read it from, so
    `module.to(dtype)` does not change it (and would round the fp32 scale
    and bias). Build the model in the dtype it is to run in.

    Tensor parallel (`shard_`): a "column" shard holds the output channels
    `tp_ranges` (weight rows, bias, scale), a "row" shard the input channels
    `tp_ranges` (weight columns) and the whole bias and scale; a row shard's
    partial product (bias-free: K10 fuses the bias, so it is called without
    one) is all-reduced over `tp` and the bias added once after it."""

    tp_kind = "none"
    tp = Mesh()
    tp_ranges: Tuple[Tuple[int, int], ...] = ()

    def __init__(self, in_features: int, out_features: int, *, bias: bool = True,
                 weight_quant: str = "none", device=None, dtype=None):
        super().__init__()
        if weight_quant not in WEIGHT_QUANT_MODES:
            raise ValueError(f"Unknown weight_quant mode {weight_quant!r}.")
        self.in_features, self.out_features = in_features, out_features
        self.weight_quant = weight_quant
        self._dtype = dtype or torch.get_default_dtype()
        if weight_quant == "int8":
            self.register_buffer("weight_q", torch.zeros((out_features, in_features), dtype=torch.int8, device=device))
            self.register_buffer("weight_scale", torch.ones(out_features, dtype=torch.float32, device=device))
            self.register_buffer("bias", torch.zeros(out_features, dtype=torch.float32, device=device) if bias else None)
            return
        self.weight = nn.Parameter(torch.empty((out_features, in_features), device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(out_features, device=device, dtype=dtype)) if bias else None
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        if bias:
            bound = 1.0 / math.sqrt(in_features) if in_features > 0 else 0.0
            nn.init.uniform_(self.bias, -bound, bound)

    @property
    def base_weight(self) -> Tensor:
        """The tensor that holds the base weights, whatever the mode."""
        return self.weight_q if self.weight_quant == "int8" else self.weight

    @property
    def compute_dtype(self) -> torch.dtype:
        return self._dtype if self.weight_quant == "int8" else self.weight.dtype

    @torch.no_grad()
    def quantize_(self, device=None, dtype: Optional[torch.dtype] = None, reduce_absmax=None) -> None:
        """Replace the float weight by its int8 form, made where the weight
        lives or on `device`; the layer then computes in `dtype` (default: the
        weight's own). `reduce_absmax` turns this shard's per-column max into
        the whole layer's (default: the max over the model group on a row
        shard)."""
        from ragb_vae_tpu_torch.models.quantize import quantize_kernel

        if self.weight_quant == "int8":
            return
        self._dtype = dtype or self.weight.dtype
        # a row shard sees part of each output channel's inputs: its scale is
        # the max over the model group, the full layer's, bit for bit
        reduce_max = reduce_absmax
        if reduce_max is None and self.tp_kind == "row":
            reduce_max = lambda absmax: all_reduce(absmax, self.tp, op=dist.ReduceOp.MAX)   # noqa: E731
        qk = quantize_kernel(self.weight.detach().to(device).t(), reduce_absmax=reduce_max)
        bias = None if self.bias is None else self.bias.detach().to(device, torch.float32)
        del self.weight, self.bias
        self.register_buffer("weight_q", qk["kernel_q"].t().contiguous())
        self.register_buffer("weight_scale", qk["kernel_scale"])
        self.register_buffer("bias", bias)
        self.weight_quant = "int8"

    def base(self, x: Tensor) -> Tensor:
        """The base linear on x, already in the compute dtype (on a row shard:
        this rank's partial product, without the bias)."""
        bias = None if self.tp_kind == "row" else self.bias
        if self.weight_quant == "int8":
            return int8_matmul(x, self.weight_q, self.weight_scale, bias)
        return F.linear(x, self.weight, bias)

    def finish(self, y: Tensor) -> Tensor:
        """A row shard's partial sums all-reduced over the model group, then
        the bias added once; any other layer's output as it is."""
        if self.tp_kind != "row":
            return y
        y = region_out(y, self.tp)
        return y if self.bias is None else (y.float() + self.bias.float()).to(y.dtype)

    def forward(self, x: Tensor) -> Tensor:
        return self.finish(self.base(x.to(self.compute_dtype)))

    # -- tensor parallel --------------------------------------------------
    def shard_of(self, leaf: str, full: Tensor) -> Tensor:
        """This shard's part of the full-size tensor `full` of entry `leaf`."""
        if self.tp_kind == "none":
            return full
        if leaf in ("weight", "weight_q"):
            return take(full, 0 if self.tp_kind == "column" else 1, self.tp_ranges)
        if leaf in ("bias", "weight_scale") and self.tp_kind == "column":
            return take(full, 0, self.tp_ranges)
        return full

    @torch.no_grad()
    def shard_(self, mesh: Mesh, kind: str, ranges) -> None:
        """Keep only this rank's `kind` ("column" or "row") shard: the
        channels `ranges` ((start, length) pieces) of the output or input axis."""
        if self.tp_kind != "none":
            raise ValueError(f"{self} is already sharded")
        self.tp_kind, self.tp, self.tp_ranges = kind, mesh, tuple(ranges)
        for leaf in ("weight", "weight_q", "bias", "weight_scale"):
            t = getattr(self, leaf, None)
            if t is None:
                continue
            part = self.shard_of(leaf, t).contiguous()
            if part.shape == t.shape:
                continue
            setattr(self, leaf, nn.Parameter(part, requires_grad=t.requires_grad)
                    if isinstance(t, nn.Parameter) else part)

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, weight_quant={self.weight_quant}"


class LoraDense(QLinear):
    """QLinear with an optional rank-r LoRA bypass,
    y = x W^T + b + (alpha/r) (x A^T) B^T (A: (r, in), B: (out, r));
    with rank 0 it is a plain linear whose keys are diffusers' own.

    The adapters are fp32 parameters whatever the base dtype and are cast to
    the compute dtype at use, as in the JAX package: AdamW then updates fp32
    adapters under a frozen bf16 or int8 base."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = True,
                 lora_rank: int = 0, lora_alpha: float = 0.0, weight_quant: str = "none",
                 device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias, weight_quant=weight_quant,
                         device=device, dtype=dtype)
        self.lora_rank = 0
        self.scaling = 0.0
        if lora_rank > 0:
            self.add_adapter(lora_rank, lora_alpha)

    def add_adapter(self, rank: int, alpha: float,
                    generator: Optional[torch.Generator] = None) -> None:
        """Attach (or replace) the adapter on the weight's device:
        A ~ N(0, 1/rank), B = 0, so the bypass starts at zero (peft's
        init_lora_weights="gaussian"). A is drawn on the generator's device
        (a pipeline stage's weight may lie on another)."""
        device = self.base_weight.device
        self.lora_rank = rank
        self.scaling = alpha / rank
        a = torch.empty(rank, self.in_features, device=device if generator is None else generator.device,
                        dtype=torch.float32)
        self.lora_A = nn.Parameter(a.normal_(0.0, 1.0 / rank, generator=generator).to(device))
        self.lora_B = nn.Parameter(
            torch.zeros(self.out_features, rank, device=device, dtype=torch.float32))

    def forward(self, x: Tensor) -> Tensor:
        x = x.to(self.compute_dtype)
        y = self.base(x)
        if self.lora_rank > 0:
            a, b = self.lora_A, self.lora_B
            if self.tp_kind == "row":       # this rank's inputs: its columns of A
                a = take(a, 1, self.tp_ranges)
            elif self.tp_kind == "column":  # its outputs: its rows of B
                b = take(b, 0, self.tp_ranges)
            y = y + self.scaling * F.linear(F.linear(x, a.to(x.dtype)), b.to(x.dtype))
        return self.finish(y)


class Fp32Linear(QLinear):
    """Linear with fp32 parameters and fp32 math whatever the model dtype: the
    AdaLN modulation, which the JAX package runs as `QDense(dtype=float32)`
    over fp32 parameters. Storing them in fp32 (3.2 B of FLUX.1's 11.9 B
    parameters) costs 6.4 GB of device memory and saves an fp32 copy of every
    modulation weight at every call. Under weight_quant="int8" they are int8
    like every other linear and multiply an fp32 activation."""

    def __init__(self, in_features: int, out_features: int, *, weight_quant: str = "none", device=None):
        super().__init__(in_features, out_features, weight_quant=weight_quant, device=device,
                         dtype=torch.float32)

    def forward(self, x: Tensor) -> Tensor:
        return self.finish(self.base(x.float()))


class MLPEmbedder(nn.Module):
    """linear_1 -> SiLU -> linear_2 (column, then row under TP)."""

    tp = Mesh()

    def __init__(self, in_dim: int, dim: int, **kw):
        super().__init__()
        self.linear_1 = LoraDense(in_dim, dim, **kw)
        self.linear_2 = LoraDense(dim, dim, **kw)

    def forward(self, x: Tensor) -> Tensor:
        return self.linear_2(F.silu(self.linear_1(region_in(x, self.tp))))


class CombinedTimestepEmbeddings(nn.Module):
    """timestep (+ guidance) sinusoid MLPs + pooled-text MLP, summed."""

    def __init__(self, cfg: FluxTransformerConfig, **kw):
        super().__init__()
        dim = cfg.inner_dim
        self.timestep_embedder = MLPEmbedder(256, dim, **kw)
        self.guidance_embedder = MLPEmbedder(256, dim, **kw) if cfg.guidance_embeds else None
        self.text_embedder = MLPEmbedder(cfg.pooled_projection_dim, dim, **kw)

    def forward(self, timestep: Tensor, guidance: Optional[Tensor], pooled: Tensor) -> Tensor:
        dtype = self.text_embedder.linear_1.compute_dtype
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
    RoPE over the joint sequence (this rank's heads under TP; under SP this
    rank's tokens of both streams, k and v gathered over `seq`)."""

    tp = Mesh()

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

    def forward(self, img: Tensor, txt: Tensor, rope: Rope, seq: Optional[Mesh] = None) -> Tuple[Tensor, Tensor]:
        h = self.heads
        img, txt = region_in(img, self.tp), region_in(txt, self.tp)
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
        s_txt = txt.shape[1]
        out = _merge_heads(attention(q, k, v, seq=seq, segments=(s_txt, img.shape[1])))
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

    def forward(self, x: Tensor, rope: Rope, seq: Optional[Mesh] = None,
                segments: Optional[Tuple[int, ...]] = None) -> Tensor:
        h = self.heads
        cos, sin = rope
        q = apply_rotary_emb(self.norm_q(_split_heads(self.to_q(x), h)), cos, sin)
        k = apply_rotary_emb(self.norm_k(_split_heads(self.to_k(x), h)), cos, sin)
        v = _split_heads(self.to_v(x), h)
        return _merge_heads(attention(q, k, v, seq=seq, segments=segments))


class _GeluProj(nn.Module):
    def __init__(self, dim: int, inner: int, **kw):
        super().__init__()
        self.proj = LoraDense(dim, inner, **kw)

    def forward(self, x: Tensor) -> Tensor:
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    """net.0.proj -> GELU(tanh) -> net.2 (diffusers FeedForward 'gelu-approximate')."""

    tp = Mesh()

    def __init__(self, dim: int, mult: int = 4, **kw):
        super().__init__()
        self.net = nn.ModuleList([_GeluProj(dim, dim * mult, **kw), nn.Identity(),
                                  LoraDense(dim * mult, dim, **kw)])

    def forward(self, x: Tensor) -> Tensor:
        return self.net[2](self.net[0](region_in(x, self.tp)))


class AdaLayerNormZero(nn.Module):
    """silu(temb) -> fp32 Linear(n*dim); affine-free LayerNorm modulated by the
    first (shift, scale); the remaining chunks come back as gates. Under TP
    the linear is column-sharded and its output all-gathered before the
    chunks are cut."""

    tp = Mesh()

    def __init__(self, dim: int, n_chunks: int = 6, *, weight_quant: str = "none", device=None):
        super().__init__()
        self.n_chunks = n_chunks
        self.linear = Fp32Linear(dim, n_chunks * dim, weight_quant=weight_quant, device=device)

    def forward(self, x: Tensor, temb: Tensor):
        emb = gather_last(self.linear(region_in(F.silu(temb.float()), self.tp)), self.tp)[:, None, :]
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
        akw = {"device": kw["device"], "weight_quant": kw.get("weight_quant", "none")}
        self.norm1 = AdaLayerNormZero(cfg.inner_dim, **akw)
        self.norm1_context = AdaLayerNormZero(cfg.inner_dim, **akw)
        self.attn = JointAttention(cfg, **kw)
        self.ff = FeedForward(cfg.inner_dim, **kw)
        self.ff_context = FeedForward(cfg.inner_dim, **kw)

    def forward(self, img: Tensor, txt: Tensor, temb: Tensor, rope: Rope,
                seq: Optional[Mesh] = None) -> Tuple[Tensor, Tensor]:
        norm_img, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(img, temb)
        norm_txt, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(txt, temb)
        attn_img, attn_txt = self.attn(norm_img, norm_txt, rope, seq)

        img = img + gate_msa * attn_img
        norm2 = (_layer_norm(img) * (1.0 + scale_mlp) + shift_mlp).to(img.dtype)
        img = img + gate_mlp * self.ff(norm2)

        txt = txt + c_gate_msa * attn_txt
        norm2_c = (_layer_norm(txt) * (1.0 + c_scale_mlp) + c_shift_mlp).to(txt.dtype)
        txt = txt + c_gate_mlp * self.ff_context(norm2_c)
        return img, txt


class FluxSingleTransformerBlock(nn.Module):
    tp = Mesh()

    def __init__(self, cfg: FluxTransformerConfig, **kw):
        super().__init__()
        # proj_mlp and proj_out carry no adapter
        nkw = {k: v for k, v in kw.items() if k in ("device", "dtype", "weight_quant")}
        dim = cfg.inner_dim
        self.norm = AdaLayerNormZero(dim, n_chunks=3, device=nkw["device"],
                                     weight_quant=nkw.get("weight_quant", "none"))
        self.proj_mlp = LoraDense(dim, 4 * dim, **nkw)
        self.attn = SingleAttention(cfg, **kw)
        self.proj_out = LoraDense(5 * dim, dim, **nkw)

    def forward(self, x: Tensor, temb: Tensor, rope: Rope, seq: Optional[Mesh] = None,
                segments: Optional[Tuple[int, ...]] = None) -> Tensor:
        norm_x, gate = self.norm(x, temb)
        norm_x = region_in(norm_x, self.tp)    # one column region: proj_mlp and q, k, v
        mlp = F.gelu(self.proj_mlp(norm_x), approximate="tanh")
        attn_out = self.attn(norm_x, rope, seq, segments)
        return x + gate * self.proj_out(torch.cat([attn_out, mlp], dim=-1))


class AdaLayerNormContinuous(nn.Module):
    """silu(temb) -> fp32 Linear(2*dim) -> (scale, shift) over an affine-free
    LayerNorm (the linear column-sharded and gathered under TP)."""

    tp = Mesh()

    def __init__(self, dim: int, *, weight_quant: str = "none", device=None):
        super().__init__()
        self.linear = Fp32Linear(dim, 2 * dim, weight_quant=weight_quant, device=device)

    def forward(self, x: Tensor, temb: Tensor) -> Tensor:
        emb = gather_last(self.linear(region_in(F.silu(temb.float()), self.tp)), self.tp)[:, None, :]
        scale, shift = emb.chunk(2, dim=-1)
        return _layer_norm(x) * (1.0 + scale) + shift


# ---------------------------------------------------------------------------
# The transformer
# ---------------------------------------------------------------------------
class FluxTransformer2D(nn.Module):
    """Forward signature mirrors the diffusers call (hidden_states are
    pre-packed latent tokens; ids carry no batch dim). `tp`: the model axis
    it is sharded over (`parallel/tensor_parallel.py`), size 1 when whole;
    `fsdp`: the plan of its base split over the data axis
    (`parallel/fsdp.py`), None when whole."""

    tp = Mesh()
    fsdp = None

    def __init__(self, config: FluxTransformerConfig, *, lora_rank: int = 0,
                 lora_alpha: float = 0.0, weight_quant: str = "none", remat: bool = False,
                 device=None, dtype=None):
        super().__init__()
        if weight_quant not in WEIGHT_QUANT_MODES:
            raise ValueError(f"Unknown weight_quant mode {weight_quant!r}.")
        cfg = config
        self.config = cfg
        self.weight_quant = weight_quant
        # recompute each block in the backward instead of keeping its
        # activations (`nn.remat` in the JAX package); off when no gradient
        # is being recorded
        self.remat = remat
        nkw = {"device": device, "dtype": dtype, "weight_quant": weight_quant}
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
        self.norm_out = AdaLayerNormContinuous(dim, weight_quant=weight_quant, device=device)
        self.proj_out = LoraDense(dim, cfg.out_channels or cfg.in_channels, **nkw)

    def _unit(self, name: str, module: nn.Module, *args):
        """`module(*args)`; under FSDP on its leaves gathered for the call."""
        return module(*args) if self.fsdp is None else self.fsdp.call(name, module, *args)

    def _run_block(self, name: str, block: nn.Module, *args):
        # the FSDP gather runs inside what the checkpoint recomputes
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._unit, name, block, *args, use_reentrant=False)
        return self._unit(name, block, *args)

    def forward(
        self,
        hidden_states: Tensor,          # (B, img_seq, in_channels)
        encoder_hidden_states: Tensor,  # (B, txt_seq, joint_attention_dim)
        pooled_projections: Tensor,     # (B, pooled_projection_dim)
        timestep: Tensor,               # (B,) already divided by 1000
        img_ids: Tensor,                # (img_seq, 3)
        txt_ids: Tensor,                # (txt_seq, 3)
        guidance: Optional[Tensor] = None,  # (B,)
        seq: Optional[Mesh] = None,
    ) -> Tensor:
        """`seq` (a sequence axis of size above 1): the streams and their ids
        are this rank's contiguous 1/sp of each (`parallel/sequence_parallel.
        py::local_part`), and so is the prediction that comes back."""
        cfg = self.config
        img = self._unit("x_embedder", self.x_embedder, hidden_states)
        txt = self._unit("context_embedder", self.context_embedder, encoder_hidden_states)
        temb = self._unit("time_text_embed", self.time_text_embed, timestep, guidance, pooled_projections)
        rope = rope_frequencies(torch.cat([txt_ids, img_ids], dim=0), cfg.axes_dims_rope)
        for i, block in enumerate(self.transformer_blocks):
            img, txt = self._run_block(f"transformer_blocks.{i}", block, img, txt, temb, rope, seq)
        segments = (txt.shape[1], img.shape[1])
        x = torch.cat([txt, img], dim=1)  # txt first
        for i, block in enumerate(self.single_transformer_blocks):
            x = self._run_block(f"single_transformer_blocks.{i}", block, x, temb, rope, seq, segments)
        x = x[:, txt.shape[1]:]
        x = self._unit("norm_out", self.norm_out, x, temb).to(self.proj_out.compute_dtype)
        return self._unit("proj_out", self.proj_out, x)


# ---------------------------------------------------------------------------
# LoRA targets
# ---------------------------------------------------------------------------
# the linears of a block that carry an adapter (peft target_modules of the
# reference stage): attention projections and the feed-forward pair
LORA_TARGET_SUFFIXES = (
    ".to_q", ".to_k", ".to_v", ".to_out.0",
    ".add_q_proj", ".add_k_proj", ".add_v_proj", ".to_add_out",
    ".net.0.proj", ".net.2",
)


def lora_target_modules(transformer: FluxTransformer2D) -> List[Tuple[str, LoraDense]]:
    """(name, module) of every linear that takes an adapter, in module order."""
    return [(name, m) for name, m in transformer.named_modules()
            if isinstance(m, LoraDense) and name.endswith(LORA_TARGET_SUFFIXES)
            and name.startswith(("transformer_blocks.", "single_transformer_blocks."))]


def add_lora(transformer: FluxTransformer2D, rank: int, alpha: float,
             generator: Optional[torch.Generator] = None) -> None:
    """Attach fresh adapters to every target linear (peft's add_adapter)."""
    if rank <= 0:
        raise ValueError("lora_rank must be > 0 to initialize LoRA.")
    for _, module in lora_target_modules(transformer):
        module.add_adapter(rank, alpha, generator)


def freeze_base_parameters(module: nn.Module) -> List[nn.Parameter]:
    """Turn the gradient off for every parameter that is not an adapter and
    on for the adapters; returns the adapters."""
    adapters = []
    for name, p in module.named_parameters():
        is_adapter = name.rsplit(".", 1)[-1] in ("lora_A", "lora_B")
        p.requires_grad_(is_adapter)
        if is_adapter:
            adapters.append(p)
    return adapters
