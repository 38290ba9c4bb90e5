"""AutoencoderKL-compatible VAE in PyTorch (channels-last).

Counterpart of `ragb_vae_tpu/models/vae.py`. Module and parameter names are
the diffusers `AutoencoderKL` state-dict keys, so a diffusers checkpoint
loads with `load_state_dict`. Tensors between modules are NHWC, as in the
JAX package; the plain convolutions run on NCHW-shaped views of them.

GroupNorm statistics are fp32; the normalisation is applied as one
multiply-add `x*a + b` in the compute dtype. With `fused=True` each
ResnetBlock runs as two launches of the whole-block kernel
(`ops/kernels/resnet_block.py`) and hands the per-channel (sum, sumsq) of
its output to the next block, exactly as the JAX package threads them:
blocks chain the statistics, attention breaks the chain, the fused Upsample
re-seeds it, and `conv_norm_out` is seeded from it.

Parameters and compute may have different dtypes: training keeps fp32
parameters for the optimizer and runs activations and kernel operands in
`compute_dtype` (bf16 on the card), as the JAX package's modules do with
their `dtype`. `remat` checkpoints resnet blocks ("all": every block of the
down / up stacks, "half": the even-indexed ones, "none") with
`torch.utils.checkpoint`, which runs their forward kernels once more inside
the backward.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
from ragb_vae_tpu_torch.ops.gaussian import DiagonalGaussian
from ragb_vae_tpu_torch.ops.kernels.conv3x3 import conv3x3_same_batched
from ragb_vae_tpu_torch.ops.kernels.flash_attention import attention
from ragb_vae_tpu_torch.ops.kernels import resnet_block
from ragb_vae_tpu_torch.ops.kernels.resnet_block import (
    fold_subpixel_weights,
    fused_downsample_conv3x3_stats,
    fused_resnet_block,
    fused_upsample_conv3x3_stats,
    stats_to_coeffs,
    tensor_stats,
    wino_tiles,
)

Tensor = torch.Tensor
Stats = Optional[Tensor]


def _hwio(w: Tensor) -> Tensor:
    """OIHW conv weight -> HWIO (the kernels' layout)."""
    return w.permute(2, 3, 1, 0)


class _KernelWeights(nn.Module):
    """Keeps the kernel-layout copies of a fused module's weights (HWIO,
    folded, fp32 biases) across calls instead of remaking them per launch.

    A copy is remade when its source tensor is written in place (its version
    counter moves, as an optimizer step moves it), and all copies are dropped
    when the module is moved or cast (`_apply`) or loads a state dict. While
    autograd records a parameter that requires grad nothing is kept and the
    parameter's own dtype is passed on, so the kernel's fp32 weight cotangent
    reaches an fp32 parameter unrounded; a kept copy is in `dtype`. A copy
    no gradient flows through (`detached`) is kept under autograd too."""

    def _derived(self, name: str, src: Tensor, make: Callable[[Tensor], Tensor],
                 dtype: Optional[torch.dtype] = None, detached: bool = False) -> Tensor:
        if torch.is_grad_enabled() and src.requires_grad and not detached:
            return make(src)
        key = (src.data_ptr(), -1 if src.is_inference() else src._version, dtype)
        cache = self.__dict__.setdefault("_derived_cache", {})
        hit = cache.get(name)
        if hit is None or hit[0] != key:
            hit = cache[name] = (key, make(src.detach().to(dtype or src.dtype)))
        return hit[1]

    def _apply(self, fn, *args, **kwargs):
        self.__dict__.pop("_derived_cache", None)
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self.__dict__.pop("_derived_cache", None)
        return super()._load_from_state_dict(*args, **kwargs)


def compute_dtype_of(module: nn.Module, weight: Tensor) -> torch.dtype:
    """The dtype a module computes in: its `compute_dtype` when one was set
    (`AutoencoderKL.set_compute_dtype`), else its parameters' dtype."""
    return getattr(module, "compute_dtype", None) or weight.dtype


def conv_nhwc(conv: nn.Conv2d, x: Tensor) -> Tensor:
    """Apply an nn.Conv2d to an NHWC tensor in the conv's compute dtype; NHWC out."""
    dtype = compute_dtype_of(conv, conv.weight)
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), conv.weight.to(dtype),
                 None if conv.bias is None else conv.bias.to(dtype), conv.stride, conv.padding)
    return y.permute(0, 2, 3, 1)


def linear_cd(linear: nn.Linear, x: Tensor) -> Tensor:
    """Apply an nn.Linear in its compute dtype."""
    dtype = compute_dtype_of(linear, linear.weight)
    return F.linear(x.to(dtype), linear.weight.to(dtype), linear.bias.to(dtype))


def _apply_coeffs(x: Tensor, a: Tensor, b: Tensor, dtype: torch.dtype) -> Tensor:
    bsz, c = a.shape
    return x.to(dtype) * a.reshape(bsz, 1, 1, c).to(dtype) + b.reshape(bsz, 1, 1, c).to(dtype)


class Conv3x3(nn.Module):
    """3x3 stride-1 SAME conv through the bare conv kernel
    (`ops/kernels/conv3x3.py`), with nn.Conv2d's parameters (`conv.weight`
    OIHW, `conv.bias`). Not wired into the model, as in the JAX package: the
    whole-block kernel fuses the same conv with its norm, activation and
    epilogue."""

    def __init__(self, in_channels: int, out_channels: int, **kw):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1, **kw)

    def forward(self, x: Tensor) -> Tensor:
        dtype = compute_dtype_of(self, self.conv.weight)
        out = conv3x3_same_batched(x.to(dtype), _hwio(self.conv.weight).to(dtype))
        return out + self.conv.bias.to(dtype)


class FastGroupNorm(nn.GroupNorm):
    """GroupNorm with fp32 statistics and compute-dtype application.

    Same parameters as nn.GroupNorm (weight/bias). `stats` (B, 2, C), when
    given, are the (sum, sumsq) a fused kernel already produced for x; the
    normalisation then costs no statistics pass."""

    def __init__(self, num_groups: int, num_channels: int, **kw):
        super().__init__(num_groups, num_channels, eps=1e-6, **kw)

    def forward(self, x: Tensor, stats: Stats = None) -> Tensor:
        _, h, w, _ = x.shape
        if stats is None:
            stats = tensor_stats(x)
        a, b = stats_to_coeffs(stats, self.weight, self.bias, self.num_groups, h * w, self.eps)
        return _apply_coeffs(x, a, b, compute_dtype_of(self, self.weight))


class ResnetBlock(_KernelWeights):
    """GroupNorm -> SiLU -> Conv3x3 (x2) with an additive (1x1-projected) skip.
    forward returns (out, stats); stats is None on the unfused path."""

    def __init__(self, in_channels: int, out_channels: int, num_groups: int, fused: bool = False, **kw):
        super().__init__()
        self.fused = fused
        self.num_groups = num_groups
        self.norm1 = FastGroupNorm(num_groups, in_channels, **kw)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, **kw)
        self.norm2 = FastGroupNorm(num_groups, out_channels, **kw)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, **kw)
        self.conv_shortcut = (
            nn.Conv2d(in_channels, out_channels, 1, **kw) if in_channels != out_channels else None
        )

    def _kernel_conv(self, name: str, conv: nn.Conv2d, layout, dtype: torch.dtype) -> dict:
        """{kernel: conv's weight in the kernel's layout, bias: fp32}, kept across calls."""
        return {"kernel": self._derived(name, conv.weight, layout, dtype),
                "bias": self._derived(name + ".bias", conv.bias, lambda b: b.float())}

    def _wino_tiles(self, name: str, conv: nn.Conv2d, dtype: torch.dtype) -> Tensor:
        """The Winograd route's U = G w G^T of conv's weight in `dtype`
        (`wino_tiles`), kept across calls and steps while the weight is
        unchanged: the backward differentiates w itself, never U."""
        return self._derived(name + ".u", conv.weight, lambda w: wino_tiles(_hwio(w), dtype), dtype,
                             detached=True)

    def forward(self, x: Tensor, stats: Stats = None) -> Tuple[Tensor, Stats]:
        dtype = compute_dtype_of(self, self.conv1.weight)
        if self.fused:
            p = {
                "norm1": {"scale": self.norm1.weight, "bias": self.norm1.bias},
                "conv1": self._kernel_conv("conv1", self.conv1, lambda w: _hwio(w).contiguous(), dtype),
                "norm2": {"scale": self.norm2.weight, "bias": self.norm2.bias},
                "conv2": self._kernel_conv("conv2", self.conv2, lambda w: _hwio(w).contiguous(), dtype),
            }
            if x.is_cuda and resnet_block.CONV_ALGO == "winograd":
                for name in ("conv1", "conv2"):
                    p[name]["u"] = self._wino_tiles(name, getattr(self, name), dtype)
            if self.conv_shortcut is not None:
                p["conv_shortcut"] = self._kernel_conv(
                    "conv_shortcut", self.conv_shortcut, lambda w: w[:, :, 0, 0].t().contiguous(), dtype)
            return fused_resnet_block(x.to(dtype), p, num_groups=self.num_groups, stats=stats)
        h = F.silu(self.norm1(x)).to(dtype)
        h = conv_nhwc(self.conv1, h)
        h = F.silu(self.norm2(h)).to(dtype)
        h = conv_nhwc(self.conv2, h)
        if self.conv_shortcut is not None:
            x = conv_nhwc(self.conv_shortcut, x)
        return x.to(h.dtype) + h, None


class Downsample(nn.Module):
    """Asymmetric (0,1)x(0,1) pad then a stride-2 conv (diffusers Downsample2D).
    fused=True runs the stride-2 conv kernel and returns the statistics of
    its output, so the next level's first fused block needs no statistics
    pass. The Encoder builds it unfused even on its fused path, as the JAX
    package's does."""

    def __init__(self, channels: int, fused: bool = False, **kw):
        super().__init__()
        self.fused = fused
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0, **kw)

    def forward(self, x: Tensor) -> Tuple[Tensor, Stats]:
        if self.fused:
            dtype = compute_dtype_of(self, self.conv.weight)
            return fused_downsample_conv3x3_stats(
                x.to(dtype), _hwio(self.conv.weight).to(dtype), self.conv.bias)
        return conv_nhwc(self.conv, F.pad(x, (0, 0, 0, 1, 0, 1))), None


class Upsample(_KernelWeights):
    """Nearest-neighbour 2x then conv3x3 (diffusers Upsample2D). fused=True
    runs the sub-pixel kernel, which reads only the small tensor and returns
    the statistics of its output."""

    def __init__(self, channels: int, fused: bool = False, **kw):
        super().__init__()
        self.fused = fused
        self.conv = nn.Conv2d(channels, channels, 3, padding=1, **kw)

    def forward(self, x: Tensor) -> Tuple[Tensor, Stats]:
        dtype = compute_dtype_of(self, self.conv.weight)
        x = x.to(dtype)
        if self.fused:
            # the kernel takes the sub-pixel weights folded in fp32 and rounded
            # once; the fold is kept across calls unless a gradient is recorded
            # (the backward kernel differentiates with respect to the weights
            # themselves, so the forward folds them anew)
            weight = self.conv.weight
            w_fold = None
            if x.is_cuda and not (torch.is_grad_enabled() and weight.requires_grad):
                w_fold = self._derived("w_fold", weight, lambda w: fold_subpixel_weights(
                    _hwio(w).float()).to(w.dtype).contiguous(), dtype)
            return fused_upsample_conv3x3_stats(x, _hwio(weight), self.conv.bias, w_fold=w_fold)
        up = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return conv_nhwc(self.conv, up), None


class SpatialAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid block (diffusers
    `Attention` with group_norm, to_q/to_k/to_v/to_out.0 and a residual)."""

    def __init__(self, channels: int, num_groups: int, **kw):
        super().__init__()
        self.group_norm = FastGroupNorm(num_groups, channels, **kw)
        self.to_q = nn.Linear(channels, channels, **kw)
        self.to_k = nn.Linear(channels, channels, **kw)
        self.to_v = nn.Linear(channels, channels, **kw)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels, **kw)])

    def forward(self, x: Tensor) -> Tensor:
        b, h, w, c = x.shape
        y = self.group_norm(x).reshape(b, h * w, c)
        q, k, v = linear_cd(self.to_q, y), linear_cd(self.to_k, y), linear_cd(self.to_v, y)
        out = attention(q[:, None], k[:, None], v[:, None])[:, 0]
        return x + linear_cd(self.to_out[0], out).reshape(b, h, w, c)


class MidBlock(nn.Module):
    def __init__(self, channels: int, num_groups: int, add_attention: bool, fused: bool = False, **kw):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(channels, channels, num_groups, fused, **kw) for _ in range(2)]
        )
        self.attentions = nn.ModuleList(
            [SpatialAttention(channels, num_groups, **kw)] if add_attention else []
        )

    def forward(self, x: Tensor) -> Tuple[Tensor, Stats]:
        x, stats = self.resnets[0](x)
        if len(self.attentions):
            # attention rewrites x: the epilogue stats no longer describe it
            x = self.attentions[0](x)
            stats = None
        return self.resnets[1](x, stats)


def _remat_block(remat: Union[bool, str], idx: int) -> bool:
    """Whether resnet block `idx` of a down / up stack is checkpointed:
    True / "all" every block, "half" the even-indexed ones (half the
    recompute for about half the activation saving), False / "none" none."""
    if remat not in (True, False, "all", "half", "none"):
        raise ValueError(f"remat must be 'all', 'half' or 'none', got {remat!r}")
    return remat in (True, "all") or (remat == "half" and idx % 2 == 0)


def _run_block(resnet: nn.Module, x: Tensor, stats: Stats, remat: bool) -> Tuple[Tensor, Stats]:
    if remat and torch.is_grad_enabled():
        return checkpoint(resnet, x, stats, use_reentrant=False)
    return resnet(x, stats)


class _DownBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, cfg: AutoencoderConfig, last: bool, fused: bool, **kw):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_ch if j == 0 else out_ch, out_ch, cfg.norm_num_groups, fused, **kw)
            for j in range(cfg.layers_per_block)
        ])
        self.downsamplers = nn.ModuleList([] if last else [Downsample(out_ch, **kw)])


class _UpBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, cfg: AutoencoderConfig, last: bool, fused: bool, **kw):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_ch if j == 0 else out_ch, out_ch, cfg.norm_num_groups, fused, **kw)
            for j in range(cfg.layers_per_block + 1)
        ])
        self.upsamplers = nn.ModuleList([] if last else [Upsample(out_ch, fused, **kw)])


class Encoder(nn.Module):
    def __init__(self, config: AutoencoderConfig, fused: bool = False,
                 remat: Union[bool, str] = "none", **kw):
        super().__init__()
        cfg = config
        ch = cfg.block_out_channels
        self.remat = remat
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1, **kw)
        self.down_blocks = nn.ModuleList([
            _DownBlock(ch[max(i - 1, 0)], out, cfg, i == len(ch) - 1, fused, **kw)
            for i, out in enumerate(ch)
        ])
        self.mid_block = MidBlock(ch[-1], cfg.norm_num_groups, cfg.mid_block_add_attention, fused, **kw)
        self.conv_norm_out = FastGroupNorm(cfg.norm_num_groups, ch[-1], **kw)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1, **kw)

    def forward(self, x: Tensor) -> Tensor:
        x = conv_nhwc(self.conv_in, x)
        stats = None  # conv_in seeds the chain fresh
        bi = 0
        for block in self.down_blocks:
            for resnet in block.resnets:
                x, stats = _run_block(resnet, x, stats, _remat_block(self.remat, bi))
                bi += 1
            for down in block.downsamplers:
                x, stats = down(x)
        x, stats = self.mid_block(x)
        return conv_nhwc(self.conv_out, F.silu(self.conv_norm_out(x, stats)))


class Decoder(nn.Module):
    def __init__(self, config: AutoencoderConfig, fused: bool = False,
                 remat: Union[bool, str] = "none", **kw):
        super().__init__()
        cfg = config
        self.remat = remat
        rev = tuple(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1, **kw)
        self.mid_block = MidBlock(rev[0], cfg.norm_num_groups, cfg.mid_block_add_attention, fused, **kw)
        self.up_blocks = nn.ModuleList([
            _UpBlock(rev[max(i - 1, 0)], out, cfg, i == len(rev) - 1, fused, **kw)
            for i, out in enumerate(rev)
        ])
        self.conv_norm_out = FastGroupNorm(cfg.norm_num_groups, rev[-1], **kw)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1, **kw)

    def forward(self, z: Tensor) -> Tensor:
        z = conv_nhwc(self.conv_in, z)
        z, stats = self.mid_block(z)
        bi = 0
        for block in self.up_blocks:
            for resnet in block.resnets:
                z, stats = _run_block(resnet, z, stats, _remat_block(self.remat, bi))
                bi += 1
            for up in block.upsamplers:
                # the fused Upsample re-seeds the chain from its epilogue
                z, stats = up(z)
        return conv_nhwc(self.conv_out, F.silu(self.conv_norm_out(z, stats)))


class AutoencoderKL(nn.Module):
    """KL autoencoder with a Gaussian posterior. NHWC in/out, values in [-1, 1]."""

    def __init__(self, config: AutoencoderConfig, *, fused: bool = False, device=None, dtype=None,
                 compute_dtype: Optional[torch.dtype] = None, remat: Union[bool, str] = "none"):
        super().__init__()
        _remat_block(remat, 0)  # validates the value
        kw = {"device": device, "dtype": dtype}
        self.config = config
        self.encoder = Encoder(config, fused, remat, **kw)
        self.decoder = Decoder(config, fused, remat, **kw)
        lat = config.latent_channels
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1, **kw) if config.use_quant_conv else None
        self.post_quant_conv = nn.Conv2d(lat, lat, 1, **kw) if config.use_post_quant_conv else None
        self.set_compute_dtype(compute_dtype)

    def set_compute_dtype(self, compute_dtype: Optional[torch.dtype]) -> None:
        """Run every module's activations and kernel operands in
        `compute_dtype` while the parameters keep their own dtype; None
        computes in the parameters' dtype."""
        for m in self.modules():
            m.compute_dtype = compute_dtype
            m.__dict__.pop("_derived_cache", None)

    def set_fused(self, fused: bool) -> None:
        """Switch every ResnetBlock and Upsample between the fused kernels
        and the plain modules; the parameters are the same either way."""
        for m in self.modules():
            if isinstance(m, (ResnetBlock, Upsample)):
                m.fused = fused

    def encode(self, x: Tensor) -> DiagonalGaussian:
        params = self.encoder(x)
        if self.quant_conv is not None:
            params = conv_nhwc(self.quant_conv, params)
        return DiagonalGaussian.from_params(params)

    def decode(self, z: Tensor) -> Tensor:
        if self.post_quant_conv is not None:
            z = conv_nhwc(self.post_quant_conv, z)
        return self.decoder(z)
