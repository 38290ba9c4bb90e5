"""Fused GroupNorm-apply + SiLU + 3x3 conv + bias (NHWC, stride 1), without
the statistics epilogue of the whole-block kernel.

Counterpart of `ragb_vae_tpu/ops/pallas/fused_gn_silu_conv.py`. `a` / `b` are
the folded GroupNorm coefficients (gn(x) = x*a + b, `group_norm_coeffs`); the
activated tensor is rounded to x's dtype and feeds the conv without going to
device memory. A CPU tensor takes `fused_gn_silu_conv3x3_plain`; a CUDA tensor
launches the hand-written kernel (`ragb_fused_gn_silu_conv3x3` in
`csrc/conv_kernels.cu`: K1's mode of the conv engine in `csrc/conv_sm90.cuh`,
with no skip and no statistics) or raises. The backward differentiates the plain
version, as the JAX package differentiates its XLA reference.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ragb_vae_tpu_torch.ops.kernels import _build
from ragb_vae_tpu_torch.ops.kernels.resnet_block import (
    _check_cuda,
    _check_dtype,
    _conv3x3_nhwc,
    _ptr,
    plain_vjp,
)

Tensor = torch.Tensor

# launches of the kernel since the last reset (the plain version never counts)
LAUNCHES = 0


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def fused_gn_silu_conv3x3_plain(x: Tensor, a: Tensor, b: Tensor, w: Tensor, bias: Tensor) -> Tensor:
    """Plain version of the kernel (counterpart of `_xla_ref`), batched:
    x (B, H, W, C), a / b (B, C). The activation is rounded to x's dtype
    before the conv; the bias is added in the conv's output dtype."""
    t = x.float() * a.float()[:, None, None, :] + b.float()[:, None, None, :]
    t = F.silu(t).to(x.dtype)
    out = _conv3x3_nhwc(t, w.to(x.dtype))
    return out + bias.to(out.dtype)


def fused_gn_silu_conv3x3_cuda(x: Tensor, a: Tensor, b: Tensor, w: Tensor, bias: Tensor) -> Tensor:
    """Launch the kernel (`ragb_fused_gn_silu_conv3x3`) on x (B, H, W, C)
    with per-sample a, b (B, C)."""
    global LAUNCHES
    name = "fused_gn_silu_conv3x3"
    if x.ndim != 4 or w.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(f"{name}: x {tuple(x.shape)} and w {tuple(w.shape)} do not match")
    bsz, height, width, c_in = x.shape
    n_out = w.shape[3]
    x = x.contiguous()
    w = w.to(x.dtype).contiguous()
    a = a.float().contiguous()
    b = b.float().contiguous()
    bias = bias.float().contiguous()
    _check_cuda(name, x=x, a=a, b=b, w=w, bias=bias)
    _check_dtype(name, torch.bfloat16, x=x, w=w)
    if a.shape != (bsz, c_in) or b.shape != (bsz, c_in) or bias.shape != (n_out,):
        raise ValueError(f"{name}: coefficient or bias shapes do not match")
    if c_in % 8 or n_out % 8:
        raise ValueError(f"{name}: channel counts must be multiples of 8, got C={c_in} N={n_out}")
    y = torch.empty((bsz, height, width, n_out), dtype=x.dtype, device=x.device)
    err = _build.launch(
        "ragb_fused_gn_silu_conv3x3", x.device,
        _ptr(x), _ptr(a), _ptr(b), _ptr(w), _ptr(bias), _ptr(y), bsz, height, width, c_in, n_out,
    )
    _build.check(err, name)
    LAUNCHES += 1
    return y


class _FusedGnSiluConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, w, bias):
        ctx.save_for_backward(x, a, b, w, bias)
        if x.is_cuda:
            return fused_gn_silu_conv3x3_cuda(x, a, b, w, bias)
        return fused_gn_silu_conv3x3_plain(x, a, b, w, bias)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return plain_vjp(fused_gn_silu_conv3x3_plain, ctx.saved_tensors, (g,))


def group_norm_coeffs(x: Tensor, scale: Tensor, bias: Tensor, num_groups: int,
                      eps: float = 1e-6) -> Tuple[Tensor, Tensor]:
    """Fold GroupNorm statistics of x (B, H, W, C) into per-(batch, channel)
    fp32 coefficients (a, b) with gn(x) = x*a + b."""
    bsz, c = x.shape[0], x.shape[-1]
    grouped = x.float().reshape(bsz, -1, num_groups, c // num_groups)
    mean = grouped.mean(dim=(1, 3))
    meansq = grouped.square().mean(dim=(1, 3))
    rstd = torch.rsqrt(meansq - mean.square() + eps)
    rstd_c = rstd.repeat_interleave(c // num_groups, dim=1)
    mean_c = mean.repeat_interleave(c // num_groups, dim=1)
    a = scale.float()[None, :] * rstd_c
    return a, bias.float()[None, :] - mean_c * a


def fused_gn_silu_conv3x3_batched(x: Tensor, a: Tensor, b: Tensor, w: Tensor, bias: Tensor) -> Tensor:
    """(B, H, W, C) with per-sample (B, C) coefficients; the batch is a grid
    axis of the kernel."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_gn_silu_conv3x3: unsupported device {x.device}")
    return _FusedGnSiluConv.apply(x, a, b, w, bias)


def fused_gn_silu_conv3x3(x: Tensor, a: Tensor, b: Tensor, w: Tensor, bias: Tensor) -> Tensor:
    """silu(x*a + b) -> conv3x3 SAME -> + bias. x (H, W, C), a / b (C,)."""
    if x.ndim != 3:
        raise ValueError(f"fused_gn_silu_conv3x3: x must be (H, W, C), got {tuple(x.shape)}")
    return fused_gn_silu_conv3x3_batched(x[None], a[None], b[None], w, bias)[0]
