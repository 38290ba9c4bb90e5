"""Bare 3x3 stride-1 SAME convolution (NHWC): no bias, no coefficients, no
statistics.

Counterpart of `ragb_vae_tpu/ops/pallas/conv3x3.py`. A CPU tensor takes
`conv3x3_same_plain`; a CUDA tensor launches the hand-written kernel
(`ragb_conv3x3_same` in `csrc/conv_kernels.cu`, an entry point over the TMA +
wgmma implicit-GEMM engine of `csrc/conv_sm90.cuh`) or raises. TMA's zero fill
outside the image is the SAME padding, so there is no padding pass and no
alignment rule beyond channel counts that are multiples of 8. The backward
differentiates the plain version, as the JAX package differentiates its XLA
reference.
"""
from __future__ import annotations

import torch

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


def conv3x3_same_plain(x: Tensor, w: Tensor) -> Tensor:
    """Plain version of the kernel (counterpart of `_xla_conv`), batched:
    x (B, H, W, C), w (3, 3, C, N) -> (B, H, W, N)."""
    return _conv3x3_nhwc(x, w.to(x.dtype))


def conv3x3_same_cuda(x: Tensor, w: Tensor) -> Tensor:
    """Launch the kernel (`ragb_conv3x3_same`) on x (B, H, W, C)."""
    global LAUNCHES
    name = "conv3x3_same"
    if x.ndim != 4 or w.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(f"{name}: x {tuple(x.shape)} and w {tuple(w.shape)} do not match")
    bsz, height, width, c_in = x.shape
    n_out = w.shape[3]
    x = x.contiguous()
    w = w.to(x.dtype).contiguous()
    _check_cuda(name, x=x, w=w)
    _check_dtype(name, torch.bfloat16, x=x, w=w)
    if c_in % 8 or n_out % 8:
        raise ValueError(f"{name}: channel counts must be multiples of 8, got C={c_in} N={n_out}")
    y = torch.empty((bsz, height, width, n_out), dtype=x.dtype, device=x.device)
    err = _build.launch(
        "ragb_conv3x3_same", x.device,
        _ptr(x), _ptr(w), _ptr(y), bsz, height, width, c_in, n_out,
    )
    _build.check(err, name)
    LAUNCHES += 1
    return y


class _Conv3x3Same(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda:
            return conv3x3_same_cuda(x, w)
        return conv3x3_same_plain(x, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return plain_vjp(conv3x3_same_plain, ctx.saved_tensors, (g,))


def conv3x3_same_batched(x: Tensor, w: Tensor) -> Tensor:
    """(B, H, W, C) or (H, W, C); the batch is a grid axis of the kernel."""
    if x.ndim == 3:
        return conv3x3_same(x, w)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3_same: unsupported device {x.device}")
    return _Conv3x3Same.apply(x, w)


def conv3x3_same(x: Tensor, w: Tensor) -> Tensor:
    """x (H, W, C), w (3, 3, C, N) -> (H, W, N); SAME padding, stride 1."""
    if x.ndim != 3:
        raise ValueError(f"conv3x3_same: x must be (H, W, C), got {tuple(x.shape)}")
    return conv3x3_same_batched(x[None], w)[0]
