"""The reference's arithmetic: float32 with TF32 off, or the control's lower
precision.

`Numerics("fp32")` is the plain reference. `Numerics("fp8")` is the control
the correctness check is shown to fail with: every operand of a matrix
product or convolution (weights and activations alike) is rounded to
float8 e4m3 with one scale per tensor (amax / 448) before the float32
product, and in training the gradient that reaches each product's output
is rounded the same way, with its own scale, before the backward
products. That is the step below the bf16 the configurations state.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
_FP8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for matmuls and convolutions inside; the settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _round_fp8(t: Tensor) -> Tensor:
    """`t` rounded to float8 e4m3 with one scale per tensor, in float32."""
    scale = t.abs().amax().clamp(min=1e-30) / _FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8Operand(torch.autograd.Function):
    """The operand rounded going forward; its gradient passed straight through
    (an unscaled float8 cast would flush the gradient to zero)."""

    @staticmethod
    def forward(ctx, t):
        return _round_fp8(t)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _Fp8Grad(torch.autograd.Function):
    """Unchanged going forward; the gradient of a product's output rounded
    with its own scale going back, so the backward products take float8 too."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _round_fp8(grad.float())


class Numerics:
    """Where the reference rounds: `q` is applied to each operand of each
    product; everything else is float32."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown reference precision {precision!r}")
        self.precision = precision

    def q(self, t: Tensor) -> Tensor:
        t = t.float()
        return t if self.precision == "fp32" else _Fp8Operand.apply(t)

    def g(self, y: Tensor) -> Tensor:
        """A product's output, whose gradient the backward products take."""
        return y if self.precision == "fp32" else _Fp8Grad.apply(y)

    def linear(self, x: Tensor, w: Tensor, b=None) -> Tensor:
        return self.g(F.linear(self.q(x), self.q(w), None if b is None else b.float()))

    def conv(self, x: Tensor, w: Tensor, b=None, *, stride: int = 1, padding: int = 0) -> Tensor:
        return self.g(F.conv2d(self.q(x), self.q(w), None if b is None else b.float(), stride=stride,
                               padding=padding))

    def attention(self, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
        """softmax(q k^T / sqrt(d)) v over (..., S, D), materialised in float32."""
        scores = self.g(torch.matmul(self.q(q), self.q(k).transpose(-1, -2))) * (q.shape[-1] ** -0.5)
        return self.g(torch.matmul(self.q(torch.softmax(scores, dim=-1)), self.q(v)))
