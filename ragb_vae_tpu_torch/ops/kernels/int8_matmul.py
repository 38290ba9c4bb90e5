"""Weight-only int8 matmul: y = (x @ q) * scale (+ bias).

Counterpart of `ragb_vae_tpu/ops/pallas/int8_matmul.py`. The int8 weights are
the storage format of the FLUX transformer's linears under
`weight_quant="int8"`; the product still runs on bf16 (or fp32) activations.
int8 magnitudes are exact in bf16, so the dot sees the stored integers
exactly; the per-output-channel scale and the bias are applied once to the
fp32 accumulator and the result is rounded once to x's dtype.

The weights come as `weight_q` (N, K): one output channel per row, as
`nn.Linear` keeps its weight and as the kernel reads it. The JAX package's
`kernel_q` is (K, N): whoever carries weights across transposes them once
(`models/flux_weights.py`), never per call.

Dispatch: a CPU tensor takes `int8_matmul_plain`; a CUDA tensor launches the
hand-written kernel in `csrc/int8_matmul.cu` or raises. The backward is plain
`torch.matmul` on every device, as the JAX package's is the XLA VJP of its
reference outside any kernel: dx = (g * scale) @ weight_q, with the int8
weights cast for the call (one layer's weights at a time).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ragb_vae_tpu_torch.ops.kernels import _build

Tensor = torch.Tensor

# launches of the kernel since the last reset (the plain version never counts)
LAUNCHES = 0


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def int8_matmul_plain(x: Tensor, weight_q: Tensor, scale: Tensor, bias: Optional[Tensor] = None) -> Tensor:
    """Plain version of the kernel (counterpart of `_xla_epilogue`): the
    product in x's dtype over the exactly cast integers, then scale and bias
    in fp32 and one rounding. weight_q: (N, K) int8."""
    y = torch.matmul(x, weight_q.to(x.dtype).t()).float() * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def int8_matmul_cuda(x: Tensor, weight_q: Tensor, scale: Tensor, bias: Optional[Tensor] = None) -> Tensor:
    """Launch the kernel (`ragb_int8_matmul`). x: (..., K) bf16 or fp32;
    weight_q: (N, K) int8; scale, bias: (N,) fp32. K must be a multiple of 16
    and N of 8. The library picks between its two kernels from the row count
    and x's type."""
    global LAUNCHES
    name = "int8_matmul"
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: x must be bfloat16 or float32, got {x.dtype}")
    if weight_q.dtype != torch.int8 or weight_q.ndim != 2:
        raise ValueError(f"{name}: weight_q must be a 2-d int8 tensor, got {weight_q.dtype} {tuple(weight_q.shape)}")
    n_out, k_in = weight_q.shape
    if x.shape[-1] != k_in:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not end in K = {k_in}")
    if k_in % 16 or n_out % 8:
        raise ValueError(f"{name}: K must be a multiple of 16 and N of 8, got K={k_in} N={n_out}")
    scale = scale.float().contiguous()
    bias = None if bias is None else bias.float().contiguous()
    if scale.shape != (n_out,) or (bias is not None and bias.shape != (n_out,)):
        raise ValueError(f"{name}: scale and bias must be ({n_out},)")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k_in).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    weight_q = weight_q.contiguous()
    for key, t in (("x", x2), ("weight_q", weight_q), ("scale", scale), ("bias", bias)):
        if t is not None and not t.is_cuda:
            raise ValueError(f"{name}: {key} must be a CUDA tensor, got {t.device}")
    rows = x2.shape[0]
    y = torch.empty((rows, n_out), dtype=x.dtype, device=x.device)
    if rows:
        ptr = lambda t: None if t is None else ctypes.c_void_p(t.data_ptr())
        err = _build.launch(
            "ragb_int8_matmul", x.device,
            ptr(x2), ptr(weight_q), ptr(scale), ptr(bias), ptr(y), rows, n_out, k_in,
            1 if x.dtype == torch.float32 else 0,
        )
        _build.check(err, name)
        LAUNCHES += 1
    return y.reshape(*lead, n_out)


class _Int8Matmul(torch.autograd.Function):
    """The kernel forward with a `torch.matmul` backward. The weights are
    int8 and take no gradient; dscale and dbias are computed only when asked
    (the base is frozen under QLoRA)."""

    @staticmethod
    def forward(ctx, x, weight_q, scale, bias):
        if x.is_cuda:
            y = int8_matmul_cuda(x, weight_q, scale, bias)
        else:
            y = int8_matmul_plain(x, weight_q, scale, bias)
        # x is needed only for dscale: under a frozen base it is not kept
        ctx.save_for_backward(x if ctx.needs_input_grad[2] else None, weight_q, scale)
        ctx.x_dtype = x.dtype
        ctx.has_bias = bias is not None
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, weight_q, scale = ctx.saved_tensors
        need_x, _, need_scale, need_bias = ctx.needs_input_grad
        dx = dscale = dbias = None
        gf = g.float()
        if need_x:
            dx = torch.matmul((gf * scale.float()).to(ctx.x_dtype), weight_q.to(ctx.x_dtype))
        if need_scale:
            # d/dscale of (x @ q) * scale: the unscaled product against g, per channel
            acc = torch.matmul(x, weight_q.to(x.dtype).t()).float()
            dscale = (gf * acc).reshape(-1, acc.shape[-1]).sum(dim=0).to(scale.dtype)
        if need_bias and ctx.has_bias:
            dbias = gf.reshape(-1, gf.shape[-1]).sum(dim=0)
        return dx, None, dscale, dbias


def int8_matmul(x: Tensor, weight_q: Tensor, scale: Tensor, bias: Optional[Tensor] = None) -> Tensor:
    """x (..., K) @ int8 `weight_q` (N, K), per-output-channel fp32 `scale`
    (N,), optional fp32 `bias` (N,) -> (..., N) in x.dtype, computed as
    (x @ weight_q^T) * scale + bias with fp32 accumulation and one output
    rounding."""
    if weight_q.ndim != 2 or weight_q.shape[1] != x.shape[-1]:
        raise ValueError(f"int8_matmul: weight_q must be (N, K) with K = {x.shape[-1]}, got {tuple(weight_q.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    return _Int8Matmul.apply(x, weight_q, scale, bias)
