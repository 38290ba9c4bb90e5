"""Flash attention (online softmax): the forward kernel and its gradient.

Counterpart of `ragb_vae_tpu/ops/pallas/flash_attention.py`. The FLUX blocks
(24 heads x 128) and the VAE mid-block (1 head x 512) both route through
`attention`, a `torch.autograd.Function` on every device. Forward: a CPU
tensor takes the plain PyTorch version `attention_plain` (exact,
query-chunked so no S x S matrix is held at once); a CUDA tensor launches
the hand-written kernel in `csrc/flash_attention.cu` or raises.

Backward, routed by head dim as in the JAX package (`_uses_fused_bwd`): for
d >= 384 (the VAE mid-block) a query-chunked recompute in plain PyTorch that
saves only q, k, v and keeps one chunk's logits alive at a time; these
products sit outside any kernel in the JAX package too. For d < 384 the JAX
package runs its dQ and dK/dV kernels, which are not ported yet: on CUDA
such a call raises when a gradient is required instead of returning a
tensor cut off from the graph.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ragb_vae_tpu_torch.ops.kernels import _build

Tensor = torch.Tensor

# head dims the CUDA kernel is instantiated for
KERNEL_HEAD_DIMS = (128, 512)

# launches of the kernel since the last reset (the plain version never counts)
LAUNCHES = 0


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def attention_plain(q: Tensor, k: Tensor, v: Tensor, *, sm_scale: float, chunk: int = 1024) -> Tensor:
    """(BH, S, D) exact attention, q-chunked; logits and softmax in fp32
    (counterpart of `chunked_attention_3d`)."""
    outs = []
    for start in range(0, q.shape[1], chunk):
        q_blk = q[:, start : start + chunk]
        logits = torch.matmul(q_blk, k.transpose(1, 2)).float() * sm_scale
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(torch.matmul(weights, v))
    return torch.cat(outs, dim=1)


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, *, sm_scale: float) -> Tuple[Tensor, Tensor]:
    """Launch the K3 kernel on (BH, S, D) bf16 -> (out (BH, Sq, D), lse (BH, Sq) fp32)."""
    global LAUNCHES
    name = "flash_attention_fwd"
    for key, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {key} must be bfloat16, got {t.dtype}")
        if t.ndim != 3:
            raise ValueError(f"{name}: {key} must be (BH, S, D), got {tuple(t.shape)}")
    bh, seq_q, d = q.shape
    seq_k = k.shape[1]
    if k.shape != (bh, seq_k, d) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {KERNEL_HEAD_DIMS}")
    if bh > 65535:
        raise ValueError(f"{name}: batch*heads {bh} exceeds 65535")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((bh, seq_q), dtype=torch.float32, device=q.device)
    err = _build.library().ragb_flash_attention_fwd(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(lse.data_ptr()),
        bh, seq_q, seq_k, d, float(sm_scale),
        ctypes.c_void_p(_build.stream_ptr(q.device)),
    )
    _build.check(err, name)
    LAUNCHES += 1
    return out, lse


# head dims below this take the (unported) fused backward kernels in the JAX package
FUSED_BWD_MAX_HEAD_DIM = 384


def backward_route(device_type: str, head_dim: int) -> str:
    """Which backward a call that needs a gradient gets: "recompute" (the
    q-chunked plain PyTorch recompute) or "unported" (the JAX package's fused
    dQ / dK,dV kernels, K4/K5, have no counterpart yet: the call raises). The
    CPU has no kernels, so it always recomputes."""
    if device_type == "cuda" and head_dim < FUSED_BWD_MAX_HEAD_DIM:
        return "unported"
    return "recompute"


def attention_bwd_recompute(
    q: Tensor, k: Tensor, v: Tensor, g: Tensor, *, sm_scale: float, chunk: int = 1024
) -> Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) of `attention_plain` from q, k, v alone: each query chunk's
    logits and softmax are recomputed and differentiated, then dropped, so
    one (chunk, S) block is alive at a time (counterpart of the VJP of the
    rematerialised `chunked_attention_3d`)."""
    k_leaf = k.detach().requires_grad_(True)
    v_leaf = v.detach().requires_grad_(True)
    dk = torch.zeros_like(k, dtype=torch.float32)
    dv = torch.zeros_like(v, dtype=torch.float32)
    dqs = []
    for start in range(0, q.shape[1], chunk):
        with torch.enable_grad():
            q_blk = q[:, start : start + chunk].detach().requires_grad_(True)
            out = attention_plain(q_blk, k_leaf, v_leaf, sm_scale=sm_scale, chunk=chunk)
            dq_blk, dk_blk, dv_blk = torch.autograd.grad(
                out, (q_blk, k_leaf, v_leaf), g[:, start : start + chunk].to(out.dtype))
        dqs.append(dq_blk)
        dk += dk_blk
        dv += dv_blk
    return torch.cat(dqs, dim=1), dk.to(k.dtype), dv.to(v.dtype)


class _Attention(torch.autograd.Function):
    """(BH, S, D) attention; saves q, k, v only (the recompute backward needs
    neither the output nor the log-sum-exp)."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        if q.is_cuda:
            out, _ = flash_attention_cuda(q, k, v, sm_scale=sm_scale)
        else:
            out = attention_plain(q, k, v, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return attention_bwd_recompute(q, k, v, g, sm_scale=ctx.sm_scale) + (None,)


def attention(q: Tensor, k: Tensor, v: Tensor, *, sm_scale: Optional[float] = None) -> Tensor:
    """(B, H, S, D) attention: the flash kernel on CUDA, the plain version on
    CPU; differentiable as `backward_route` says."""
    b, h, s, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention: unsupported device {q.device}")
    needs_grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    if needs_grad and backward_route(q.device.type, d) == "unported":
        raise NotImplementedError(
            f"attention: backward not ported yet (K4/K5) for head dim {d} < "
            f"{FUSED_BWD_MAX_HEAD_DIM} on CUDA; run under torch.no_grad() or on the CPU")
    q3 = q.reshape(b * h, s, d)
    k3 = k.reshape(b * h, k.shape[2], d)
    v3 = v.reshape(b * h, v.shape[2], d)
    return _Attention.apply(q3, k3, v3, float(sm_scale)).reshape(b, h, s, d)
