"""Flash attention (online softmax), forward.

Counterpart of `ragb_vae_tpu/ops/pallas/flash_attention.py` (forward only).
The FLUX blocks (24 heads x 128) and the VAE mid-block (1 head x 512) both
route through `attention`. A CPU tensor takes the plain PyTorch version
`attention_plain` (exact, query-chunked so no S x S matrix is held at once);
a CUDA tensor launches the hand-written kernel in `csrc/flash_attention.cu`
or raises.
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


def attention(q: Tensor, k: Tensor, v: Tensor, *, sm_scale: Optional[float] = None) -> Tensor:
    """(B, H, S, D) attention: the flash kernel on CUDA, the plain version on CPU."""
    b, h, s, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    q3 = q.reshape(b * h, s, d)
    k3 = k.reshape(b * h, k.shape[2], d)
    v3 = v.reshape(b * h, v.shape[2], d)
    if q.device.type == "cpu":
        out = attention_plain(q3, k3, v3, sm_scale=sm_scale)
    elif q.is_cuda:
        out, _ = flash_attention_cuda(q3, k3, v3, sm_scale=sm_scale)
    else:
        raise ValueError(f"attention: unsupported device {q.device}")
    return out.reshape(b, h, s, d)
