"""Flash attention (online softmax): the forward kernel and its gradient.

Counterpart of `ragb_vae_tpu/ops/pallas/flash_attention.py`. The FLUX blocks
(24 heads x 128) and the VAE mid-block (1 head x 512) both route through
`attention`, a `torch.autograd.Function` on every device. Forward: a CPU
tensor takes the plain PyTorch version `attention_plain` (exact,
query-chunked so no S x S matrix is held at once); a CUDA tensor launches
the hand-written kernel in `csrc/flash_attention.cu` or raises. At head dim
512 the kernel may split the keys into ranges (`key_splits`) and merge the
ranges' partial results in a second kernel; `attention_partials_plain` and
`merge_partials_plain` restate that arithmetic in PyTorch.

Backward, routed by head dim as in the JAX package (`_uses_fused_bwd`):
- d < 384 (the FLUX blocks): the forward saves q, k, v, out and the
  log-sum-exp, and the backward is the FlashAttention-2 pair of kernels in
  `csrc/flash_attention_bwd.cu` on CUDA (dQ, then dK and dV; head dim 128
  only) and `attention_bwd_plain`, the same arithmetic in PyTorch, on the CPU;
- d >= 384 (the VAE mid-block): a query-chunked recompute in plain PyTorch
  that saves only q, k, v and keeps one chunk's logits alive at a time; these
  products sit outside any kernel in the JAX package too.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch

from ragb_vae_tpu_torch.ops.kernels import _build
from ragb_vae_tpu_torch.parallel.sequence_parallel import gather_seq

Tensor = torch.Tensor

# head dims the CUDA kernel is instantiated for
KERNEL_HEAD_DIMS = (128, 512)

# the head dim the backward kernels are written for
BWD_KERNEL_HEAD_DIM = 128

# launches of each kernel since the last reset (the plain versions never
# count): forward, dQ, dK/dV
LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0


def reset_launch_counts() -> None:
    global LAUNCHES, DQ_LAUNCHES, DKV_LAUNCHES
    LAUNCHES = DQ_LAUNCHES = DKV_LAUNCHES = 0


def attention_lse_plain(
    q: Tensor, k: Tensor, v: Tensor, *, sm_scale: float, chunk: int = 1024
) -> Tuple[Tensor, Tensor]:
    """(BH, S, D) exact attention, q-chunked; logits and softmax in fp32
    (counterpart of `chunked_attention_3d`). Returns (out, lse) with lse the
    (BH, Sq) fp32 log-sum-exp of the scaled logits, as the kernel writes it."""
    outs, lses = [], []
    for start in range(0, q.shape[1], chunk):
        q_blk = q[:, start : start + chunk]
        logits = torch.matmul(q_blk, k.transpose(1, 2)).float() * sm_scale
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(torch.matmul(weights, v))
        lses.append(torch.logsumexp(logits, dim=-1))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def attention_plain(q: Tensor, k: Tensor, v: Tensor, *, sm_scale: float, chunk: int = 1024) -> Tensor:
    """`attention_lse_plain` without the log-sum-exp."""
    return attention_lse_plain(q, k, v, sm_scale=sm_scale, chunk=chunk)[0]


# the d = 512 kernel's query rows per block and keys per tile; a key range
# of a split holds at least MIN_TILES_PER_SPLIT tiles
SPLIT_BLOCK_Q = 64
SPLIT_BLOCK_K = 32
MIN_TILES_PER_SPLIT = 8


def key_splits(bh: int, seq_q: int, seq_k: int, head_dim: int, sm_count: int = 132) -> int:
    """How many key ranges the forward kernel splits (BH, Sq, Sk, head_dim)
    into. Only head dim 512 splits: one block per 64 query rows per head,
    and while those blocks leave SMs idle, each gets sm_count // blocks key
    ranges of at least MIN_TILES_PER_SPLIT tiles of 32 keys. One head of 4096
    tokens (64 blocks) takes 2 on 132 SMs; 16384 tokens or 4 heads take 1."""
    if head_dim != 512:
        return 1
    blocks = bh * -(-seq_q // SPLIT_BLOCK_Q)
    if blocks >= sm_count:
        return 1
    tiles = -(-seq_k // SPLIT_BLOCK_K)
    return max(1, min(sm_count // blocks, tiles // MIN_TILES_PER_SPLIT))


def split_ranges(seq_k: int, splits: int, block_k: int = SPLIT_BLOCK_K) -> List[Tuple[int, int]]:
    """The key ranges [start, end) of `splits` splits, as the kernel cuts
    them: whole tiles of `block_k`, split s taking tiles s*n//splits up to
    (s+1)*n//splits of the n = ceil(seq_k / block_k); only the last range
    is ragged."""
    n = -(-seq_k // block_k)
    if not 1 <= splits <= n:
        raise ValueError(f"splits {splits} must be in [1, {n}] for {seq_k} keys")
    return [(s * n // splits * block_k, min(seq_k, (s + 1) * n // splits * block_k)) for s in range(splits)]


def attention_partials_plain(
    q: Tensor, k: Tensor, v: Tensor, *, sm_scale: float, start: int, end: int
) -> Tuple[Tensor, Tensor, Tensor]:
    """One key range's partial result, as a split of the kernel writes it:
    (O unnormalised (BH, Sq, D), m (BH, Sq) the row max of the scaled logits,
    l (BH, Sq) the sum of exp(logit - m)), all fp32; P is rounded to the
    input dtype before P V, as in the kernel."""
    logits = torch.matmul(q, k[:, start:end].transpose(1, 2)).float() * sm_scale
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    o = torch.matmul(p.to(v.dtype).float(), v[:, start:end].float())
    return o, m, p.sum(dim=-1)


def merge_partials_plain(o: Tensor, m: Tensor, l: Tensor, dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
    """Merge the splits' partials (stacked on a leading split axis) as the
    merge kernel does: w_s = exp(m_s - M) with M = max_s m_s, out = sum_s w_s
    O_s / sum_s w_s l_s rounded to `dtype` once, lse = M + log(sum_s w_s l_s)."""
    mx = m.amax(dim=0)
    wgt = torch.exp(m - mx)
    total = (wgt * l).sum(dim=0)
    out = (wgt[..., None] * o).sum(dim=0) / total[..., None]
    return out.to(dtype), mx + torch.log(total)


def _ptr(t: Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, *, sm_scale: float) -> Tuple[Tensor, Tensor]:
    """Launch the K3 kernel on (BH, S, D) bf16 -> (out (BH, Sq, D), lse (BH, Sq)
    fp32), split over `key_splits` key ranges and merged when that is > 1."""
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
    splits = key_splits(bh, seq_q, seq_k, d, torch.cuda.get_device_properties(q.device).multi_processor_count)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((bh, seq_q), dtype=torch.float32, device=q.device)
    parts = [None, None, None]
    if splits > 1:
        parts = [torch.empty((splits, bh, seq_q, d), dtype=torch.float32, device=q.device),
                 torch.empty((splits, bh, seq_q), dtype=torch.float32, device=q.device),
                 torch.empty((splits, bh, seq_q), dtype=torch.float32, device=q.device)]
    err = _build.launch(
        "ragb_flash_attention_fwd", q.device,
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse),
        *(ctypes.c_void_p(None if t is None else t.data_ptr()) for t in parts),
        bh, seq_q, seq_k, d, splits, float(sm_scale),
    )
    _build.check(err, name)
    LAUNCHES += 1
    return out, lse


# head dims below this take the fused FlashAttention-2 backward, as in the JAX package
FUSED_BWD_MAX_HEAD_DIM = 384


def backward_route(device_type: str, head_dim: int) -> str:
    """Which backward a call that needs a gradient gets: "kernels" (the dQ and
    dK/dV kernels, from the saved output and log-sum-exp), "plain" (the same
    arithmetic in PyTorch, on the CPU) or "recompute" (the q-chunked plain
    PyTorch recompute from q, k, v alone, for head dims of 384 and up)."""
    if head_dim >= FUSED_BWD_MAX_HEAD_DIM:
        return "recompute"
    return "kernels" if device_type == "cuda" else "plain"


def attention_bwd_plain(
    q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor, g: Tensor,
    *, sm_scale: float, chunk: int = 1024,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) by the FlashAttention-2 arithmetic of the dQ and dK/dV
    kernels, from the forward's output and log-sum-exp (counterpart of
    `flash_attention_bwd_3d`): P = exp(scale * Q K^T - lse), dP = dO V^T,
    dS = P * (dP - delta) * scale with delta = rowsum(dO * O); dQ = dS K,
    dV = P^T dO, dK = dS^T Q. P and dS are rounded to the input dtype before
    their products, dK and dV add up over the query chunks in fp32, and no
    (S, S) block is held at once."""
    g = g.to(q.dtype)
    delta = attention_delta(out, g)
    dk = torch.zeros_like(k, dtype=torch.float32)
    dv = torch.zeros_like(v, dtype=torch.float32)
    dqs = []
    for start in range(0, q.shape[1], chunk):
        rows = slice(start, start + chunk)
        q_blk, g_blk = q[:, rows], g[:, rows]
        logits = torch.matmul(q_blk, k.transpose(1, 2)).float() * sm_scale
        p = torch.exp(logits - lse[:, rows, None])
        dp = torch.matmul(g_blk, v.transpose(1, 2)).float()
        ds = (p * (dp - delta[:, rows, None]) * sm_scale).to(q.dtype)
        dqs.append(torch.matmul(ds, k))
        dv += torch.matmul(p.to(q.dtype).transpose(1, 2), g_blk)
        dk += torch.matmul(ds.transpose(1, 2), q_blk)
    return torch.cat(dqs, dim=1), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_operands(name: str, q: Tensor, k: Tensor, v: Tensor, g: Tensor, lse: Tensor, delta: Tensor):
    """Check what the backward kernels take: CUDA, bf16 (BH, S, 128) q, k, v
    and dO, fp32 (BH, Sq) lse and delta; returns them contiguous."""
    for key, t in (("q", q), ("k", k), ("v", v), ("g", g)):
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {key} must be bfloat16, got {t.dtype}")
        if t.ndim != 3:
            raise ValueError(f"{name}: {key} must be (BH, S, D), got {tuple(t.shape)}")
    bh, seq_q, d = q.shape
    seq_k = k.shape[1]
    if d != BWD_KERNEL_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} is not {BWD_KERNEL_HEAD_DIM}")
    if k.shape != (bh, seq_k, d) or v.shape != k.shape or g.shape != q.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"g {tuple(g.shape)}")
    for key, t in (("lse", lse), ("delta", delta)):
        if not t.is_cuda or t.dtype != torch.float32 or t.shape != (bh, seq_q):
            raise ValueError(f"{name}: {key} must be a CUDA float32 {(bh, seq_q)}, "
                             f"got {t.device} {t.dtype} {tuple(t.shape)}")
    if bh > 65535:
        raise ValueError(f"{name}: batch*heads {bh} exceeds 65535")
    return tuple(t.contiguous() for t in (q, k, v, g, lse, delta))


def flash_attention_dq_cuda(
    q: Tensor, k: Tensor, v: Tensor, g: Tensor, lse: Tensor, delta: Tensor, *, sm_scale: float
) -> Tensor:
    """Launch the K4 kernel: dQ (BH, Sq, 128) bf16 from q, k, v, dO, the
    forward's (BH, Sq) fp32 log-sum-exp and delta = rowsum(dO * O)."""
    global DQ_LAUNCHES
    name = "flash_attention_dq"
    q, k, v, g, lse, delta = _bwd_operands(name, q, k, v, g, lse, delta)
    dq = torch.empty_like(q)
    err = _build.launch(
        "ragb_flash_attention_dq", q.device,
        _ptr(q), _ptr(k), _ptr(v), _ptr(g), _ptr(lse), _ptr(delta), _ptr(dq),
        q.shape[0], q.shape[1], k.shape[1], q.shape[2], float(sm_scale))
    _build.check(err, name)
    DQ_LAUNCHES += 1
    return dq


def flash_attention_dkv_cuda(
    q: Tensor, k: Tensor, v: Tensor, g: Tensor, lse: Tensor, delta: Tensor, *, sm_scale: float
) -> Tuple[Tensor, Tensor]:
    """Launch the K5 kernel: (dK, dV) (BH, Sk, 128) bf16 from the same operands."""
    global DKV_LAUNCHES
    name = "flash_attention_dkv"
    q, k, v, g, lse, delta = _bwd_operands(name, q, k, v, g, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _build.launch(
        "ragb_flash_attention_dkv", q.device,
        _ptr(q), _ptr(k), _ptr(v), _ptr(g), _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv),
        q.shape[0], q.shape[1], k.shape[1], q.shape[2], float(sm_scale))
    _build.check(err, name)
    DKV_LAUNCHES += 1
    return dk, dv


def attention_delta(out: Tensor, g: Tensor) -> Tensor:
    """delta = rowsum(dO * O) in fp32, (BH, Sq): one elementwise pass outside
    the kernels, as in the JAX package."""
    return (g.float() * out.float()).sum(dim=-1)


def flash_attention_bwd_cuda(
    q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor, g: Tensor, *, sm_scale: float
) -> Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) on the card: delta, then one call that encodes the tensor
    maps once and launches K4 and K5 on the current stream (one launch count
    each)."""
    global DQ_LAUNCHES, DKV_LAUNCHES
    name = "flash_attention_bwd"
    if out.shape != q.shape:
        raise ValueError(f"{name}: out {tuple(out.shape)} != q {tuple(q.shape)}")
    delta = attention_delta(out, g)
    q, k, v, g, lse, delta = _bwd_operands(name, q, k, v, g, lse, delta)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = _build.launch(
        "ragb_flash_attention_bwd", q.device,
        _ptr(q), _ptr(k), _ptr(v), _ptr(g), _ptr(lse), _ptr(delta), _ptr(dq), _ptr(dk), _ptr(dv),
        q.shape[0], q.shape[1], k.shape[1], q.shape[2], float(sm_scale))
    _build.check(err, name)
    DQ_LAUNCHES += 1
    DKV_LAUNCHES += 1
    return dq, dk, dv


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
    """(BH, S, D) attention. Head dims below 384 save q, k, v, the output and
    the log-sum-exp for the fused backward; larger ones save q, k, v only (the
    recompute backward needs neither)."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        fused = q.shape[-1] < FUSED_BWD_MAX_HEAD_DIM
        if q.is_cuda:
            out, lse = flash_attention_cuda(q, k, v, sm_scale=sm_scale)
        else:
            out, lse = attention_lse_plain(q, k, v, sm_scale=sm_scale)
        if fused:
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            ctx.save_for_backward(q, k, v)
        ctx.fused = fused
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        if not ctx.fused:
            q, k, v = ctx.saved_tensors
            return attention_bwd_recompute(q, k, v, g, sm_scale=ctx.sm_scale) + (None,)
        q, k, v, out, lse = ctx.saved_tensors
        if q.is_cuda:
            grads = flash_attention_bwd_cuda(q, k, v, out, lse, g.to(q.dtype), sm_scale=ctx.sm_scale)
        else:
            grads = attention_bwd_plain(q, k, v, out, lse, g, sm_scale=ctx.sm_scale)
        return grads + (None,)


def attention(q: Tensor, k: Tensor, v: Tensor, *, sm_scale: Optional[float] = None,
              seq=None, segments: Optional[Tuple[int, ...]] = None) -> Tensor:
    """(B, H, S, D) attention: the flash kernel on CUDA, the plain version on
    CPU; differentiable as `backward_route` says (on CUDA a gradient at a head
    dim below 384 other than 128 raises in the backward wrapper).

    `seq` (a sequence axis, `parallel/mesh.py::Mesh`): q, k and v are this
    rank's tokens of a sequence-sharded stream; q stays local, k and v are
    all-gathered over the axis before the kernel (in the unsharded order of
    `segments`, the local lengths of the streams the tokens are made of) and
    their gradients reduce-scattered after the backward kernels
    (`parallel/sequence_parallel.py::gather_seq`; JAX `attention(mesh=,
    seq_axis=)`)."""
    b, h, s, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention: unsupported device {q.device}")
    if seq is not None and seq.size > 1:
        k, v = gather_seq(k, seq, 2, segments), gather_seq(v, seq, 2, segments)
    q3 = q.reshape(b * h, s, d)
    k3 = k.reshape(b * h, k.shape[2], d)
    v3 = v.reshape(b * h, v.shape[2], d)
    return _Attention.apply(q3, k3, v3, float(sm_scale)).reshape(b, h, s, d)
