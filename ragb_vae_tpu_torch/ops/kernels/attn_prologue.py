"""The attention prologue of the FLUX blocks, K13: from the q, k, v
projections to the (B, H, S, D) operands of the attention kernel.

`attn_prologue` splits each projection output (B, S, H * D) into heads,
RMS-normalises q and k per stream with their own weights, puts the text
tokens before the image tokens and rotates q and k by RoPE; v is only
placed. A CPU tensor takes `attn_prologue_plain`, the model's former chain
of PyTorch ops (RMSNorm with fp32 statistics rounded to the input dtype,
then RoPE in fp32 rounded once); a CUDA tensor launches `csrc/
attn_prologue.cu` or raises. It replaces no TPU kernel: the JAX package
leaves this chain to XLA's fusion. Bytes bound it (it reads each q, k, v
value once and writes it once); eager PyTorch spent about twenty passes
over the stream tensors on it, the kernel one.

The backward (`_AttnPrologue`) saves the bf16 projection outputs, not the
chain's fp32 intermediates: RoPE's transpose, then RMSNorm's backward in
fp32 from a recomputed rstd, written back in the streams' own layouts
(`attn_prologue_bwd_cuda` on the card, `attn_prologue_bwd_plain`, the same
arithmetic in PyTorch, on the CPU). The norm weights' gradients are summed
only when a weight asks for one.

Each kernel launch adds its rows (batch x tokens x heads) to the registry
counter `attn.prologue` (`utils/profiling.py`, `GET /metrics`).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ragb_vae_tpu_torch.ops.kernels import _build
from ragb_vae_tpu_torch.utils.profiling import Counter

Tensor = torch.Tensor

# the widest head the kernel takes (every even D up to it)
MAX_HEAD_DIM = 256
# rows (one token of one head) a 256-thread block of the kernel takes at a time
ROWS_PER_BLOCK = 16
# blocks a SM the grid-stride launch asks for
BLOCKS_PER_SM = 8

# launches of each kernel since the last reset (the plain versions never count)
LAUNCHES = 0
BWD_LAUNCHES = 0

ROWS = Counter("attn.prologue")


def reset_launch_counts() -> None:
    global LAUNCHES, BWD_LAUNCHES
    LAUNCHES = BWD_LAUNCHES = 0


def _compute_dtype(x: Tensor) -> torch.dtype:
    """fp32 for bf16, fp16 and fp32 tensors (the model's), float64 kept."""
    return torch.promote_types(x.dtype, torch.float32)


def rms_norm(x: Tensor, weight: Tensor, eps: float) -> Tensor:
    """RMSNorm over the last dim with fp32 statistics, rounded to x's dtype."""
    xf = x.to(_compute_dtype(x))
    normed = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (normed * weight.to(xf.dtype)).to(x.dtype)


def rotary(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """Rotate adjacent pairs: x*cos + rot(x)*sin, rot(x0, x1) = (-x1, x0), in fp32."""
    xf = x.to(_compute_dtype(x))
    pairs = xf.reshape(*x.shape[:-1], -1, 2)
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(xf.shape)
    return (xf * cos + rot * sin).to(x.dtype)


def split_heads(x: Tensor, heads: int) -> Tensor:
    """(B, S, H * D) -> the (B, H, S, D) view."""
    b, s, _ = x.shape
    return x.reshape(b, s, heads, -1).transpose(1, 2)


def merge_heads(x: Tensor) -> Tensor:
    """(B, H, S, D) -> (B, S, H * D)."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def attn_prologue_plain(q: Tensor, k: Tensor, v: Tensor, tq: Optional[Tensor], tk: Optional[Tensor],
                        tv: Optional[Tensor], w_q: Tensor, w_k: Tensor, w_tq: Optional[Tensor],
                        w_tk: Optional[Tensor], cos: Tensor, sin: Tensor, *, heads: int,
                        eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of the kernel: the model's former chain, op for op.
    q, k, v (B, S_img, H * D) and, unless None, the text stream's tq, tk, tv
    (B, S_txt, H * D) -> q, k, v (B, H, S_txt + S_img, D), text first."""
    q = rms_norm(split_heads(q, heads), w_q, eps)
    k = rms_norm(split_heads(k, heads), w_k, eps)
    v = split_heads(v, heads)
    if tq is not None:
        q = torch.cat([rms_norm(split_heads(tq, heads), w_tq, eps), q], dim=2)
        k = torch.cat([rms_norm(split_heads(tk, heads), w_tk, eps), k], dim=2)
        v = torch.cat([split_heads(tv, heads), v], dim=2)
    return rotary(q, cos, sin), rotary(k, cos, sin), v


def _stream_bwd_plain(g: Tensor, x: Tensor, w: Tensor, cos: Tensor, sin: Tensor, *, heads: int, eps: float,
                      need_w: bool) -> Tuple[Tensor, Optional[Tensor]]:
    """One stream's q or k: g (B, H, S, D) the gradient of its rotated rows,
    x (B, S, H * D) its projection output -> (dx like x, dw or None)."""
    ct = _compute_dtype(x)
    xf = split_heads(x, heads).to(ct)
    gf, c, s = g.to(ct), cos.to(ct), sin.to(ct)
    g0, g1 = gf[..., 0::2], gf[..., 1::2]
    gy = torch.stack([g0 * c[..., 0::2] + g1 * s[..., 1::2],
                      g1 * c[..., 1::2] - g0 * s[..., 0::2]], dim=-1).reshape(gf.shape)
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    gn = gy * w.to(ct)
    coef = rstd ** 3 * (gn * xf).sum(dim=-1, keepdim=True) / xf.shape[-1]
    dx = merge_heads(rstd * gn - coef * xf).to(x.dtype)
    dw = (gy * xf * rstd).sum(dim=(0, 1, 2)).to(w.dtype) if need_w else None
    return dx, dw


def attn_prologue_bwd_plain(gq: Tensor, gk: Tensor, gv: Tensor, q: Tensor, k: Tensor, tq: Optional[Tensor],
                            tk: Optional[Tensor], w_q: Tensor, w_k: Tensor, w_tq: Optional[Tensor],
                            w_tk: Optional[Tensor], cos: Tensor, sin: Tensor, *, heads: int, eps: float,
                            need_w: Sequence[bool] = (False,) * 4):
    """The backward kernel's arithmetic in PyTorch: from the gradients of the
    joint q, k, v (B, H, S, D) and the forward's inputs to (dq, dk, dv, dtq,
    dtk, dtv, dw_q, dw_k, dw_tq, dw_tk), each stream's in its own layout;
    RoPE's transpose and RMSNorm's backward in fp32 (float64 kept), a weight's
    gradient only where `need_w` asks (else None)."""
    s_txt = 0 if tq is None else tq.shape[1]
    kw = {"heads": heads, "eps": eps}
    dq, dw_q = _stream_bwd_plain(gq[:, :, s_txt:], q, w_q, cos[s_txt:], sin[s_txt:], need_w=need_w[0], **kw)
    dk, dw_k = _stream_bwd_plain(gk[:, :, s_txt:], k, w_k, cos[s_txt:], sin[s_txt:], need_w=need_w[1], **kw)
    dv = merge_heads(gv[:, :, s_txt:]).to(q.dtype)
    if tq is None:
        return dq, dk, dv, None, None, None, dw_q, dw_k, None, None
    dtq, dw_tq = _stream_bwd_plain(gq[:, :, :s_txt], tq, w_tq, cos[:s_txt], sin[:s_txt], need_w=need_w[2], **kw)
    dtk, dw_tk = _stream_bwd_plain(gk[:, :, :s_txt], tk, w_tk, cos[:s_txt], sin[:s_txt], need_w=need_w[3], **kw)
    dtv = merge_heads(gv[:, :, :s_txt]).to(tq.dtype)
    return dq, dk, dv, dtq, dtk, dtv, dw_q, dw_k, dw_tq, dw_tk


def _ptr(t: Optional[Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _operands(name: str, img, txt, weights, cos, sin, heads: int):
    """Check what the kernels take: img and txt (None when absent) a stream's
    projection outputs (q, k[, v]), weights (w_q, w_k, w_tq, w_tk). Returns
    (img, txt, weights, cos, sin) contiguous, (B, S_txt, S_img, H, D) and
    w_fp32."""
    if (txt is None) != (weights[2] is None) or (txt is None) != (weights[3] is None):
        raise ValueError(f"{name}: the text stream's q, k, v and weights come together or not at all")
    for stream in [img] + ([txt] if txt is not None else []):
        for t in stream:
            if t is None or not t.is_cuda or t.dtype != torch.bfloat16 or t.ndim != 3:
                raise ValueError(f"{name}: q, k, v must be CUDA bfloat16 (B, S, H * D), got "
                                 + ("None" if t is None else f"{t.device} {t.dtype} {tuple(t.shape)}"))
        if len({tuple(t.shape) for t in stream}) != 1:
            raise ValueError(f"{name}: a stream's q, k, v differ in shape: {[tuple(t.shape) for t in stream]}")
    bsz, s_img, width = img[0].shape
    s_txt = 0 if txt is None else txt[0].shape[1]
    if txt is not None and (txt[0].shape[0] != bsz or txt[0].shape[2] != width):
        raise ValueError(f"{name}: text {tuple(txt[0].shape)} does not match image {tuple(img[0].shape)}")
    if heads <= 0 or width % heads:
        raise ValueError(f"{name}: {heads} heads do not divide width {width}")
    d = width // heads
    if d % 2 or d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} must be even and at most {MAX_HEAD_DIM}")
    given = [w for w in weights if w is not None]
    if any(w.shape != (d,) or not w.is_cuda for w in given) or \
            len({w.dtype for w in given}) != 1 or given[0].dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: the norm weights must be CUDA ({d},) tensors of one dtype, bfloat16 or "
                         f"float32, got {[(tuple(w.shape), w.dtype, str(w.device)) for w in given]}")
    s = s_txt + s_img
    for key, t in (("cos", cos), ("sin", sin)):
        if not t.is_cuda or t.dtype != torch.float32 or tuple(t.shape) != (s, d):
            raise ValueError(f"{name}: {key} must be CUDA float32 {(s, d)}, got {t.device} {t.dtype} "
                             f"{tuple(t.shape)}")
    if bsz * s * heads >= 2 ** 31:
        raise ValueError(f"{name}: {bsz * s * heads} rows exceed the kernel's int32 row index")

    def contiguous(ts):
        return None if ts is None else [None if t is None else t.contiguous() for t in ts]

    return (contiguous(img), contiguous(txt), contiguous(weights), cos.contiguous(), sin.contiguous(),
            (bsz, s_txt, s_img, heads, d), int(given[0].dtype == torch.float32))


def _blocks(device, rows: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(-(-rows // ROWS_PER_BLOCK), sms * BLOCKS_PER_SM)


def attn_prologue_cuda(q, k, v, tq, tk, tv, w_q, w_k, w_tq, w_tk, cos, sin, *, heads: int,
                       eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch K13's forward (`ragb_attn_prologue_fwd`): the arguments of
    `attn_prologue_plain` -> contiguous bf16 q, k, v (B, H, S_txt + S_img, D)."""
    global LAUNCHES
    name = "attn_prologue"
    img, txt, weights, cos, sin, (bsz, s_txt, s_img, h, d), w_fp32 = _operands(
        name, (q, k, v), None if tq is None and tk is None and tv is None else (tq, tk, tv),
        (w_q, w_k, w_tq, w_tk), cos, sin, heads)
    rows = bsz * (s_txt + s_img) * h
    out = [torch.empty((bsz, h, s_txt + s_img, d), dtype=torch.bfloat16, device=q.device) for _ in range(3)]
    err = _build.launch(
        "ragb_attn_prologue_fwd", q.device,
        *(_ptr(t) for t in (*img, *(txt or (None,) * 3), *weights, cos, sin, *out)),
        bsz, s_txt, s_img, h, d, w_fp32, _blocks(q.device, rows), float(eps))
    _build.check(err, name)
    LAUNCHES += 1
    ROWS.add(rows)
    return tuple(out)


def attn_prologue_bwd_cuda(gq, gk, gv, q, k, tq, tk, w_q, w_k, w_tq, w_tk, cos, sin, *, heads: int, eps: float,
                           need_w: Sequence[bool] = (False,) * 4):
    """Launch K13's backward (`ragb_attn_prologue_bwd`): the arguments and
    results of `attn_prologue_bwd_plain`."""
    global BWD_LAUNCHES
    name = "attn_prologue_bwd"
    (q, k), txt, weights, cos, sin, (bsz, s_txt, s_img, h, d), w_fp32 = _operands(
        name, (q, k), None if tq is None and tk is None else (tq, tk), (w_q, w_k, w_tq, w_tk), cos, sin, heads)
    tq, tk = txt or (None, None)
    s = s_txt + s_img
    grads = []
    for key, t in (("gq", gq), ("gk", gk), ("gv", gv)):
        if not t.is_cuda or tuple(t.shape) != (bsz, h, s, d):
            raise ValueError(f"{name}: {key} must be CUDA {(bsz, h, s, d)}, got {t.device} {tuple(t.shape)}")
        grads.append(t.to(torch.bfloat16).contiguous())
    dimg = [torch.empty_like(q) for _ in range(3)]
    dtxt = [None] * 3 if tq is None else [torch.empty_like(tq) for _ in range(3)]
    rows = bsz * s * h
    blocks = _blocks(q.device, rows)
    need_dw = any(need_w)
    partial = torch.empty((blocks, 4, d), dtype=torch.float32, device=q.device) if need_dw else None
    err = _build.launch(
        "ragb_attn_prologue_bwd", q.device,
        *(_ptr(t) for t in (*grads, q, k, tq, tk, *weights, cos, sin, *dimg, *dtxt, partial)),
        bsz, s_txt, s_img, h, d, w_fp32, int(need_dw), blocks, float(eps))
    _build.check(err, name)
    BWD_LAUNCHES += 1
    dws = [None] * 4
    if need_dw:
        sums = partial.sum(dim=0)      # txt q, txt k, img q, img k
        for i, (w, row) in enumerate(zip(weights, (2, 3, 0, 1))):
            if need_w[i] and w is not None:
                dws[i] = sums[row].to(w.dtype)
    return (*dimg, *dtxt, *dws)


class _AttnPrologue(torch.autograd.Function):
    """`attn_prologue`'s autograd: saves the projection outputs of q and k,
    the weights and cos / sin (v's gradient needs nothing)."""

    @staticmethod
    def forward(ctx, q, k, v, tq, tk, tv, w_q, w_k, w_tq, w_tk, cos, sin, heads, eps):
        args = (q, k, v, tq, tk, tv, w_q, w_k, w_tq, w_tk, cos, sin)
        if q.is_cuda:
            out = attn_prologue_cuda(*args, heads=heads, eps=eps)
        else:
            out = tuple(t.contiguous() for t in attn_prologue_plain(*args, heads=heads, eps=eps))
        ctx.save_for_backward(q, k, tq, tk, w_q, w_k, w_tq, w_tk, cos, sin)
        ctx.heads, ctx.eps = heads, eps
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gq, gk, gv):
        q, k, tq, tk, w_q, w_k, w_tq, w_tk, cos, sin = ctx.saved_tensors
        kw = {"heads": ctx.heads, "eps": ctx.eps, "need_w": ctx.needs_input_grad[6:10]}
        if q.is_cuda:
            grads = attn_prologue_bwd_cuda(gq, gk, gv, q, k, tq, tk, w_q, w_k, w_tq, w_tk, cos, sin, **kw)
        else:
            grads = attn_prologue_bwd_plain(gq, gk, gv, q, k, tq, tk, w_q, w_k, w_tq, w_tk, cos, sin, **kw)
        return (*grads, None, None, None, None)


def attn_prologue(img: Sequence[Tensor], weights: Sequence[Tensor], rope: Tuple[Tensor, Tensor], *,
                  heads: int, eps: float, txt: Optional[Sequence[Tensor]] = None,
                  txt_weights: Optional[Sequence[Tensor]] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """The (B, H, S_txt + S_img, D) q, k, v of an attention call, text first.

    img: the image stream's (q, k, v) projection outputs (B, S_img, H * D);
    weights: its (q, k) RMSNorm weights (D,); txt / txt_weights: the text
    stream's, or None (a single-stream block, whose one stream is `img`);
    rope: (cos, sin) (S_txt + S_img, D) fp32. Differentiable in the
    projections and the weights."""
    if img[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"attn_prologue: unsupported device {img[0].device}")
    tq, tk, tv = txt if txt is not None else (None, None, None)
    w_tq, w_tk = txt_weights if txt_weights is not None else (None, None)
    cos, sin = rope
    return _AttnPrologue.apply(*img, tq, tk, tv, *weights, w_tq, w_tk, cos, sin, heads, float(eps))
