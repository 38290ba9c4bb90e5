"""Whole-resnet-block kernels: GN-apply + SiLU + conv3x3 with a fused
stats / skip epilogue, and the decoder's sub-pixel upsample conv.

Counterpart of `ragb_vae_tpu/ops/pallas/resnet_block.py` (forward only).
Tensors are NHWC. A ResnetBlock becomes two launches of
`gn_silu_conv3x3_stats` with only (B, C)-sized coefficient math between
them; each launch also returns the per-channel (sum, sum of squares) of its
own bf16 output, so the next GroupNorm needs no statistics pass.

Dispatch: a CPU tensor takes the plain PyTorch version beside each kernel
(`conv3x3_stats_plain`, `upsample_conv3x3_stats_plain`); a CUDA tensor
launches the hand-written kernel in `csrc/resnet_block.cu` or raises. There
is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ragb_vae_tpu_torch.ops.kernels import _build

Tensor = torch.Tensor

# launches of each kernel since the last reset (the plain versions never count)
CONV_LAUNCHES = 0
UPSAMPLE_LAUNCHES = 0


def reset_launch_counts() -> None:
    global CONV_LAUNCHES, UPSAMPLE_LAUNCHES
    CONV_LAUNCHES = 0
    UPSAMPLE_LAUNCHES = 0


# ---------------------------------------------------------------------------
# Coefficient glue (plain torch, as it is XLA glue in the JAX package)
# ---------------------------------------------------------------------------
def stats_to_coeffs(
    stats: Tensor, scale: Tensor, bias: Tensor, num_groups: int, hw: int, eps: float = 1e-6
) -> Tuple[Tensor, Tensor]:
    """Fold per-channel (sum, sumsq) (B, 2, C) into per-(B, C) GroupNorm
    coefficients a, b with gn(x) = x*a + b, in fp32."""
    bsz, _, c = stats.shape
    cg = c // num_groups
    g_sums = stats.float().reshape(bsz, 2, num_groups, cg).sum(dim=-1)  # (B, 2, G)
    count = hw * cg
    mean = g_sums[:, 0] / count
    meansq = g_sums[:, 1] / count
    rstd = torch.rsqrt(meansq - mean * mean + eps)
    rstd_c = rstd.repeat_interleave(cg, dim=1)
    mean_c = mean.repeat_interleave(cg, dim=1)
    a = scale.float()[None, :] * rstd_c
    b = bias.float()[None, :] - mean_c * a
    return a, b


def tensor_stats(x: Tensor) -> Tensor:
    """Per-channel (sum, sumsq) of NHWC x as (B, 2, C) fp32."""
    xf = x.float()
    return torch.stack([xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))], dim=1)


def _conv3x3_nhwc(t: Tensor, w_hwio: Tensor) -> Tensor:
    """SAME conv3x3, NHWC in and out, weights HWIO, in t's dtype."""
    y = F.conv2d(t.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# K1: GN-apply + act + conv3x3 + bias [+ skip | + 1x1(skip)] with stats
# ---------------------------------------------------------------------------
def conv3x3_stats_plain(
    x: Tensor,
    a: Tensor,
    b: Tensor,
    w: Tensor,
    bias: Tensor,
    skip: Optional[Tensor] = None,
    ws: Optional[Tensor] = None,
    wsb: Optional[Tensor] = None,
    activation: str = "silu",
) -> Tuple[Tensor, Tensor]:
    """Plain version of the K1 kernel (counterpart of `_xla_chain`)."""
    w = w.to(x.dtype)
    t = x.float() * a[:, None, None, :].float() + b[:, None, None, :].float()
    if activation == "silu":
        t = F.silu(t)
    t = t.to(x.dtype)
    y = _conv3x3_nhwc(t, w).float() + bias.float()
    if skip is not None and ws is not None:
        y = y + (skip @ ws.to(x.dtype)).float() + wsb.float()
    elif skip is not None:
        y = y + skip.float()
    y = y.to(x.dtype)
    return y, tensor_stats(y)


def _check_cuda(name: str, **tensors) -> None:
    for key, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _check_dtype(name: str, dtype: torch.dtype, **tensors) -> None:
    for key, t in tensors.items():
        if t is not None and t.dtype != dtype:
            raise ValueError(f"{name}: {key} must be {dtype}, got {t.dtype}")


def _ptr(t: Optional[Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


_TILE_SHAPE: Optional[Tuple[int, int]] = None


def _tile_shape() -> Tuple[int, int]:
    """The conv kernels' output tile (rows, cols), read from the library once."""
    global _TILE_SHAPE
    if _TILE_SHAPE is None:
        th, tw = ctypes.c_int(), ctypes.c_int()
        _build.library().ragb_conv_tile_shape(ctypes.byref(th), ctypes.byref(tw))
        _TILE_SHAPE = (th.value, tw.value)
    return _TILE_SHAPE


def conv3x3_stats_cuda(
    x: Tensor,
    a: Tensor,
    b: Tensor,
    w: Tensor,
    bias: Tensor,
    skip: Optional[Tensor] = None,
    ws: Optional[Tensor] = None,
    wsb: Optional[Tensor] = None,
    activation: str = "silu",
) -> Tuple[Tensor, Tensor]:
    """Launch the K1 kernel (`ragb_resnet_conv3x3_stats`)."""
    global CONV_LAUNCHES
    name = "resnet_conv3x3_stats"
    if activation not in ("silu", "identity"):
        raise ValueError(f"{name}: unknown activation {activation!r}")
    if x.ndim != 4 or w.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(f"{name}: x {tuple(x.shape)} and w {tuple(w.shape)} do not match")
    bsz, height, width, c_in = x.shape
    n_out = w.shape[3]
    x = x.contiguous()
    w = w.to(x.dtype).contiguous()
    a = a.float().contiguous()
    b = b.float().contiguous()
    bias = bias.float().contiguous()
    skip_mode, c_skip = 0, 0
    if skip is not None:
        skip = skip.contiguous()
        if ws is not None:
            skip_mode, c_skip = 2, skip.shape[3]
            ws = ws.to(x.dtype).contiguous()
            wsb = wsb.float().contiguous()
            if ws.shape != (c_skip, n_out) or skip.shape[:3] != x.shape[:3]:
                raise ValueError(f"{name}: projection shapes do not match")
        else:
            skip_mode = 1
            if skip.shape != (bsz, height, width, n_out):
                raise ValueError(f"{name}: skip {tuple(skip.shape)} must be {(bsz, height, width, n_out)}")
    _check_cuda(name, x=x, a=a, b=b, w=w, bias=bias, skip=skip, ws=ws, wsb=wsb)
    _check_dtype(name, torch.bfloat16, x=x, w=w, skip=skip, ws=ws)
    if a.shape != (bsz, c_in) or b.shape != (bsz, c_in) or bias.shape != (n_out,):
        raise ValueError(f"{name}: coefficient or bias shapes do not match")
    if c_in % 8 or n_out % 8 or c_skip % 8:
        raise ValueError(f"{name}: channel counts must be multiples of 8, got C={c_in} N={n_out} Cs={c_skip}")
    th, tw = _tile_shape()
    tiles = -(-height // th) * -(-width // tw)
    y = torch.empty((bsz, height, width, n_out), dtype=x.dtype, device=x.device)
    partial = torch.empty((bsz, tiles, 2, n_out), dtype=torch.float32, device=x.device)
    stats = torch.empty((bsz, 2, n_out), dtype=torch.float32, device=x.device)
    err = _build.library().ragb_resnet_conv3x3_stats(
        _ptr(x), _ptr(a), _ptr(b), _ptr(w), _ptr(bias), _ptr(skip), _ptr(ws), _ptr(wsb),
        _ptr(y), _ptr(partial), _ptr(stats),
        tiles, bsz, height, width, c_in, n_out, c_skip,
        1 if activation == "silu" else 0, skip_mode,
        ctypes.c_void_p(_build.stream_ptr(x.device)),
    )
    _build.check(err, name)
    CONV_LAUNCHES += 1
    return y, stats


def gn_silu_conv3x3_stats(
    x: Tensor,
    a: Tensor,
    b: Tensor,
    w: Tensor,
    bias: Tensor,
    skip: Optional[Tensor] = None,
    *,
    proj: Optional[Tuple[Tensor, Tensor]] = None,
    activation: str = "silu",
) -> Tuple[Tensor, Tensor]:
    """y = conv3x3(act(x*a + b)) + bias [+ skip or 1x1(skip)], and the
    per-channel (sum, sumsq) of y as (B, 2, N) fp32.

    x: (B, H, W, C); a, b: (B, C) fp32 folded GroupNorm coefficients;
    w: (3, 3, C, N) HWIO; `proj=(ws, wsb)` runs the 1x1 conv_shortcut on
    `skip` inside the kernel (ws: (C_skip, N)).
    """
    ws, wsb = proj if proj is not None else (None, None)
    if x.device.type == "cpu":
        return conv3x3_stats_plain(x, a, b, w, bias, skip, ws, wsb, activation)
    if x.is_cuda:
        return conv3x3_stats_cuda(x, a, b, w, bias, skip, ws, wsb, activation)
    raise ValueError(f"gn_silu_conv3x3_stats: unsupported device {x.device}")


# ---------------------------------------------------------------------------
# K2: nearest-2x upsample + conv3x3 + bias with stats (sub-pixel form)
# ---------------------------------------------------------------------------
def fold_subpixel_weights(w: Tensor) -> Tensor:
    """(3, 3, C, N) conv3x3 -> (2, 2, 2, 2C, N) sub-pixel kernels [a, b, u'].

    Output row parity a=0 folds rows (W0 | W1+W2), a=1 (W0+W1 | W2);
    column parity b likewise over (V0 | V1+V2) and (V0+V1 | V2). The two
    column taps flatten v-major into the 2C contraction.
    """
    c_in, n_out = w.shape[2], w.shape[3]
    r = [
        torch.stack([w[0], w[1] + w[2]], dim=0),      # a=0: rows r'-1, r'
        torch.stack([w[0] + w[1], w[2]], dim=0),      # a=1: rows r', r'+1
    ]
    out = []
    for a in range(2):
        per_b = []
        for b in range(2):
            if b == 0:
                k = torch.stack([r[a][:, 0], r[a][:, 1] + r[a][:, 2]], dim=1)
            else:
                k = torch.stack([r[a][:, 0] + r[a][:, 1], r[a][:, 2]], dim=1)
            per_b.append(k.reshape(2, 2 * c_in, n_out))
        out.append(torch.stack(per_b, dim=0))
    return torch.stack(out, dim=0)


def upsample_conv3x3_stats_plain(x: Tensor, w: Tensor, bias: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain version of the K2 kernel: literal nearest-2x + conv3x3
    (counterpart of `_xla_upsample_conv`)."""
    up = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    y = _conv3x3_nhwc(up, w.to(x.dtype)).float() + bias.float()
    y = y.to(x.dtype)
    return y, tensor_stats(y)


def upsample_conv3x3_stats_cuda(
    x: Tensor, w: Tensor, bias: Tensor, *, w_fold: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor]:
    """Launch the K2 kernel (`ragb_subpixel_upsample_conv3x3_stats`).
    `w_fold`: `w` already folded (`fold_subpixel_weights`) in x's dtype, as
    a module keeps it across calls; folded here when not given."""
    global UPSAMPLE_LAUNCHES
    name = "subpixel_upsample_conv3x3_stats"
    if x.ndim != 4 or w.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(f"{name}: x {tuple(x.shape)} and w {tuple(w.shape)} do not match")
    bsz, height, width, c_in = x.shape
    n_out = w.shape[3]
    x = x.contiguous()
    if w_fold is None:
        # fold in fp32, then round once: summing re-associated taps in bf16
        # would add rounding error to every folded weight
        w_fold = fold_subpixel_weights(w.float()).to(x.dtype).contiguous()
    bias = bias.float().contiguous()
    _check_cuda(name, x=x, w_fold=w_fold, bias=bias)
    _check_dtype(name, torch.bfloat16, x=x, w_fold=w_fold)
    if w_fold.shape != (2, 2, 2, 2 * c_in, n_out):
        raise ValueError(f"{name}: w_fold {tuple(w_fold.shape)} must be {(2, 2, 2, 2 * c_in, n_out)}")
    if bias.shape != (n_out,):
        raise ValueError(f"{name}: bias must be ({n_out},)")
    if c_in % 8 or n_out % 8:
        raise ValueError(f"{name}: channel counts must be multiples of 8, got C={c_in} N={n_out}")
    th, tw = _tile_shape()
    tiles = 4 * -(-height // th) * -(-width // tw)
    y = torch.empty((bsz, 2 * height, 2 * width, n_out), dtype=x.dtype, device=x.device)
    partial = torch.empty((bsz, tiles, 2, n_out), dtype=torch.float32, device=x.device)
    stats = torch.empty((bsz, 2, n_out), dtype=torch.float32, device=x.device)
    err = _build.library().ragb_subpixel_upsample_conv3x3_stats(
        _ptr(x), _ptr(w_fold), _ptr(bias), _ptr(y), _ptr(partial), _ptr(stats),
        tiles, bsz, height, width, c_in, n_out,
        ctypes.c_void_p(_build.stream_ptr(x.device)),
    )
    _build.check(err, name)
    UPSAMPLE_LAUNCHES += 1
    return y, stats


def fused_upsample_conv3x3_stats(
    x: Tensor, w: Tensor, bias: Tensor, *, w_fold: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor]:
    """Nearest-2x upsample + conv3x3 (w: (3, 3, C, N) HWIO) + bias, with the
    stats epilogue. On CUDA the kernel reads only the small tensor, through
    the folded weights (`w_fold`, made from `w` when not given)."""
    if x.device.type == "cpu":
        return upsample_conv3x3_stats_plain(x, w, bias)
    if x.is_cuda:
        return upsample_conv3x3_stats_cuda(x, w, bias, w_fold=w_fold)
    raise ValueError(f"fused_upsample_conv3x3_stats: unsupported device {x.device}")


# ---------------------------------------------------------------------------
# One diffusers ResnetBlock as two K1 launches
# ---------------------------------------------------------------------------
def fused_resnet_block(
    x: Tensor,
    params: dict,
    *,
    num_groups: int,
    stats: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """params: {"norm1": {scale, bias}, "conv1": {kernel (3,3,C,N), bias},
    "norm2": ..., "conv2": ..., optional "conv_shortcut": {kernel (C,N), bias}}.
    `stats`: optional (B, 2, C) statistics of x from the previous block's
    epilogue. Returns (out, stats(out))."""
    _, height, width, _ = x.shape
    hw = height * width
    if stats is None:
        stats = tensor_stats(x)
    a1, b1 = stats_to_coeffs(stats, params["norm1"]["scale"], params["norm1"]["bias"], num_groups, hw)
    y1, stats1 = gn_silu_conv3x3_stats(x, a1, b1, params["conv1"]["kernel"], params["conv1"]["bias"])
    a2, b2 = stats_to_coeffs(stats1, params["norm2"]["scale"], params["norm2"]["bias"], num_groups, hw)
    proj = None
    if "conv_shortcut" in params:
        proj = (params["conv_shortcut"]["kernel"], params["conv_shortcut"]["bias"])
    return gn_silu_conv3x3_stats(
        y1, a2, b2, params["conv2"]["kernel"], params["conv2"]["bias"], x, proj=proj
    )
