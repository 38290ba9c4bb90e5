"""Whole-resnet-block kernels: GN-apply + SiLU + conv3x3 with a fused
stats / skip epilogue, the decoder's sub-pixel upsample conv, the backward of
both, and the encoder's stride-2 downsample conv with the same stats epilogue.

Counterpart of `ragb_vae_tpu/ops/pallas/resnet_block.py`. Tensors are NHWC.
A ResnetBlock becomes two launches of `gn_silu_conv3x3_stats` with only
(B, C)-sized coefficient math between them; each launch also returns the
per-channel (sum, sum of squares) of its own bf16 output, so the next
GroupNorm needs no statistics pass. Both entry points are
`torch.autograd.Function`s on every device: their backwards return every
cotangent (the statistics' included) in one call.

Dispatch: a CPU tensor takes the plain PyTorch version beside each kernel
(`conv3x3_stats_plain`, `upsample_conv3x3_stats_plain` and their `_bwd_plain`
counterparts); a CUDA tensor launches the hand-written kernels in
`csrc/resnet_block.cu` (forward: K1 and K2 over the TMA + wgmma conv engine
of `csrc/conv_sm90.cuh`) and `csrc/resnet_block_bwd.cu` (backward: K6 and K7
over the engine and the TMA + wgmma weight gradient of `csrc/wgrad_sm90.cuh`)
or raises. There is no fallback from one to the other, and no route by size.
`gn_silu_conv3x3_stats` has two forward routes, as in the JAX package: the
direct conv (K1) and Winograd F(2x2, 3x3) (K8, `csrc/resnet_block_wino.cu`,
plain version `wino_conv3x3_stats_plain`), picked per call by `algo=` or by
the module default `CONV_ALGO`; Winograd takes only the shapes of the JAX
package's predicate (`wino_aligned`), everything else stays direct. Both
routes share K6 as their backward: the function is the same.
The downsample conv (`fused_downsample_conv3x3_stats`, entry point in
`csrc/conv_kernels.cu` over the TMA + wgmma engine of `csrc/conv_sm90.cuh`)
has a forward kernel only: its backward differentiates its plain version, as
the JAX package differentiates its XLA reference.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ragb_vae_tpu_torch.device import constant
from ragb_vae_tpu_torch.ops.kernels import _build

Tensor = torch.Tensor

# launches of each kernel since the last reset (the plain versions never count)
CONV_LAUNCHES = 0
UPSAMPLE_LAUNCHES = 0
CONV_BWD_LAUNCHES = 0
UPSAMPLE_BWD_LAUNCHES = 0
DOWNSAMPLE_LAUNCHES = 0
WINO_LAUNCHES = 0
# K6's dskip launched on its own (`skip_grad_cuda`, for measuring it); inside
# K6 it counts as K6's launch
SKIP_GRAD_LAUNCHES = 0

# The forward route of `gn_silu_conv3x3_stats` when a call names none:
# "direct" (K1) or "winograd" (K8, on the shapes `wino_aligned` accepts).
CONV_ALGO = "direct"

# The weight gradient is a split-K GEMM: the image rows are cut into at most
# this many slices, each with an fp32 partial that a second pass adds in order.
MAX_WGRAD_SLICES = 64
# The weight-gradient kernel (csrc/wgrad_sm90.cuh): a block owns 128 input x
# 128 output channels of one group (K6: a tap row, three column taps; one tap
# for the projection; K7: a (pa, pb, u) of the folded weights, two column
# taps) and steps over 64 pixels at a time.
_WGRAD_SM90_TILE = (128, 128, 64)
_H100_SMS = 132
_PEAK_FLOPS, _PEAK_BYTES = 989e12, 3.35e12


def reset_launch_counts() -> None:
    global CONV_LAUNCHES, UPSAMPLE_LAUNCHES, CONV_BWD_LAUNCHES, UPSAMPLE_BWD_LAUNCHES
    global DOWNSAMPLE_LAUNCHES, WINO_LAUNCHES, SKIP_GRAD_LAUNCHES
    CONV_LAUNCHES = 0
    UPSAMPLE_LAUNCHES = 0
    CONV_BWD_LAUNCHES = 0
    UPSAMPLE_BWD_LAUNCHES = 0
    DOWNSAMPLE_LAUNCHES = 0
    WINO_LAUNCHES = 0
    SKIP_GRAD_LAUNCHES = 0


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


_TILE_SHAPES: dict = {}


def _tile_shape(export: str) -> Tuple[int, int]:
    """A conv kernel's output tile (rows, cols), read once from the library's
    `export`: `ragb_wino_tile_shape` (K8) or `ragb_conv_sm90_tile_shape` (the
    conv engine's: K1, K2, K6, K9)."""
    if export not in _TILE_SHAPES:
        th, tw = ctypes.c_int(), ctypes.c_int()
        _build.query(export, ctypes.byref(th), ctypes.byref(tw))
        _TILE_SHAPES[export] = (th.value, tw.value)
    return _TILE_SHAPES[export]


def _conv_operands(name, x, a, b, w, bias, skip, ws, wsb, activation):
    """Check and lay out the operands of a K1 / K8 launch -> (x, a, b, w,
    bias, skip, ws, wsb, skip_mode, c_skip)."""
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
    return x, a, b, w, bias, skip, ws, wsb, skip_mode, c_skip


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
    """Launch the K1 kernel (`ragb_resnet_conv3x3_stats`, the conv engine's
    activation mode): one statistics partial row per engine tile of an
    image."""
    global CONV_LAUNCHES
    name = "resnet_conv3x3_stats"
    x, a, b, w, bias, skip, ws, wsb, skip_mode, c_skip = _conv_operands(
        name, x, a, b, w, bias, skip, ws, wsb, activation)
    bsz, height, width, c_in = x.shape
    n_out = w.shape[3]
    th, tw = _tile_shape("ragb_conv_sm90_tile_shape")
    tiles = -(-height // th) * -(-width // tw)
    y = torch.empty((bsz, height, width, n_out), dtype=x.dtype, device=x.device)
    partial = torch.empty((bsz, tiles, 2, n_out), dtype=torch.float32, device=x.device)
    stats = torch.empty((bsz, 2, n_out), dtype=torch.float32, device=x.device)
    err = _build.launch(
        "ragb_resnet_conv3x3_stats", x.device,
        _ptr(x), _ptr(a), _ptr(b), _ptr(w), _ptr(bias), _ptr(skip), _ptr(ws), _ptr(wsb),
        _ptr(y), _ptr(partial), _ptr(stats),
        tiles, bsz, height, width, c_in, n_out, c_skip,
        1 if activation == "silu" else 0, skip_mode,
    )
    _build.check(err, name)
    CONV_LAUNCHES += 1
    return y, stats


# ---------------------------------------------------------------------------
# K8: K1's function by Winograd F(2x2, 3x3)
# ---------------------------------------------------------------------------
# G of F(2x2, 3x3): U = G w G^T maps a 3x3 filter to its 4x4 transform
_WINO_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))


def wino_tiles(w: Tensor, dtype: Optional[torch.dtype] = None) -> Tensor:
    """(3, 3, C, N) -> U = G w G^T as (4, 4, C, N) [mu, nu], the 16 tiles K8
    reads: folded in fp32 (G's halves are exact there; a fold in bf16 would
    add its own rounding), then cast once to `dtype` (default: w's)."""
    g = constant(_WINO_G, torch.float32, w.device)   # kept per device: no host copy per call
    u = torch.einsum("xu,yv,uvcn->xycn", g, g, w.float())
    return u.to(dtype or w.dtype).contiguous()


def wino_weights(w: Tensor, dtype: Optional[torch.dtype] = None) -> Tensor:
    """(3, 3, C, N) -> the JAX package's `_wino_weights` (2, 4, 3C, N): U's
    tiles with the output-row transform A^T folded into the contraction,
    Uf[0, nu] = [U0; U1; U2][nu] and Uf[1, nu] = [U1; -U2; -U3][nu], folded
    in fp32, then cast once to `dtype` (default: w's). K8 reads the 16
    unsigned tiles (`wino_tiles`) and takes the signs in its products."""
    u = wino_tiles(w, torch.float32)
    folded = torch.stack([torch.cat([u[0], u[1], u[2]], dim=1), torch.cat([u[1], -u[2], -u[3]], dim=1)])
    return folded.to(dtype or w.dtype)


class WinoPlan(NamedTuple):
    """K8's launch geometry: its tiles of one image (one statistics partial
    row each), the grid (64-channel N tiles, tiles, images) and the
    partials' shape."""
    tiles: int
    grid: Tuple[int, int, int]
    partial: Tuple[int, ...]


_WINO_BN = 64                    # K8's output channels of a block


def wino_plan(bsz: int, height: int, width: int, n_out: int, tile: Tuple[int, int]) -> WinoPlan:
    """K8's plan for a (bsz, height, width) image batch -> n_out channels,
    `tile` the kernel's output tile (rows, cols)."""
    th, tw = tile
    tiles = -(-height // th) * -(-width // tw)
    return WinoPlan(tiles, (-(-n_out // _WINO_BN), tiles, bsz), (bsz, tiles, 2, n_out))


def wino_aligned(height: int, width: int, c_in: int, n_out: int, c_skip: Optional[int] = None) -> bool:
    """The JAX package's Winograd predicate: H even, W % 16, C, N and C_skip
    multiples of 128. Other shapes take the direct route."""
    return (height % 2 == 0 and width % 16 == 0 and c_in % 128 == 0 and n_out % 128 == 0
            and (c_skip is None or c_skip % 128 == 0))


def wino_conv3x3_stats_plain(
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
    """Plain version of the K8 kernel, step by step: the activation rounded to
    x's dtype and zero-padded; per 2x2 output tile the 4x4 patch's input
    transform B^T d B in fp32, columns first, rounded to x's dtype (V); per
    output row p and column variant nu one fp32 product of depth 3C, the
    V[p:p + 3][nu] of a tile side by side against the JAX package's folded
    weights Uf[p, nu] (`wino_weights(w)` in x's dtype): Z[p][nu]; the
    projection (fp32) into Z, as the kernel accumulates it; the column
    transform (Z0 + Z1 + Z2, Z1 - Z2 - Z3) in fp32; bias (+ the projection's),
    or the skip; one rounding of y. Those are the JAX kernel's rounding
    points."""
    bsz, height, width, c_in = x.shape
    n_out = w.shape[3]
    if height % 2 or width % 2:
        raise ValueError(f"wino_conv3x3_stats: H and W must be even, got {height} x {width}")
    uf = wino_weights(w, x.dtype).float()                  # (2, 4, 3C, N)
    t = x.float() * a[:, None, None, :].float() + b[:, None, None, :].float()
    if activation == "silu":
        t = F.silu(t)
    t = F.pad(t.to(x.dtype).float(), (0, 0, 1, 1, 1, 1))
    d = t.unfold(1, 4, 2).unfold(2, 4, 2)                 # (B, H/2, W/2, C, row, col)
    d0, d1, d2, d3 = d.unbind(-1)                          # columns
    cv = torch.stack([d0 - d2, d1 + d2, d2 - d1, d1 - d3], dim=-1)      # (..., row, nu)
    r0, r1, r2, r3 = cv.unbind(-2)                         # rows
    v = torch.stack([r0 - r2, r1 + r2, r2 - r1, r1 - r3], dim=-2)       # (..., mu, nu)
    v = v.to(x.dtype).float().permute(4, 5, 0, 1, 2, 3).reshape(4, 4, -1, c_in)   # [mu, nu]: (tiles, C)
    z = [[(torch.cat([v[p + i, nu] for i in range(3)], dim=1) @ uf[p, nu]).reshape(
        bsz, height // 2, width // 2, n_out) for nu in range(4)] for p in range(2)]
    bias = bias.float()
    if skip is not None and ws is not None:
        # the projection of pixel (2i + p, 2j + q) joins Z[p][0] (q = 0), which
        # only y[p][0] reads, or leaves Z[p][3] (q = 1), which y[p][1] reads
        # negated; its bias joins y's
        proj = skip.float() @ ws.to(x.dtype).float()
        for p in range(2):
            z[p][0] = z[p][0] + proj[:, p::2, 0::2]
            z[p][3] = z[p][3] - proj[:, p::2, 1::2]
        bias = bias + wsb.float()
    y = torch.stack([torch.stack([zp[0] + zp[1] + zp[2], zp[1] - zp[2] - zp[3]], dim=3) for zp in z],
                    dim=2).reshape(bsz, height, width, n_out)
    y = y + bias
    if skip is not None and ws is None:
        y = y + skip.float()
    y = y.to(x.dtype)
    return y, tensor_stats(y)


def wino_conv3x3_stats_cuda(
    x: Tensor,
    a: Tensor,
    b: Tensor,
    w: Tensor,
    bias: Tensor,
    skip: Optional[Tensor] = None,
    ws: Optional[Tensor] = None,
    wsb: Optional[Tensor] = None,
    activation: str = "silu",
    u: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Launch the K8 kernels (`ragb_resnet_conv3x3_stats_wino`: the
    activation pass into a scratch of x's size, the Winograd conv, the
    statistics' reduce) over U's 16 tiles in x's dtype: `u` as given (a
    module keeps them per weight, `ResnetBlock`), else `wino_tiles(w,
    x.dtype)` folded in this call. The kernel needs H and W even; C, N and
    C_skip multiples of 8."""
    global WINO_LAUNCHES
    name = "resnet_conv3x3_stats_wino"
    if u is None:
        u = wino_tiles(w, x.dtype)
    x, a, b, w, bias, skip, ws, wsb, skip_mode, c_skip = _conv_operands(
        name, x, a, b, w, bias, skip, ws, wsb, activation)
    bsz, height, width, c_in = x.shape
    n_out = w.shape[3]
    if height % 2 or width % 2:
        raise ValueError(f"{name}: H and W must be even, got {height} x {width}")
    _check_cuda(name, u=u)
    if u.shape != (4, 4, c_in, n_out) or u.dtype != x.dtype:
        raise ValueError(f"{name}: u must be {(4, 4, c_in, n_out)} {x.dtype}, got {tuple(u.shape)} {u.dtype}")
    plan = wino_plan(bsz, height, width, n_out, _tile_shape("ragb_wino_tile_shape"))
    xa = torch.empty_like(x)        # the activated input, the kernel's scratch for this call
    y = torch.empty((bsz, height, width, n_out), dtype=x.dtype, device=x.device)
    partial = torch.empty(plan.partial, dtype=torch.float32, device=x.device)
    stats = torch.empty((bsz, 2, n_out), dtype=torch.float32, device=x.device)
    err = _build.launch(
        "ragb_resnet_conv3x3_stats_wino", x.device,
        _ptr(x), _ptr(a), _ptr(b), _ptr(u), _ptr(bias), _ptr(skip), _ptr(ws), _ptr(wsb),
        _ptr(xa), _ptr(y), _ptr(partial), _ptr(stats),
        plan.tiles, bsz, height, width, c_in, n_out, c_skip,
        1 if activation == "silu" else 0, skip_mode,
    )
    _build.check(err, name)
    WINO_LAUNCHES += 1
    return y, stats


def conv_route(x: Tensor, w: Tensor, skip: Optional[Tensor], ws: Optional[Tensor],
               algo: Optional[str] = None) -> str:
    """"winograd" when `algo` (else `CONV_ALGO`) asks for it and the shape is
    aligned, else "direct"."""
    chosen = algo or CONV_ALGO
    if chosen not in ("direct", "winograd"):
        raise ValueError(f"unknown conv algo {chosen!r}: 'direct' or 'winograd'")
    _, height, width, c_in = x.shape
    c_skip = skip.shape[3] if ws is not None else None
    if chosen == "winograd" and wino_aligned(height, width, c_in, w.shape[3], c_skip):
        return "winograd"
    return "direct"


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
    algo: Optional[str] = None,
    u: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """y = conv3x3(act(x*a + b)) + bias [+ skip or 1x1(skip)], and the
    per-channel (sum, sumsq) of y as (B, 2, N) fp32.

    x: (B, H, W, C); a, b: (B, C) fp32 folded GroupNorm coefficients;
    w: (3, 3, C, N) HWIO; `proj=(ws, wsb)` runs the 1x1 conv_shortcut on
    `skip` inside the kernel (ws: (C_skip, N)). `algo` ("direct" or
    "winograd"; default `CONV_ALGO`) picks the forward route (`conv_route`).
    `u`: w's Winograd tiles `wino_tiles(w, x.dtype)` for the Winograd route
    on CUDA, kept by the caller; folded in the call when not given.
    """
    ws, wsb = proj if proj is not None else (None, None)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gn_silu_conv3x3_stats: unsupported device {x.device}")
    route = conv_route(x, w, skip, ws, algo)
    u = u if route == "winograd" and x.is_cuda else None
    return _ConvStats.apply(x, a, b, w, bias, skip, ws, wsb, activation, route, u)


def fused_conv3x3_stats(x: Tensor, kernel: Tensor, bias: Tensor) -> Tuple[Tensor, Tensor]:
    """Bare conv3x3 + bias and the statistics of y: `gn_silu_conv3x3_stats`
    with the identity activation and unit coefficients (JAX
    `fused_conv3x3_stats`; unwired in both packages)."""
    ones = torch.ones(x.shape[0], x.shape[-1], dtype=torch.float32, device=x.device)
    return gn_silu_conv3x3_stats(x, ones, torch.zeros_like(ones), kernel, bias, activation="identity")


# ---------------------------------------------------------------------------
# K6: every cotangent of K1
# ---------------------------------------------------------------------------
def conv3x3_stats_bwd_plain(
    x: Tensor,
    a: Tensor,
    b: Tensor,
    w: Tensor,
    bias: Tensor,
    skip: Optional[Tensor],
    ws: Optional[Tensor],
    wsb: Optional[Tensor],
    y: Tensor,
    gy: Tensor,
    gstats: Tensor,
    activation: str = "silu",
) -> Tuple[Optional[Tensor], ...]:
    """Plain version of the K6 kernel: autograd through `conv3x3_stats_plain`
    (counterpart of the `restate + jax.vjp` route). Returns (dx, da, db, dw,
    dbias, dskip, dws, dwsb), each in its operand's dtype, None for an absent
    operand. `y` is recomputed, not read."""
    operands = [x, a, b, w, bias, skip, ws, wsb]
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(True) for t in operands]
        y2, stats2 = conv3x3_stats_plain(*leaves, activation)
        present = [t for t in leaves if t is not None]
        grads = iter(torch.autograd.grad(
            [y2, stats2], present, [gy.to(y2.dtype), gstats.to(stats2.dtype)]))
    return tuple(None if t is None else next(grads) for t in leaves)


def _wgrad_sm90_slices(rows: int, width: int, c_in: int, n_out: int, taps: int, sms: int = _H100_SMS,
                       groups: Optional[int] = None) -> int:
    """Row slices of the split-K weight gradient over `rows` image rows of
    `width` pixels, with `taps` column taps a block and `groups` blocks a (C,
    N) tile (default `taps`: K6's 3 tap rows, or the projection's 1; K7: 2
    taps, 8 groups): the count, at most MAX_WGRAD_SLICES, that minimises a
    model of its time, the waves of one-block-an-SM blocks times each
    block's k-steps at the tensor-core peak plus the fp32 partials' write
    and read at the memory rate. The fewest slices win a tie, and no slice
    is left without a row."""
    groups = taps if groups is None else groups
    bm, bn, bk = _WGRAD_SM90_TILE
    tiles = -(-c_in // bm) * -(-n_out // bn) * groups
    step_s = 2.0 * bm * bn * bk * taps / (_PEAK_FLOPS / sms)
    partial_s = 2.0 * groups * taps * c_in * n_out * 4 / _PEAK_BYTES
    steps_per_row = -(-width // bk)

    def cost(s: int) -> float:
        return -(-tiles * s // sms) * -(-rows // s) * steps_per_row * step_s + s * partial_s

    best = min(range(1, min(MAX_WGRAD_SLICES, rows) + 1), key=lambda s: (cost(s), s))
    return -(-rows // -(-rows // best))


def _dye_slices(pixels: int, n_out: int) -> int:
    """Pixel slices of the dye pass (`launch_dye`) over `pixels` of an image:
    16 passes of the block's threads a slice (n_out / 8 threads a pixel,
    256 / (n_out / 8) pixels at a time). 64 slices took 0.31 ms at
    (4,512,512,128), 1024 take 0.27 (bound 0.24)."""
    pix_per_pass = 1 if n_out // 8 >= 256 else 256 // (n_out // 8)
    return max(1, -(-pixels // (16 * pix_per_pass)))


class K6Plan(NamedTuple):
    """K6's launch geometry: T, the conv engine's tiles of one image (one
    (da, db) partial row each), the slice counts of dye, dW and dws, and the
    partials' shapes (dws_partial None without a projection)."""
    tiles: int
    s_dye: int
    s_w: int
    s_ws: int
    dbias_partial: Tuple[int, ...]
    dab_partial: Tuple[int, ...]
    dw_partial: Tuple[int, ...]
    dws_partial: Optional[Tuple[int, ...]]


@functools.lru_cache(maxsize=None)
def conv3x3_stats_bwd_plan(bsz: int, height: int, width: int, c_in: int, n_out: int, c_skip: int,
                           tile: Tuple[int, int], sms: int = _H100_SMS) -> K6Plan:
    """K6's plan for x (bsz, height, width, c_in) -> n_out channels (c_skip:
    the projection's input channels, 0 without one), `tile` the conv
    engine's output tile (rows, cols), on a card of `sms` SMs. Cached: a
    training step asks for the same few shapes every step."""
    th, tw = tile
    tiles = -(-height // th) * -(-width // tw)
    s_dye = _dye_slices(height * width, n_out)
    s_w = _wgrad_sm90_slices(bsz * height, width, c_in, n_out, 3, sms)
    s_ws = _wgrad_sm90_slices(bsz * height, width, c_skip, n_out, 1, sms) if c_skip else 0
    return K6Plan(tiles, s_dye, s_w, s_ws, (bsz * s_dye, n_out), (bsz, tiles, 2, c_in), (s_w, 3, 3, c_in, n_out),
                  (s_ws, c_skip, n_out) if c_skip else None)


def conv3x3_stats_bwd_cuda(
    x: Tensor,
    a: Tensor,
    b: Tensor,
    w: Tensor,
    bias: Tensor,
    skip: Optional[Tensor],
    ws: Optional[Tensor],
    wsb: Optional[Tensor],
    y: Tensor,
    gy: Tensor,
    gstats: Tensor,
    activation: str = "silu",
) -> Tuple[Optional[Tensor], ...]:
    """Launch the K6 kernels (`ragb_resnet_conv3x3_stats_bwd`): (dx, da, db,
    dw, dbias, dskip, dws, dwsb); dx and dskip bf16, the rest fp32 (the
    accumulators as they are), None for an absent operand."""
    global CONV_BWD_LAUNCHES
    name = "resnet_conv3x3_stats_bwd"
    if activation not in ("silu", "identity"):
        raise ValueError(f"{name}: unknown activation {activation!r}")
    if x.ndim != 4 or w.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(f"{name}: x {tuple(x.shape)} and w {tuple(w.shape)} do not match")
    bsz, height, width, c_in = x.shape
    n_out = w.shape[3]
    dev = x.device
    x = x.contiguous()
    y = y.contiguous()
    gy = gy.to(x.dtype).contiguous()
    gstats = gstats.float().contiguous()
    a = a.float().contiguous()
    b = b.float().contiguous()
    # the data gradient is a conv3x3 of dye with the taps flipped and (C, N) transposed
    wt = w.to(x.dtype).flip(0, 1).permute(0, 1, 3, 2).contiguous()
    skip_mode, c_skip = 0, 0
    if skip is not None:
        skip = skip.contiguous()
        if ws is not None:
            skip_mode, c_skip = 2, skip.shape[3]
            ws = ws.to(x.dtype).contiguous()      # dskip reads it as it lies: (Cs, N) is ws^T's K-major B
            if ws.shape != (c_skip, n_out) or skip.shape[:3] != x.shape[:3]:
                raise ValueError(f"{name}: projection shapes do not match")
        else:
            skip_mode = 1
            if skip.shape != (bsz, height, width, n_out):
                raise ValueError(f"{name}: skip {tuple(skip.shape)} must be {(bsz, height, width, n_out)}")
    else:
        ws = None
    _check_cuda(name, x=x, a=a, b=b, wt=wt, skip=skip, ws=ws, y=y, gy=gy, gstats=gstats)
    _check_dtype(name, torch.bfloat16, x=x, wt=wt, skip=skip, ws=ws, y=y, gy=gy)
    out_shape = (bsz, height, width, n_out)
    if y.shape != out_shape or gy.shape != out_shape or gstats.shape != (bsz, 2, n_out):
        raise ValueError(f"{name}: y, gy must be {out_shape} and gstats {(bsz, 2, n_out)}")
    if a.shape != (bsz, c_in) or b.shape != (bsz, c_in):
        raise ValueError(f"{name}: coefficient shapes do not match")
    if c_in % 8 or n_out % 8 or c_skip % 8:
        raise ValueError(f"{name}: channel counts must be multiples of 8, got C={c_in} N={n_out} Cs={c_skip}")
    plan = conv3x3_stats_bwd_plan(bsz, height, width, c_in, n_out, c_skip,
                                  _tile_shape("ragb_conv_sm90_tile_shape"),
                                  torch.cuda.get_device_properties(dev).multi_processor_count)
    f32 = {"dtype": torch.float32, "device": dev}
    dye = torch.empty(out_shape, dtype=x.dtype, device=dev)   # dskip itself under an identity skip
    act = torch.empty_like(x)       # A = act(x*a + b) in bf16: the data gradient writes it, dW reads it
    dx = torch.empty_like(x)
    dab = torch.empty((bsz, 2, c_in), **f32)
    dw = torch.empty((3, 3, c_in, n_out), **f32)
    dbias = torch.empty((n_out,), **f32)
    dskip = dws = dws_partial = None
    if skip_mode == 1:
        dskip = dye
    elif skip_mode == 2:
        dskip = torch.empty_like(skip)
        dws = torch.empty((c_skip, n_out), **f32)
        dws_partial = torch.empty(plan.dws_partial, **f32)
    dbias_partial = torch.empty(plan.dbias_partial, **f32)
    dab_partial = torch.empty(plan.dab_partial, **f32)
    dw_partial = torch.empty(plan.dw_partial, **f32)
    err = _build.launch(
        "ragb_resnet_conv3x3_stats_bwd", dev,
        _ptr(x), _ptr(a), _ptr(b), _ptr(wt), _ptr(skip), _ptr(ws), _ptr(y), _ptr(gy), _ptr(gstats),
        _ptr(dye), _ptr(act), _ptr(dx), _ptr(dab), _ptr(dw), _ptr(dbias), _ptr(dskip), _ptr(dws),
        _ptr(dbias_partial), _ptr(dab_partial), _ptr(dw_partial), _ptr(dws_partial),
        plan.tiles, plan.s_dye, plan.s_w, plan.s_ws, bsz, height, width, c_in, n_out, c_skip,
        1 if activation == "silu" else 0, skip_mode,
    )
    _build.check(err, name)
    CONV_BWD_LAUNCHES += 1
    # the projection's bias cotangent is the same sum of dye as dbias
    dwsb = dbias.clone() if skip_mode == 2 else None
    return dx, dab[:, 0], dab[:, 1], dw, dbias, dskip, dws, dwsb


def skip_grad_plain(dye: Tensor, ws: Tensor) -> Tensor:
    """Plain version of K6's dskip: dye (B, H, W, N) @ ws (Cs, N)^T in fp32,
    rounded once to dye's dtype, as the kernel rounds it."""
    return (dye.float() @ ws.float().t()).to(dye.dtype)


def skip_grad_cuda(dye: Tensor, ws: Tensor) -> Tensor:
    """K6's dskip alone (`ragb_resnet_skip_grad`, the conv engine's one-tap
    mode): dye (B, H, W, N) @ ws (Cs, N)^T -> (B, H, W, Cs) bf16. K6 launches
    the same kernel inside its own entry; this one is for measuring it."""
    global SKIP_GRAD_LAUNCHES
    name = "resnet_skip_grad"
    if dye.ndim != 4 or ws.ndim != 2 or ws.shape[1] != dye.shape[3]:
        raise ValueError(f"{name}: dye {tuple(dye.shape)} and ws {tuple(ws.shape)} do not match")
    dye, ws = dye.contiguous(), ws.to(dye.dtype).contiguous()
    _check_cuda(name, dye=dye, ws=ws)
    _check_dtype(name, torch.bfloat16, dye=dye, ws=ws)
    bsz, height, width, n_out = dye.shape
    c_skip = ws.shape[0]
    if n_out % 8 or c_skip % 8:
        raise ValueError(f"{name}: channel counts must be multiples of 8, got N={n_out} Cs={c_skip}")
    dskip = torch.empty((bsz, height, width, c_skip), dtype=dye.dtype, device=dye.device)
    err = _build.launch(
        "ragb_resnet_skip_grad", dye.device,
        _ptr(dye), _ptr(ws), _ptr(dskip), bsz, height, width, n_out, c_skip)
    _build.check(err, name)
    SKIP_GRAD_LAUNCHES += 1
    return dskip


def _to_dtypes(grads, dtypes):
    """Each cotangent in its operand's dtype; None where there is no operand."""
    return tuple(None if g is None or d is None else g.to(d) for g, d in zip(grads, dtypes))


class _ConvStats(torch.autograd.Function):
    """K1 or K8 forward (by `route`) with K6 as its backward. Saves the
    operands (on CUDA the weights in the compute dtype the kernel read them
    in) and its own output y, nothing else: the backward recomputes the
    activation from x. Weight cotangents return in the dtype the weights came
    in, so an fp32 parameter receives the fp32 accumulator unrounded."""

    @staticmethod
    def forward(ctx, x, a, b, w, bias, skip, ws, wsb, activation, route, u):
        ctx.dtypes = tuple(None if t is None else t.dtype for t in (x, a, b, w, bias, skip, ws, wsb))
        if x.is_cuda:
            w = w.to(x.dtype)
            ws = None if ws is None else ws.to(x.dtype)
            fwd = functools.partial(wino_conv3x3_stats_cuda, u=u) if route == "winograd" else conv3x3_stats_cuda
        else:
            fwd = wino_conv3x3_stats_plain if route == "winograd" else conv3x3_stats_plain
        y, stats = fwd(x, a, b, w, bias, skip, ws, wsb, activation)
        ctx.save_for_backward(x, a, b, w, bias, skip, ws, wsb, y)
        ctx.activation = activation
        ctx.set_materialize_grads(False)
        return y, stats

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy, gstats):
        x, a, b, w, bias, skip, ws, wsb, y = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(y)
        if gstats is None:
            gstats = torch.zeros((y.shape[0], 2, y.shape[3]), dtype=torch.float32, device=y.device)
        bwd = conv3x3_stats_bwd_cuda if x.is_cuda else conv3x3_stats_bwd_plain
        grads = bwd(x, a, b, w, bias, skip, ws, wsb, y, gy, gstats, ctx.activation)
        return _to_dtypes(grads, ctx.dtypes) + (None, None, None)


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
    """Launch the K2 kernel (`ragb_subpixel_upsample_conv3x3_stats`, the conv
    engine's CONV_UP mode): one statistics partial row per parity and engine
    tile of the small image. `w_fold`: `w` already folded
    (`fold_subpixel_weights`) in x's dtype, as a module keeps it across
    calls; folded here when not given."""
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
    th, tw = _tile_shape("ragb_conv_sm90_tile_shape")
    tiles = 4 * -(-height // th) * -(-width // tw)         # a partial row per parity and engine tile
    y = torch.empty((bsz, 2 * height, 2 * width, n_out), dtype=x.dtype, device=x.device)
    partial = torch.empty((bsz, tiles, 2, n_out), dtype=torch.float32, device=x.device)
    stats = torch.empty((bsz, 2, n_out), dtype=torch.float32, device=x.device)
    err = _build.launch(
        "ragb_subpixel_upsample_conv3x3_stats", x.device,
        _ptr(x), _ptr(w_fold), _ptr(bias), _ptr(y), _ptr(partial), _ptr(stats),
        tiles, bsz, height, width, c_in, n_out,
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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_upsample_conv3x3_stats: unsupported device {x.device}")
    return _UpsampleConvStats.apply(x, w, bias, w_fold)


# ---------------------------------------------------------------------------
# K7: every cotangent of K2
# ---------------------------------------------------------------------------
def fold_subpixel_bwd_weights(w: Tensor) -> Tensor:
    """(3, 3, C, N) -> (4, 4, N, C): the doubly folded, transposed weights of
    the backward's stride-2 conv4x4. Row tap r reads dye row 2i - 1 + r and
    sums the forward's (parity, tap) pairs that reach it: [W2, W1+W2, W0+W1,
    W0]; columns fold the same way."""
    rows = [w[2], w[1] + w[2], w[0] + w[1], w[0]]          # (3, C, N) each
    out = []
    for r in rows:
        cols = [r[2], r[1] + r[2], r[0] + r[1], r[0]]      # (C, N) each
        out.append(torch.stack([c.t() for c in cols], dim=0))
    return torch.stack(out, dim=0)


def unfold_subpixel_weight_grad(dw_fold: Tensor) -> Tensor:
    """Adjoint of `fold_subpixel_weights`: the gradient of the folded weights
    (2, 2, 2, 2C, N) -> the gradient of the conv3x3 weights (3, 3, C, N)."""
    c_in, n_out = dw_fold.shape[3] // 2, dw_fold.shape[4]
    with torch.enable_grad():
        w = torch.zeros((3, 3, c_in, n_out), dtype=dw_fold.dtype, device=dw_fold.device,
                        requires_grad=True)
        (dw,) = torch.autograd.grad(fold_subpixel_weights(w), w, dw_fold)
    return dw


def upsample_conv3x3_stats_bwd_plain(
    x: Tensor, w: Tensor, bias: Tensor, y: Tensor, gy: Tensor, gstats: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of the K7 kernel: autograd through the literal
    nearest-2x + conv3x3 -> (dx, dw, dbias). `y` is recomputed, not read."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, w, bias)]
        y2, stats2 = upsample_conv3x3_stats_plain(*leaves)
        grads = torch.autograd.grad(
            [y2, stats2], leaves, [gy.to(y2.dtype), gstats.to(stats2.dtype)])
    return tuple(grads)


class K7Plan(NamedTuple):
    """K7's launch geometry: the slice counts of the dye pass and of the
    folded weights' gradient, and their partials' shapes."""
    s_dye: int
    s_w: int
    dbias_partial: Tuple[int, ...]
    dw_partial: Tuple[int, ...]


@functools.lru_cache(maxsize=None)
def upsample_conv3x3_stats_bwd_plan(bsz: int, height: int, width: int, c_in: int, n_out: int,
                                    sms: int = _H100_SMS) -> K7Plan:
    """K7's plan for x (bsz, height, width, c_in) -> n_out channels on the (2
    height, 2 width) grid, on a card of `sms` SMs: a weight-gradient block
    owns one (pa, pb, u) of the 8 with its 2 column taps and steps over the
    small grid's rows. Cached per shape."""
    s_dye = _dye_slices(4 * height * width, n_out)
    s_w = _wgrad_sm90_slices(bsz * height, width, c_in, n_out, 2, sms, groups=8)
    return K7Plan(s_dye, s_w, (bsz * s_dye, n_out), (s_w, 2, 2, 2, 2 * c_in, n_out))


def upsample_conv3x3_stats_bwd_cuda(
    x: Tensor, w: Tensor, bias: Tensor, y: Tensor, gy: Tensor, gstats: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch the K7 kernels (`ragb_subpixel_upsample_conv3x3_stats_bwd`: the
    dye pass, dx on the conv engine's CONV_UP_DX mode, the folded weights'
    gradient on `wgrad_sm90.cuh`): (dx bf16, dw fp32, dbias fp32). The kernel
    returns the gradient of the FOLDED weights; its adjoint fold to (3, 3,
    C, N) is fp32 glue here."""
    global UPSAMPLE_BWD_LAUNCHES
    name = "subpixel_upsample_conv3x3_stats_bwd"
    if x.ndim != 4 or w.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(f"{name}: x {tuple(x.shape)} and w {tuple(w.shape)} do not match")
    bsz, height, width, c_in = x.shape
    n_out = w.shape[3]
    dev = x.device
    x = x.contiguous()
    y = y.contiguous()
    gy = gy.to(x.dtype).contiguous()
    gstats = gstats.float().contiguous()
    # folded in fp32 from the weights the forward used, rounded once
    wb = fold_subpixel_bwd_weights(w.to(x.dtype).float()).to(x.dtype).contiguous()
    _check_cuda(name, x=x, wb=wb, y=y, gy=gy, gstats=gstats)
    _check_dtype(name, torch.bfloat16, x=x, wb=wb, y=y, gy=gy)
    out_shape = (bsz, 2 * height, 2 * width, n_out)
    if y.shape != out_shape or gy.shape != out_shape or gstats.shape != (bsz, 2, n_out):
        raise ValueError(f"{name}: y, gy must be {out_shape} and gstats {(bsz, 2, n_out)}")
    if c_in % 8 or n_out % 8:
        raise ValueError(f"{name}: channel counts must be multiples of 8, got C={c_in} N={n_out}")
    plan = upsample_conv3x3_stats_bwd_plan(bsz, height, width, c_in, n_out,
                                           torch.cuda.get_device_properties(dev).multi_processor_count)
    f32 = {"dtype": torch.float32, "device": dev}
    dye = torch.empty(out_shape, dtype=x.dtype, device=dev)
    dx = torch.empty_like(x)
    dw_fold = torch.empty((2, 2, 2, 2 * c_in, n_out), **f32)
    dbias = torch.empty((n_out,), **f32)
    dbias_partial = torch.empty(plan.dbias_partial, **f32)
    dw_partial = torch.empty(plan.dw_partial, **f32)
    err = _build.launch(
        "ragb_subpixel_upsample_conv3x3_stats_bwd", dev,
        _ptr(x), _ptr(wb), _ptr(y), _ptr(gy), _ptr(gstats),
        _ptr(dye), _ptr(dx), _ptr(dw_fold), _ptr(dbias), _ptr(dbias_partial), _ptr(dw_partial),
        plan.s_dye, plan.s_w, bsz, height, width, c_in, n_out,
    )
    _build.check(err, name)
    UPSAMPLE_BWD_LAUNCHES += 1
    return dx, unfold_subpixel_weight_grad(dw_fold), dbias


class _UpsampleConvStats(torch.autograd.Function):
    """K2 forward with K7 as its backward; saves x, w (on CUDA in the compute
    dtype), bias and its output. `w_fold` is a cached fold of w or None."""

    @staticmethod
    def forward(ctx, x, w, bias, w_fold):
        ctx.dtypes = (x.dtype, w.dtype, bias.dtype)
        if x.is_cuda:
            w = w.to(x.dtype)
            y, stats = upsample_conv3x3_stats_cuda(x, w, bias, w_fold=w_fold)
        else:
            y, stats = upsample_conv3x3_stats_plain(x, w, bias)
        ctx.save_for_backward(x, w, bias, y)
        ctx.set_materialize_grads(False)
        return y, stats

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy, gstats):
        x, w, bias, y = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(y)
        if gstats is None:
            gstats = torch.zeros((y.shape[0], 2, y.shape[3]), dtype=torch.float32, device=y.device)
        bwd = upsample_conv3x3_stats_bwd_cuda if x.is_cuda else upsample_conv3x3_stats_bwd_plain
        return _to_dtypes(bwd(x, w, bias, y, gy, gstats), ctx.dtypes) + (None,)


# ---------------------------------------------------------------------------
# K9: conv3x3 stride 2, pad ((0, 1), (0, 1)) + bias with stats
# ---------------------------------------------------------------------------
def downsample_conv3x3_stats_plain(x: Tensor, w: Tensor, bias: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain version of the K9 kernel: the literal stride-2 conv over the
    input padded by one row below and one column on the right (counterpart
    of `_xla_downsample_conv`)."""
    xp = F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1))
    y = F.conv2d(xp, w.to(x.dtype).permute(3, 2, 0, 1), stride=2).permute(0, 2, 3, 1)
    y = (y.float() + bias.float()).to(x.dtype)
    return y, tensor_stats(y)


def downsample_conv3x3_stats_cuda(x: Tensor, w: Tensor, bias: Tensor) -> Tuple[Tensor, Tensor]:
    """Launch the K9 kernel (`ragb_downsample_conv3x3_stats`)."""
    global DOWNSAMPLE_LAUNCHES
    name = "downsample_conv3x3_stats"
    if x.ndim != 4 or w.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(f"{name}: x {tuple(x.shape)} and w {tuple(w.shape)} do not match")
    bsz, height, width, c_in = x.shape
    n_out = w.shape[3]
    if height < 2 or width < 2:
        raise ValueError(f"{name}: the image must be at least 2 x 2, got {height} x {width}")
    x = x.contiguous()
    w = w.to(x.dtype).contiguous()
    bias = bias.float().contiguous()
    _check_cuda(name, x=x, w=w, bias=bias)
    _check_dtype(name, torch.bfloat16, x=x, w=w)
    if bias.shape != (n_out,):
        raise ValueError(f"{name}: bias must be ({n_out},)")
    if c_in % 8 or n_out % 8:
        raise ValueError(f"{name}: channel counts must be multiples of 8, got C={c_in} N={n_out}")
    h_out, w_out = height // 2, width // 2
    th, tw = _tile_shape("ragb_conv_sm90_tile_shape")
    tiles = -(-h_out // th) * -(-w_out // tw)
    y = torch.empty((bsz, h_out, w_out, n_out), dtype=x.dtype, device=x.device)
    # one allocation: the (B, T, 2, N) partials, then the (B, 2, N) statistics
    scratch = torch.empty(bsz * (tiles + 1) * 2 * n_out, dtype=torch.float32, device=x.device)
    partial, stats = scratch[: bsz * tiles * 2 * n_out], scratch[bsz * tiles * 2 * n_out:].view(bsz, 2, n_out)
    err = _build.launch(
        "ragb_downsample_conv3x3_stats", x.device,
        _ptr(x), _ptr(w), _ptr(bias), _ptr(y), _ptr(partial), _ptr(stats),
        tiles, bsz, height, width, c_in, n_out,
    )
    _build.check(err, name)
    DOWNSAMPLE_LAUNCHES += 1
    return y, stats


def plain_vjp(plain_fn, operands, cotangents):
    """The cotangents of `plain_fn(*operands)`'s outputs pulled back through
    it by autograd: the backward of a forward-only kernel. An absent
    cotangent counts as zero; each result is in its operand's dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in operands]
        outs = plain_fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g.to(o.dtype)) for o, g in zip(outs, cotangents) if g is not None]
        grads = torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs])
    return tuple(g.to(t.dtype) for g, t in zip(grads, operands))


class _DownsampleConvStats(torch.autograd.Function):
    """K9 forward; the backward differentiates the plain version, the
    statistics' cotangent included."""

    @staticmethod
    def forward(ctx, x, w, bias):
        if x.is_cuda:
            y, stats = downsample_conv3x3_stats_cuda(x, w, bias)
        else:
            y, stats = downsample_conv3x3_stats_plain(x, w, bias)
        ctx.save_for_backward(x, w, bias)
        ctx.set_materialize_grads(False)
        return y, stats

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy, gstats):
        return plain_vjp(downsample_conv3x3_stats_plain, ctx.saved_tensors, (gy, gstats))


def fused_downsample_conv3x3_stats(x: Tensor, w: Tensor, bias: Tensor) -> Tuple[Tensor, Tensor]:
    """conv3x3 stride 2, pad ((0, 1), (0, 1)) (w: (3, 3, C, N) HWIO) + bias,
    with the stats epilogue (diffusers Downsample2D numerics): (y (B, H // 2,
    W // 2, N), stats (B, 2, N) of the rounded y)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_downsample_conv3x3_stats: unsupported device {x.device}")
    return _DownsampleConvStats.apply(x, w, bias)


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
    """params: {"norm1": {scale, bias}, "conv1": {kernel (3,3,C,N), bias,
    optional u (the kernel's Winograd tiles, `wino_tiles`)}, "norm2": ...,
    "conv2": ..., optional "conv_shortcut": {kernel (C,N), bias}}.
    `stats`: optional (B, 2, C) statistics of x from the previous block's
    epilogue. Returns (out, stats(out))."""
    _, height, width, _ = x.shape
    hw = height * width
    if stats is None:
        stats = tensor_stats(x)
    a1, b1 = stats_to_coeffs(stats, params["norm1"]["scale"], params["norm1"]["bias"], num_groups, hw)
    y1, stats1 = gn_silu_conv3x3_stats(x, a1, b1, params["conv1"]["kernel"], params["conv1"]["bias"],
                                       u=params["conv1"].get("u"))
    a2, b2 = stats_to_coeffs(stats1, params["norm2"]["scale"], params["norm2"]["bias"], num_groups, hw)
    proj = None
    if "conv_shortcut" in params:
        proj = (params["conv_shortcut"]["kernel"], params["conv_shortcut"]["bias"])
    return gn_silu_conv3x3_stats(
        y1, a2, b2, params["conv2"]["kernel"], params["conv2"]["bias"], x, proj=proj,
        u=params["conv2"].get("u")
    )
