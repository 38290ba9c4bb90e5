"""The geometry of K2 and K7 on the Hopper kernels, restated in torch at tiny
fp32 sizes with ragged tiles, against the plain versions; and their host
plans. CPU only: the kernels run on the card, what they index does not.

- K2 (`conv_sm90.cuh` CONV_UP): a zero-haloed (TH + 2) x (TW + 2) slab of x a
  tile, flattened into rows; tap (u, v) of parity (pa, pb) takes, for output
  row i, the TW rows from (i + pa + u)(TW + 2) + pb + v, times the folded
  weights as (16, C, N) at t = ((pa * 2 + pb) * 2 + u) * 2 + v; the tile
  lands at rows 2h + pa, columns 2w + pb; one statistics partial row per
  (parity, tile).
- K7's dx (CONV_UP_DX): dye's parity plane (qa, qb) as a (TH + 1) x (TW + 1)
  slab from plane pixel (h0 - qa, w0 - qb); the plane's tap (u', v') takes
  the TW rows from (i + u')(TW + 1) + v' through wb[2u' + 1 - qa][2v' + 1 -
  qb].
- K7's dWf (`wgrad_sm90.cuh`, TAPS 2): a block per group (pa, pb, u), A the
  BK + 1 pixels of x's row h + pa + u - 1 from column w0 + pb - 1 (tap v
  from v rows in), B dye's row 2h + pa at columns 2w + pb; rows whose A row
  lies outside the image skipped; split-K over the B * H rows into (S, 8, 2,
  C, N) partials summed in slice order.

fp32 on both sides, so 1e-4 of the largest value covers the re-associated
sums (as tests/test_torch_resnet_block.py holds the plain versions to the
JAX kernels)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ragb_vae_tpu_torch.ops.kernels import resnet_block as rb

CSRC = Path(rb.__file__).resolve().parents[2] / "csrc"
TOL = 1e-4

# (x shape, N): ragged against both tiles below, C and N not multiples of 8
# where the restatement does not need it
SHAPES = [((2, 5, 7, 8), 16), ((1, 9, 10, 16), 8), ((3, 3, 13, 4), 12)]
# the engine's tile as its source declares it, and a small one that cuts
# these images into several ragged tiles
TILES = ["engine", (2, 4)]


def _engine_tile():
    match = re.search(r"static constexpr int TH = (\d+), TW = (\d+);", (CSRC / "conv_sm90.cuh").read_text())
    return int(match.group(1)), int(match.group(2))


def _tile(tile):
    return _engine_tile() if tile == "engine" else tile


def _inputs(shape, n, seed):
    rng = np.random.default_rng(seed)
    bsz, h, w, c = shape
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    wt = torch.from_numpy((rng.standard_normal((3, 3, c, n)) / np.sqrt(9 * c)).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(n)).astype(np.float32))
    gstats = torch.from_numpy((0.1 * rng.standard_normal((bsz, 2, n))).astype(np.float32))
    gy = torch.from_numpy(rng.standard_normal((bsz, 2 * h, 2 * w, n)).astype(np.float32))
    return x, wt, bias, gy, gstats


def _close(got, want):
    assert got.shape == want.shape
    assert (got - want).abs().max() <= TOL * want.abs().max()


def _windows(slab, first_row, rows_per_out, rows, width):
    """The A operand of output rows 0 .. rows - 1: `width` consecutive slab
    rows from first_row + i * rows_per_out, as (rows, width, C)."""
    return torch.stack([slab[first_row + i * rows_per_out: first_row + i * rows_per_out + width]
                        for i in range(rows)])


def k2_by_slabs(x, w, bias, tile):
    """K2's y and its per-(parity, tile) statistics partials (B, T, 2, N)."""
    th, tw = tile
    bsz, h, wd, c = x.shape
    n = w.shape[3]
    wf = rb.fold_subpixel_weights(w).reshape(16, c, n)
    tiles_w = -(-wd // tw)
    tiles = -(-h // th) * tiles_w
    # the slab of tile (h0, w0) is x[h0 - 1 .. h0 + th, w0 - 1 .. w0 + tw], zero outside
    xp = F.pad(x, (0, 0, 1, tw + 1, 1, th + 1))
    y = torch.zeros((bsz, 2 * h, 2 * wd, n))
    partial = torch.zeros((bsz, 4 * tiles, 2, n))
    for b in range(bsz):
        for t in range(tiles):
            h0, w0 = t // tiles_w * th, t % tiles_w * tw
            slab = xp[b, h0:h0 + th + 2, w0:w0 + tw + 2].reshape(-1, c)
            rows, cols = min(th, h - h0), min(tw, wd - w0)
            for parity in range(4):
                pa, pb = parity >> 1, parity & 1
                acc = torch.zeros((th, tw, n))
                for tap in range(4):
                    u, v = tap // 2, tap % 2
                    acc += _windows(slab, (pa + u) * (tw + 2) + pb + v, tw + 2, th, tw) @ wf[parity * 4 + tap]
                out = (acc + bias)[:rows, :cols]
                y[b, 2 * h0 + pa:2 * (h0 + rows):2, 2 * w0 + pb:2 * (w0 + cols):2] = out
                partial[b, parity * tiles + t] = torch.stack([out.sum(dim=(0, 1)), out.square().sum(dim=(0, 1))])
    return y, partial


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("shape,n", SHAPES)
def test_k2_slab_windows_reproduce_the_plain_version(shape, n, tile):
    x, w, bias, *_ = _inputs(shape, n, 0)
    y, partial = k2_by_slabs(x, w, bias, _tile(tile))
    y_ref, stats_ref = rb.upsample_conv3x3_stats_plain(x, w, bias)
    _close(y, y_ref)
    # every output pixel lies in exactly one (parity, tile): the partials add up to the statistics
    _close(partial.sum(dim=1), stats_ref)


def _dye(y, gy, gstats):
    return gy + gstats[:, 0, None, None, :] + 2.0 * y * gstats[:, 1, None, None, :]


def k7_dx_by_planes(dye, wb, tile):
    """K7's dx over dye's four parity planes, a (TH + 1) x (TW + 1) slab each."""
    th, tw = tile
    bsz, h2, w2, n = dye.shape
    h, wd, c = h2 // 2, w2 // 2, wb.shape[3]
    tiles_w = -(-wd // tw)
    dx = torch.zeros((bsz, h, wd, c))
    for b in range(bsz):
        for t in range(-(-h // th) * tiles_w):
            h0, w0 = t // tiles_w * th, t % tiles_w * tw
            acc = torch.zeros((th, tw, c))
            for plane in range(4):
                qa, qb = plane >> 1, plane & 1
                # plane pixel (k, k') = dye[2k + qa, 2k' + qb]; the slab starts at (h0 - qa, w0 - qb), zero outside
                pp = F.pad(dye[b, qa::2, qb::2], (0, 0, 1, tw + 1, 1, th + 1))
                slab = pp[h0 - qa + 1:h0 - qa + 1 + th + 1, w0 - qb + 1:w0 - qb + 1 + tw + 1].reshape(-1, n)
                for tap in range(4):
                    u, v = tap // 2, tap % 2
                    acc += _windows(slab, u * (tw + 1) + v, tw + 1, th, tw) @ wb[2 * u + 1 - qa, 2 * v + 1 - qb]
            rows, cols = min(th, h - h0), min(tw, wd - w0)
            dx[b, h0:h0 + rows, w0:w0 + cols] = acc[:rows, :cols]
    return dx


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("shape,n", SHAPES)
def test_k7_dx_reproduces_the_plain_version(shape, n, tile):
    x, w, bias, gy, gstats = _inputs(shape, n, 1)
    y, _ = rb.upsample_conv3x3_stats_plain(x, w, bias)
    wb = rb.fold_subpixel_bwd_weights(w)
    dx = k7_dx_by_planes(_dye(y, gy, gstats), wb, _tile(tile))
    dx_ref, _, _ = rb.upsample_conv3x3_stats_bwd_plain(x, w, bias, y, gy, gstats)
    _close(dx, dx_ref)


def k7_dwf_by_groups(x, dye, slices, bk):
    """The folded weights' gradient (2, 2, 2, 2C, N) as the weight-gradient
    kernel's blocks form it: (S, 8, 2, C, N) partials, then their sum in
    slice order."""
    bsz, h, wd, c = x.shape
    n = dye.shape[3]
    rows = bsz * h
    per = -(-rows // slices)
    xp = F.pad(x, (0, 0, 1, bk + 1))                     # A columns w0 + pb - 1 .. w0 + pb - 1 + bk
    dp = F.pad(dye, (0, 0, 0, 2 * bk + 2))               # B columns 2w + pb, w < w0 + bk
    partial = torch.zeros((slices, 8, 2, c, n))
    for s in range(slices):
        for row in range(s * per, min(rows, (s + 1) * per)):
            b, hh = divmod(row, h)
            for g in range(8):
                pa, pb, u = g >> 2, g >> 1 & 1, g & 1
                ar = hh + pa + u - 1
                if not 0 <= ar < h:                      # a zero row of A adds nothing
                    continue
                for w0 in range(0, wd, bk):
                    a = xp[b, ar, w0 + pb:w0 + pb + bk + 1]
                    d = dp[b, 2 * hh + pa, 2 * w0 + pb:2 * w0 + pb + 2 * bk:2]
                    for v in range(2):
                        partial[s, g, v] += a[v:v + bk].t() @ d
    total = partial[0].clone()
    for s in range(1, slices):
        total += partial[s]
    return total.reshape(2, 2, 2, 2 * c, n)


@pytest.mark.parametrize("bk", [64, 4])
@pytest.mark.parametrize("shape,n", SHAPES)
def test_k7_weight_gradient_by_groups_reproduces_the_plain_version(shape, n, bk):
    x, w, bias, gy, gstats = _inputs(shape, n, 2)
    y, _ = rb.upsample_conv3x3_stats_plain(x, w, bias)
    bsz, h, wd, c = shape
    slices = rb.upsample_conv3x3_stats_bwd_plan(bsz, h, wd, c, n).s_w if bk == 64 else 3
    dwf = k7_dwf_by_groups(x, _dye(y, gy, gstats), slices, bk)
    _, dw_ref, _ = rb.upsample_conv3x3_stats_bwd_plain(x, w, bias, y, gy, gstats)
    _close(rb.unfold_subpixel_weight_grad(dwf), dw_ref)


# ---------------------------------------------------------------------------
# the host plans
# ---------------------------------------------------------------------------
# the shapes a VAE micro-batch of 4 at 512^2 gives K2 and K7, chip_smoke's
# ragged ones and more ragged edges
PLAN_SHAPES = [((4, 64, 64, 512), 512), ((4, 128, 128, 512), 512), ((4, 256, 256, 256), 256),
               ((2, 64, 64, 512), 512), ((1, 19, 27, 64), 128), ((2, 37, 50, 72), 136), ((1, 1, 1, 8), 8),
               ((3, 5, 300, 24), 40)]


@pytest.mark.parametrize("shape,n", PLAN_SHAPES)
def test_k7_plan_partials_and_slices(shape, n):
    bsz, h, w, c = shape
    plan = rb.upsample_conv3x3_stats_bwd_plan(bsz, h, w, c, n)
    assert plan.dw_partial == (plan.s_w, 2, 2, 2, 2 * c, n)
    assert plan.dbias_partial == (bsz * plan.s_dye, n)
    rows = bsz * h
    assert 1 <= plan.s_w <= min(rb.MAX_WGRAD_SLICES, rows)
    assert (plan.s_w - 1) * -(-rows // plan.s_w) < rows          # the last slice starts inside the rows
    pixels = 4 * h * w
    assert 1 <= plan.s_dye and (plan.s_dye - 1) * -(-pixels // plan.s_dye) < pixels


def test_k7_plan_is_cached_per_shape():
    a = rb.upsample_conv3x3_stats_bwd_plan(2, 37, 50, 72, 136)
    assert rb.upsample_conv3x3_stats_bwd_plan(2, 37, 50, 72, 136) is a
