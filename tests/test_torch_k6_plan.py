"""K6's host-side plan (`conv3x3_stats_bwd_plan`): the (da, db) partials
count the Hopper conv engine's tiles, the split-K weight gradient's slices
stay within bounds and leave no slice without a row, and the scratch shapes
are the ones the kernels index; dskip's persistent grid covers each output
tile and channel once. CPU only: the plan is plain Python."""
import inspect
import re
from pathlib import Path

import pytest
import torch

from ragb_vae_tpu_torch.ops.kernels import resnet_block as rb

CSRC = Path(rb.__file__).resolve().parents[2] / "csrc"

# the shapes a VAE micro-batch of 4 at 512^2 gives K6 (the encoder sees the
# triplet, batch 12), chip_smoke's ragged ones and more ragged edges
SHAPES = [
    ((4, 128, 128, 512), 512, 0), ((4, 256, 256, 512), 256, 512), ((12, 64, 64, 512), 512, 0),
    ((4, 512, 512, 128), 128, 256), ((12, 512, 512, 128), 128, 0), ((12, 256, 256, 256), 256, 128),
    ((1, 64, 64, 128), 128, 0), ((2, 37, 50, 128), 256, 128), ((2, 20, 131, 64), 136, 64),
    ((1, 1, 1, 8), 8, 0), ((3, 5, 300, 24), 40, 0),
]


def _engine_tile():
    """The engine's output tile as its source declares it."""
    match = re.search(r"static constexpr int TH = (\d+), TW = (\d+);", (CSRC / "conv_sm90.cuh").read_text())
    return int(match.group(1)), int(match.group(2))


def test_engine_tile_is_the_one_the_source_declares():
    assert _engine_tile() == (4, 64)


def test_wrapper_counts_the_engines_tiles():
    """T comes from the engine's tile (the library's export)."""
    src = inspect.getsource(rb.conv3x3_stats_bwd_cuda)
    assert '_tile_shape("ragb_conv_sm90_tile_shape")' in src and "_tile_shape()" not in src


@pytest.mark.parametrize("shape,n,cs", SHAPES)
def test_plan_partials_match_the_kernels(shape, n, cs):
    bsz, h, w, c = shape
    th, tw = _engine_tile()
    plan = rb.conv3x3_stats_bwd_plan(bsz, h, w, c, n, cs, (th, tw))
    assert plan.tiles == -(-h // th) * -(-w // tw)
    assert plan.dab_partial == (bsz, plan.tiles, 2, c)
    assert plan.dbias_partial == (bsz * plan.s_dye, n)
    assert plan.dw_partial == (plan.s_w, 3, 3, c, n)
    if cs:
        assert plan.dws_partial == (plan.s_ws, cs, n) and plan.s_ws >= 1
    else:
        assert plan.dws_partial is None and plan.s_ws == 0


@pytest.mark.parametrize("shape,n,cs", SHAPES)
def test_slices_are_bounded_and_none_is_empty(shape, n, cs):
    bsz, h, w, c = shape
    plan = rb.conv3x3_stats_bwd_plan(bsz, h, w, c, n, cs, _engine_tile())
    rows = bsz * h
    for s in (plan.s_w,) + ((plan.s_ws,) if cs else ()):
        assert 1 <= s <= min(rb.MAX_WGRAD_SLICES, rows)
        per = -(-rows // s)
        assert (s - 1) * per < rows          # the kernel's last slice starts inside the rows
    per = -(-h * w // plan.s_dye)
    assert 1 <= plan.s_dye and (plan.s_dye - 1) * per < h * w


@pytest.mark.parametrize("shape,n,cs", SHAPES[:6])
def test_slices_minimise_the_cost_model(shape, n, cs):
    """The chosen slice count is the cheapest under the model (waves of
    one-block-an-SM blocks times their k-steps, plus the partials' bytes),
    and no smaller count is as cheap."""
    bsz, h, w, c = shape
    rows, sms = bsz * h, 132
    bm, bn, bk = rb._WGRAD_SM90_TILE

    def cost(s, taps, cin):
        tiles = -(-cin // bm) * -(-n // bn) * taps
        step = 2.0 * bm * bn * bk * taps / (rb._PEAK_FLOPS / sms)
        part = 2.0 * taps * taps * cin * n * 4 / rb._PEAK_BYTES
        return -(-tiles * s // sms) * -(-rows // s) * -(-w // bk) * step + s * part

    plan = rb.conv3x3_stats_bwd_plan(bsz, h, w, c, n, cs, _engine_tile(), sms)
    for chosen, taps, cin in ((plan.s_w, 3, c),) + (((plan.s_ws, 1, cs),) if cs else ()):
        best = min(cost(s, taps, cin) for s in range(1, min(rb.MAX_WGRAD_SLICES, rows) + 1))
        assert cost(chosen, taps, cin) == pytest.approx(best)


def test_plan_fills_the_card_at_the_decoders_last_level():
    """At 512^2 x 128 channels one C x N tile of 128 x 128 per tap row leaves
    3 blocks a slice: the plan takes enough slices for one full wave."""
    plan = rb.conv3x3_stats_bwd_plan(4, 512, 512, 128, 128, 0, _engine_tile(), 132)
    assert 3 * plan.s_w == 132
    plan = rb.conv3x3_stats_bwd_plan(4, 128, 128, 512, 512, 0, _engine_tile(), 132)
    assert plan.s_w == 8                      # 384 blocks: 3 waves, 97% full


def test_plan_is_cached_per_shape():
    a = rb.conv3x3_stats_bwd_plan(2, 37, 50, 128, 256, 128, (4, 64))
    assert rb.conv3x3_stats_bwd_plan(2, 37, 50, 128, 256, 128, (4, 64)) is a


# K6's dskip on the conv engine's one-tap mode (CONV_1X1): about one block an
# SM per 128-channel tile of Cs, each walking the (image, tile) items of the
# engine's 4 x 64 tile; restated from the launcher in conv_sm90.cuh
SKIP_SHAPES = [((12, 256, 256, 256), 128), ((12, 128, 128, 512), 256), ((4, 256, 256, 256), 512),
               ((4, 512, 512, 128), 256), ((2, 37, 50, 136), 200), ((2, 37, 50, 128), 40), ((1, 1, 1, 8), 8)]


def _skip_grid(bsz, h, w, c_skip, sms=132):
    """(N tiles, blocks per N tile, items): the launcher's grid for dskip."""
    th, tw = _engine_tile()
    items = bsz * -(-h // th) * -(-w // tw)
    n_tiles = -(-c_skip // 128)
    per_tile = sms // n_tiles if 0 < n_tiles <= sms else 1
    return n_tiles, min(items, per_tile), items


def test_dskip_launcher_is_the_one_restated():
    text = (CSRC / "conv_sm90.cuh").read_text()
    assert "const int per_tile = grid.x > 0 && sms >= (int)grid.x ? sms / (int)grid.x : 1;" in text
    assert "grid.y = (unsigned)(items < per_tile ? items : per_tile);" in text
    assert "for (int item = blockIdx.y; item < items; item += gridDim.y) {" in text


@pytest.mark.parametrize("shape,c_skip", SKIP_SHAPES)
def test_dskip_blocks_cover_every_tile_and_channel_once(shape, c_skip):
    """Each block (n tile, j) walks items j, j + gridDim.y, ...: every output
    pixel of every image and every channel of a ragged Cs lies in exactly
    one block's items once (the last N tile's channels past Cs are masked
    by the TMA store); restated as a torch count over the output."""
    bsz, h, w, n = shape
    th, tw = _engine_tile()
    n_tiles, blocks, items = _skip_grid(bsz, h, w, c_skip)
    assert n_tiles == -(-c_skip // 128) and 1 <= blocks <= 132
    tiles_w, tiles = -(-w // tw), -(-h // th) * -(-w // tw)
    cover = torch.zeros((bsz, tiles, n_tiles), dtype=torch.int32)      # (image, tile, N tile) of the items walked
    for nt in range(n_tiles):
        for j in range(blocks):
            for item in range(j, items, blocks):
                b, t = divmod(item, tiles)
                cover[b, t, nt] += 1
    assert bool((cover == 1).all())
    pixels = torch.zeros((h, w), dtype=torch.int32)       # the tiles' pixels, clipped at the image's edges
    for t in range(tiles):
        h0, w0 = (t // tiles_w) * th, (t % tiles_w) * tw
        pixels[h0:h0 + th, w0:w0 + tw] += 1
    channels = torch.zeros(n_tiles * 128, dtype=torch.int32)
    for nt in range(n_tiles):
        channels[nt * 128:(nt + 1) * 128] += 1
    assert bool((pixels == 1).all()) and bool((channels[:c_skip] == 1).all()) and n_tiles * 128 - c_skip < 128
    # the contraction over dye's N channels: 64-channel k-steps, the last
    # ragged one zero-filled by TMA
    assert -(-n // 64) * 64 >= n


def test_dskip_plain_version_is_the_projection_cotangent():
    """`skip_grad_plain(dye, ws)` is K6's dskip: the skip's cotangent that
    autograd through the plain forward gives, with dye = gy + ds0 + 2 y ds1
    (fp32 on the CPU, so only the order of sums differs)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 4, 6, 16), generator=gen)
    skip = torch.randn((2, 4, 6, 24), generator=gen)
    a, b = 1.0 + 0.1 * torch.randn((2, 16), generator=gen), 0.1 * torch.randn((2, 16), generator=gen)
    w, bias = 0.1 * torch.randn((3, 3, 16, 32), generator=gen), 0.1 * torch.randn(32, generator=gen)
    ws, wsb = 0.2 * torch.randn((24, 32), generator=gen), 0.1 * torch.randn(32, generator=gen)
    y, _ = rb.conv3x3_stats_plain(x, a, b, w, bias, skip, ws, wsb)
    gy, gstats = torch.randn(y.shape, generator=gen), 0.1 * torch.randn((2, 2, 32), generator=gen)
    dskip = rb.conv3x3_stats_bwd_plain(x, a, b, w, bias, skip, ws, wsb, y, gy, gstats)[5]
    dye = gy + gstats[:, None, None, 0] + 2.0 * y * gstats[:, None, None, 1]
    torch.testing.assert_close(rb.skip_grad_plain(dye, ws), dskip, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rb.skip_grad_cuda(dye.to(torch.bfloat16), ws)
