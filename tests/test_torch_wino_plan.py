"""K8's host-side plan (`wino_plan`) and the geometry of its kernel
(`csrc/resnet_block_wino.cu`), restated in torch: the tile grid and the
statistics partials the wrapper sizes, the shared-memory budget, each
step's transform tasks, the projection's strided skip boxes and the
epilogue's output rows each covering their part exactly once. CPU only: the
plan is plain Python and the geometry is read from the source."""
import inspect
import re
from pathlib import Path

import pytest
import torch

from ragb_vae_tpu_torch.ops.kernels import resnet_block as rb

SRC = Path(rb.__file__).resolve().parents[2] / "csrc" / "resnet_block_wino.cu"
SMEM_LIMIT = 232448            # the shared memory a block can opt in to on an H100

# the shapes the Winograd route takes in the VAE at 512^2 (the JAX predicate's
# aligned ones) and the ragged ones the kernel takes besides
SHAPES = [
    ((2, 128, 128, 512), 512), ((1, 512, 512, 128), 128), ((2, 128, 128, 256), 512), ((4, 256, 256, 256), 256),
    ((1, 36, 24, 128), 128), ((2, 22, 70, 72), 136), ((1, 10, 14, 64), 40), ((3, 2, 2, 8), 8),
]


def _constants() -> dict:
    """The `Wino` struct's integer constants as the source declares them."""
    text = SRC.read_text()
    body = text[text.index("struct Wino {"):text.index("};", text.index("struct Wino {"))]
    found = {}
    for name, value in re.findall(r"(\w+) = ([^,;]+)[,;]", body):
        expr = re.sub(r"\b([A-Za-z_]\w*)\b", lambda m: str(found.get(m.group(1), m.group(1))), value.strip())
        try:
            found[name] = int(eval(expr.replace("/", "//"), {}))
        except (NameError, SyntaxError):
            continue
    return found


def test_tile_and_widths_are_the_ones_the_source_declares():
    k = _constants()
    assert (k["TH"], k["TW"], k["BN"], k["BK"]) == (8, 32, 64, 64)
    assert (k["TTH"], k["TTW"]) == (4, 16) and k["TTH"] * k["TTW"] == 64        # one m64 of Winograd tiles
    assert rb._WINO_BN == k["BN"]


def test_shared_memory_fits_the_card():
    """Two slab stages (10 x 34 pixels of 128 bytes, 1 KB aligned), two V and
    two U stages of four 8 KB planes, the statistics scratch and the
    barriers: within the 227 KB a block can opt in to."""
    k = _constants()
    slab = (k["TH"] + 2) * (k["TW"] + 2) * 128
    stage = -(-slab // 1024) * 1024
    total = 2 * stage + 2 * 4 * 64 * 128 + 2 * 4 * 64 * 128 + 2 * 8 * k["BN"] * 4 + k["BARS"] * 8 + 1024
    assert total == k["bytes"] and total <= SMEM_LIMIT


def test_wrapper_sizes_its_partials_from_the_plan():
    src = inspect.getsource(rb.wino_conv3x3_stats_cuda)
    assert '_tile_shape("ragb_wino_tile_shape")' in src and "wino_plan(" in src and "plan.partial" in src


@pytest.mark.parametrize("shape,n", SHAPES)
def test_plan_grid_and_partials(shape, n):
    """Every output pixel lies in exactly one tile and every channel in one
    N tile, and every (tile, image) writes one partial row: restated as a
    torch count of the tiles over the output."""
    bsz, h, w, _ = shape
    k = _constants()
    plan = rb.wino_plan(bsz, h, w, n, (k["TH"], k["TW"]))
    assert plan.partial == (bsz, plan.tiles, 2, n) and plan.grid[1:] == (plan.tiles, bsz)
    tiles_w = -(-w // k["TW"])
    pixels = torch.zeros((h, w), dtype=torch.int32)
    for t in range(plan.grid[1]):
        h0, w0 = (t // tiles_w) * k["TH"], (t % tiles_w) * k["TW"]
        pixels[h0:h0 + k["TH"], w0:w0 + k["TW"]] += 1
    channels = torch.zeros(plan.grid[0] * 64, dtype=torch.int32)
    for nt in range(plan.grid[0]):
        channels[nt * 64:nt * 64 + 64] += 1
    assert bool((pixels == 1).all()) and bool((channels[:n] == 1).all()) and plan.grid[0] * 64 - n < 64


def test_a_steps_transform_tasks_cover_each_tile_and_chunk_once():
    """Consumer thread i transforms the tile pair ((2 (i / 8 / 16), (i / 8) %
    16), one row down) in 16-byte chunk i % 8, both halves: every (tile,
    chunk) of the 64 tiles once, and a pair's two tiles share two slab rows."""
    k = _constants()
    cover = torch.zeros((k["TTH"], k["TTW"], 8), dtype=torch.int32)
    for i in range(256):
        lc, pair = i & 7, i >> 3
        ty, tx = 2 * (pair // k["TTW"]), pair % k["TTW"]
        cover[ty:ty + 2, tx, lc] += 1
        rows = [set(range(2 * t, 2 * t + 4)) for t in (ty, ty + 1)]
        assert len(rows[0] & rows[1]) == 2 and max(rows[1]) < k["TH"] + 2
    assert bool((cover == 1).all())


def test_the_projection_boxes_and_output_rows_cover_the_tile_once():
    """Warpgroup p's projection box at column q reads the skip's pixels (2 ty
    + p, 2 tx + q): a {64, 32, 8} box at traversal strides {1, 2, 2} from
    (w0 + q, h0 + p); warp `warp` of warpgroup p stores output row 2 warp +
    p. Restated over one tile: each pixel once."""
    k = _constants()
    proj = torch.zeros((k["TH"], k["TW"]), dtype=torch.int32)
    rows = torch.zeros(k["TH"], dtype=torch.int32)
    for p in range(2):
        for q in range(2):
            proj[p::2, q::2][: k["TH"] // 2, : k["TW"] // 2] += 1
        for warp in range(4):
            rows[2 * warp + p] += 1
    assert bool((proj == 1).all()) and bool((rows == 1).all())
    text = SRC.read_text()
    assert "tma_load_4d(u_stage(st), &smap, cs0, w0 + q, h0, b, u_full(st));" in text
    assert "tma_load_4d(u_stage(st) + L::PLANE, &smap, cs0, w0 + q, h0 + 1, b, u_full(st));" in text


def test_the_wrapper_refuses_tiles_it_was_not_given():
    """The U tiles given to the CUDA wrapper are checked before any launch."""
    x = torch.zeros((1, 2, 16, 8), dtype=torch.bfloat16)
    a, b = torch.ones((1, 8)), torch.zeros((1, 8))
    w, bias = torch.zeros((3, 3, 8, 8), dtype=torch.bfloat16), torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rb.wino_conv3x3_stats_cuda(x, a, b, w, bias, u=rb.wino_tiles(w))
