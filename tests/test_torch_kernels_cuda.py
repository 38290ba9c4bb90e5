"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Marked `cuda`: each test skips when no CUDA device is present (decided in a
fixture, never at import). Run on a machine with the card and nvcc:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

bf16 in and out. Tolerances: conv outputs round to bf16 once in the kernel
and twice in the plain version (2^-8 relative each), so 3e-2 of the largest
value; statistics normalised by H*W*mean(y^2) to 1e-2; attention to 2e-2
absolute (probabilities rounded to bf16 before vs after normalisation), and
its LSE to 1e-4 of the fp32 logsumexp. `chip_smoke.py` adds the sharper
checks against exact fp32 references.
"""
import math

import pytest
import torch

from ragb_vae_tpu_torch.ops.kernels import flash_attention as fa
from ragb_vae_tpu_torch.ops.kernels import resnet_block as rb

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _randn(gen, shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def _check_conv(y, s, y_ref, s_ref):
    rf = y_ref.float()
    assert (y.float() - rf).abs().max() <= 3e-2 * rf.abs().max()
    norm = y.shape[1] * y.shape[2] * rf.square().mean()
    assert (s - s_ref).abs().max() <= 1e-2 * norm


@pytest.mark.parametrize("shape,n,skip,act", [
    ((1, 36, 24, 128), 128, None, "silu"),           # ragged tiles (576x384 request)
    ((2, 72, 48, 256), 128, "proj", "silu"),
    ((1, 19, 33, 64), 64, "identity", "identity"),
])
def test_conv3x3_stats_kernel(shape, n, skip, act):
    gen = torch.Generator("cuda").manual_seed(0)
    bsz, h, w, c = shape
    x = _randn(gen, shape)
    a = 1.0 + 0.1 * torch.randn((bsz, c), generator=gen, device="cuda")
    b = 0.1 * torch.randn((bsz, c), generator=gen, device="cuda")
    wt = _randn(gen, (3, 3, c, n), 1.0 / math.sqrt(9 * c))
    bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
    sk = ws = wsb = None
    if skip == "identity":
        sk = _randn(gen, (bsz, h, w, n))
    elif skip == "proj":
        sk, ws, wsb = x, _randn(gen, (c, n), c ** -0.5), torch.zeros(n, device="cuda")
    before = rb.CONV_LAUNCHES
    y, s = rb.gn_silu_conv3x3_stats(x, a, b, wt, bias, sk, proj=None if ws is None else (ws, wsb),
                                    activation=act)
    assert rb.CONV_LAUNCHES == before + 1
    _check_conv(y, s, *rb.conv3x3_stats_plain(x, a, b, wt, bias, sk, ws, wsb, act))


def test_conv3x3_stats_kernel_is_deterministic():
    gen = torch.Generator("cuda").manual_seed(1)
    x = _randn(gen, (2, 64, 64, 256))
    a, b = torch.ones(2, 256, device="cuda"), torch.zeros(2, 256, device="cuda")
    wt, bias = _randn(gen, (3, 3, 256, 256), 0.02), torch.zeros(256, device="cuda")
    y1, s1 = rb.conv3x3_stats_cuda(x, a, b, wt, bias)
    y2, s2 = rb.conv3x3_stats_cuda(x, a, b, wt, bias)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.parametrize("shape,n", [((1, 36, 24, 512), 512), ((2, 9, 13, 64), 64)])
def test_upsample_kernel(shape, n):
    gen = torch.Generator("cuda").manual_seed(2)
    x = _randn(gen, shape)
    wt = _randn(gen, (3, 3, shape[3], n), 1.0 / math.sqrt(9 * shape[3]))
    bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
    before = rb.UPSAMPLE_LAUNCHES
    y, s = rb.fused_upsample_conv3x3_stats(x, wt, bias)
    assert rb.UPSAMPLE_LAUNCHES == before + 1
    _check_conv(y, s, *rb.upsample_conv3x3_stats_plain(x, wt, bias))


@pytest.mark.parametrize("bh,sq,sk,d", [(4, 77, 200, 128), (48, 2240, 2240, 128), (1, 3456, 3456, 512)])
def test_flash_attention_kernel(bh, sq, sk, d):
    gen = torch.Generator("cuda").manual_seed(3)
    q, k, v = _randn(gen, (bh, sq, d)), _randn(gen, (bh, sk, d)), _randn(gen, (bh, sk, d))
    out, lse = fa.flash_attention_cuda(q, k, v, sm_scale=d ** -0.5)
    ref = fa.attention_plain(q, k, v, sm_scale=d ** -0.5)
    assert (out.float() - ref.float()).abs().max() <= 2e-2
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * d ** -0.5
    # absolute: a dropped or unmasked key tail moves the LSE by ~1/S per key
    torch.testing.assert_close(lse, torch.logsumexp(logits, dim=-1), rtol=0, atol=1e-4)


def test_upsample_module_follows_weight_changes():
    """The fused Upsample keeps its folded weights across calls; an in-place
    write to the conv weight must reach the next launch."""
    from ragb_vae_tpu_torch.models.vae import Upsample

    torch.manual_seed(0)
    up = Upsample(64, fused=True, device="cuda", dtype=torch.bfloat16)
    x = torch.randn((1, 9, 13, 64), device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        for _ in range(2):
            y, s = up(x)
            _check_conv(y, s, *rb.upsample_conv3x3_stats_plain(x, up.conv.weight.permute(2, 3, 1, 0),
                                                               up.conv.bias))
            up.conv.weight.mul_(-1.5)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((1, 8, 8, 12), device="cuda", dtype=torch.bfloat16)  # C % 8 != 0
    ones = torch.ones((1, 12), device="cuda")
    with pytest.raises(ValueError):
        rb.gn_silu_conv3x3_stats(x, ones, ones * 0, torch.zeros((3, 3, 12, 16), device="cuda"),
                                 torch.zeros(16, device="cuda"))
    q = torch.zeros((1, 4, 8, 96), device="cuda", dtype=torch.bfloat16)  # head dim 96
    with pytest.raises(ValueError):
        fa.attention(q, q, q)
    q32 = torch.zeros((1, 4, 8, 128), device="cuda")  # fp32
    with pytest.raises(ValueError):
        fa.attention(q32, q32, q32)
