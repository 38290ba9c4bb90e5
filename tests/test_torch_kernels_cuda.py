"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Marked `cuda`: each test skips when no CUDA device is present (decided in a
fixture, never at import). Run on a machine with the card and nvcc:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

bf16 in and out. Tolerances: conv outputs round to bf16 once in the kernel
and twice in the plain version (2^-8 relative each), so 3e-2 of the largest
value; statistics normalised by H*W*mean(y^2) to 1e-2; attention to 2e-2
absolute (probabilities rounded to bf16 before vs after normalisation), and
its LSE to 1e-4 of the fp32 logsumexp; the attention backward (K4 dQ, K5
dK/dV) to 5e-2 of the plain backward's largest entry (the plain version rounds
the logits and dP to bf16 as well). Backward kernels (K6, K7): every
cotangent against the plain backward (autograd through the plain forward,
which rounds dye's terms, dA and the activation's cotangent to bf16 at other
places): 4e-2 of the largest reference value for the bf16 outputs, 2e-2 for
the fp32 sums. `chip_smoke.py` adds the sharper checks against exact fp32
references.
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
    # the projection as the model fuses it (conv2: C = N = Cout, a skip of
    # Cin channels), and every edge ragged: C and Cs not multiples of the
    # 64-channel chunk, N not a multiple of the 128-channel tile
    ((2, 40, 72, 256), 256, "proj128", "silu"),
    ((2, 37, 50, 72), 136, "proj40", "silu"),
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
    elif skip is not None:                           # "proj<Cs>": a skip of its own width
        c_skip = int(skip[4:])
        sk, ws = _randn(gen, (bsz, h, w, c_skip)), _randn(gen, (c_skip, n), c_skip ** -0.5)
        wsb = 0.1 * torch.randn((n,), generator=gen, device="cuda")
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


@pytest.mark.parametrize("shape,n", [
    ((1, 36, 24, 512), 512), ((2, 9, 13, 64), 64),
    # every edge ragged (C % 64 != 0, N % 128 != 0, H, W off the engine's
    # 4 x 64 tile), and the decoder's middle upsampler at the training batch
    ((2, 37, 50, 72), 136), ((4, 128, 128, 512), 512),
])
def test_upsample_kernel(shape, n):
    gen = torch.Generator("cuda").manual_seed(2)
    x = _randn(gen, shape)
    wt = _randn(gen, (3, 3, shape[3], n), 1.0 / math.sqrt(9 * shape[3]))
    bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
    before = rb.UPSAMPLE_LAUNCHES
    y, s = rb.fused_upsample_conv3x3_stats(x, wt, bias)
    assert rb.UPSAMPLE_LAUNCHES == before + 1
    _check_conv(y, s, *rb.upsample_conv3x3_stats_plain(x, wt, bias))


@pytest.mark.parametrize("bh,sq,sk,d", [
    (4, 77, 200, 128), (48, 2240, 2240, 128), (1, 3456, 3456, 512),
    # TMA and split edges: a key tail of 1 (tiles of 128 keys at d = 128, 32
    # at d = 512), Sq off the 64- and 128-row tiles, Sq != Sk, three heads of
    # ragged length (a tile past one head's end must read zeros, not the next
    # head's rows), the 1024^2 VAE mid-block, and key splits at d = 512: 2
    # ranges at (3, 1000, 1000), 8 of 19 or 20 tiles at (1, 1000, 5000)
    (2, 100, 129, 128), (2, 100, 33, 512), (3, 333, 1001, 128),
    (3, 1000, 1000, 512), (3, 257, 65, 512), (1, 1000, 5000, 512),
    (1, 16384, 16384, 512),
])
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


def _conv_case(gen, shape, n, skip):
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
        sk, ws = _randn(gen, shape), _randn(gen, (c, n), c ** -0.5)
        wsb = 0.1 * torch.randn((n,), generator=gen, device="cuda")
    return [x, a, b, wt, bias, sk, ws, wsb]


def _check_cotangents(got, want):
    assert len(got) == len(want)
    for g, r in zip(got, want):
        assert (g is None) == (r is None)
        if g is None:
            continue
        assert g.shape == r.shape and bool(torch.isfinite(g.float()).all())
        tol = 4e-2 if g.dtype == torch.bfloat16 else 2e-2
        assert (g.float() - r.float()).abs().max() <= tol * r.float().abs().max()


@pytest.mark.parametrize("shape,n,skip,act", [
    ((1, 36, 24, 128), 128, None, "silu"),
    ((2, 37, 50, 64), 128, "proj", "silu"),            # ragged in H, W and the channel tiles
    ((1, 19, 33, 64), 64, "identity", "identity"),
    ((3, 8, 8, 512), 512, "identity", "silu"),
    ((1, 512, 512, 128), 128, "identity", "silu"),     # the decoder's last level at 512^2
    ((2, 20, 131, 64), 136, "proj", "silu"),           # W past two 64-pixel k-steps, N past a 128 tile
])
def test_conv3x3_stats_bwd_kernel(shape, n, skip, act):
    gen = torch.Generator("cuda").manual_seed(4)
    ops = _conv_case(gen, shape, n, skip)
    y, _ = rb.conv3x3_stats_cuda(*ops, act)
    gy = _randn(gen, y.shape)
    gstats = 0.1 * torch.randn((shape[0], 2, n), generator=gen, device="cuda")
    before = rb.CONV_BWD_LAUNCHES
    got = rb.conv3x3_stats_bwd_cuda(*ops, y, gy, gstats, act)
    assert rb.CONV_BWD_LAUNCHES == before + 1
    _check_cotangents(got, rb.conv3x3_stats_bwd_plain(*ops, y, gy, gstats, act))


def test_conv3x3_stats_bwd_kernel_is_deterministic():
    gen = torch.Generator("cuda").manual_seed(5)
    ops = _conv_case(gen, (2, 64, 64, 256), 256, "proj")
    y, _ = rb.conv3x3_stats_cuda(*ops, "silu")
    gy, gstats = _randn(gen, y.shape), 0.1 * torch.randn((2, 2, 256), generator=gen, device="cuda")
    first = rb.conv3x3_stats_bwd_cuda(*ops, y, gy, gstats, "silu")
    second = rb.conv3x3_stats_bwd_cuda(*ops, y, gy, gstats, "silu")
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("shape,n", [((1, 36, 24, 256), 256), ((2, 9, 13, 64), 128), ((4, 64, 64, 128), 128),
                                     ((2, 37, 50, 72), 136), ((4, 128, 128, 512), 512)])
def test_upsample_bwd_kernel(shape, n):
    gen = torch.Generator("cuda").manual_seed(6)
    x = _randn(gen, shape)
    wt = _randn(gen, (3, 3, shape[3], n), 1.0 / math.sqrt(9 * shape[3]))
    bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
    y, _ = rb.upsample_conv3x3_stats_cuda(x, wt, bias)
    gy = _randn(gen, y.shape)
    gstats = 0.1 * torch.randn((shape[0], 2, n), generator=gen, device="cuda")
    before = rb.UPSAMPLE_BWD_LAUNCHES
    got = rb.upsample_conv3x3_stats_bwd_cuda(x, wt, bias, y, gy, gstats)
    assert rb.UPSAMPLE_BWD_LAUNCHES == before + 1
    _check_cotangents(got, rb.upsample_conv3x3_stats_bwd_plain(x, wt, bias, y, gy, gstats))


@pytest.mark.parametrize("kernel", ["K2", "K7"])
@pytest.mark.parametrize("shape,n", [((2, 37, 50, 72), 136), ((2, 64, 64, 256), 256)])
def test_upsample_kernels_are_deterministic(kernel, shape, n):
    """K2 and K7 bit for bit over two calls: every partial has one owner and
    is summed in a fixed order (no float atomics)."""
    gen = torch.Generator("cuda").manual_seed(7)
    x = _randn(gen, shape)
    wt = _randn(gen, (3, 3, shape[3], n), 1.0 / math.sqrt(9 * shape[3]))
    bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
    if kernel == "K2":
        run = lambda: rb.upsample_conv3x3_stats_cuda(x, wt, bias)
    else:
        y, _ = rb.upsample_conv3x3_stats_cuda(x, wt, bias)
        gy = _randn(gen, y.shape)
        gstats = 0.1 * torch.randn((shape[0], 2, n), generator=gen, device="cuda")
        run = lambda: rb.upsample_conv3x3_stats_bwd_cuda(x, wt, bias, y, gy, gstats)
    first, second = run(), run()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_functions_carry_the_graph_and_differentiate_like_the_plain_route():
    """A block and an upsample chained through their statistics, fp32 leaves
    under bf16 compute: the outputs carry a grad_fn, the backward launches K6
    and K7, fp32 weights receive fp32 cotangents, and every leaf's gradient
    agrees with the same chain through the plain versions (4e-2 of its
    largest entry: two bf16 roundings per conv on either route)."""
    gen = torch.Generator("cuda").manual_seed(7)
    c = 64
    leaves = {
        "x": torch.randn((2, 12, 20, c), generator=gen, device="cuda"),
        "scale": 1.0 + 0.1 * torch.randn((c,), generator=gen, device="cuda"),
        "shift": 0.1 * torch.randn((c,), generator=gen, device="cuda"),
        "w1": torch.randn((3, 3, c, c), generator=gen, device="cuda") / math.sqrt(9 * c),
        "b1": 0.1 * torch.randn((c,), generator=gen, device="cuda"),
        "w2": torch.randn((3, 3, c, c), generator=gen, device="cuda") / math.sqrt(9 * c),
        "b2": 0.1 * torch.randn((c,), generator=gen, device="cuda"),
    }

    def chain(conv, upsample):
        p = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
        x = p["x"].to(torch.bfloat16)
        a, b = rb.stats_to_coeffs(rb.tensor_stats(x), p["scale"], p["shift"], 4, 12 * 20)
        y, stats = conv(x, a, b, p["w1"], p["b1"], x)
        a2, b2 = rb.stats_to_coeffs(stats, p["scale"], p["shift"], 4, 12 * 20)
        y2 = (y.float() * a2[:, None, None, :] + b2[:, None, None, :]).to(torch.bfloat16)
        out, stats2 = upsample(y2, p["w2"], p["b2"])
        assert out.grad_fn is not None and stats2.grad_fn is not None
        (out.float().square().mean() + 1e-4 * stats2.mean()).backward()
        return p

    counts = (rb.CONV_BWD_LAUNCHES, rb.UPSAMPLE_BWD_LAUNCHES)
    got = chain(rb.gn_silu_conv3x3_stats, rb.fused_upsample_conv3x3_stats)
    assert (rb.CONV_BWD_LAUNCHES, rb.UPSAMPLE_BWD_LAUNCHES) == (counts[0] + 1, counts[1] + 1)

    def plain_conv(x, a, b, w, bias, skip):
        return rb.conv3x3_stats_plain(x, a, b, w, bias, skip)

    want = chain(plain_conv, rb.upsample_conv3x3_stats_plain)
    for name in leaves:
        g, r = got[name].grad, want[name].grad
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        assert (g - r).abs().max() <= 4e-2 * r.abs().max(), name


def test_attention_with_a_gradient_on_the_card():
    """A gradient flows on every route: d = 512 (the VAE mid-block) through the
    recompute, d = 128 (the FLUX blocks) through K3 forward and K4 + K5
    backward, one launch each; the results agree with native autograd through
    the plain version."""
    gen = torch.Generator("cuda").manual_seed(8)
    for d, seq in ((512, 300), (128, 333)):
        q, k, v = (_randn(gen, (1, 2, seq, d)).requires_grad_(True) for _ in range(3))
        before = (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
        out = fa.attention(q, k, v)
        assert out.grad_fn is not None
        out.float().square().sum().backward()
        fused = int(d == 128)
        assert (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES) == (before[0] + 1, before[1] + fused, before[2] + fused)
        q2, k2, v2 = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        fa.attention_plain(q2[0], k2[0], v2[0], sm_scale=d ** -0.5).float().square().sum().backward()
        for a, b in ((q, q2), (k, k2), (v, v2)):
            assert (a.grad.float() - b.grad.float()).abs().max() <= 5e-2 * b.grad.float().abs().max()


def _bwd_case(gen, bh, sq, sk):
    q, g = _randn(gen, (bh, sq, 128)), _randn(gen, (bh, sq, 128))
    k, v = _randn(gen, (bh, sk, 128)), _randn(gen, (bh, sk, 128))
    out, lse = fa.flash_attention_cuda(q, k, v, sm_scale=128 ** -0.5)
    return q, k, v, out, lse, g


@pytest.mark.parametrize("bh,sq,sk", [
    (4, 77, 200), (4, 200, 77), (6, 300, 300), (24, 1111, 1111), (2, 5, 3),
    (3, 1, 200),        # one query: K5's only query tile and K4's second warpgroup are past Sq
    (2, 129, 257),      # a tail of one row in both: K4's second query block, K5's third key block
    (1, 4099, 4097),    # long and ragged: 65 K4 key tiles and 65 K5 query tiles wrap the 4-stage rings
])
def test_flash_attention_bwd_kernels(bh, sq, sk):
    """K4 and K5 at ragged lengths and Sq != Sk against the plain version."""
    gen = torch.Generator("cuda").manual_seed(9)
    q, k, v, out, lse, g = _bwd_case(gen, bh, sq, sk)
    before = (fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, sm_scale=128 ** -0.5)
    assert (fa.DQ_LAUNCHES, fa.DKV_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = fa.attention_bwd_plain(q, k, v, out, lse, g, sm_scale=128 ** -0.5)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.bfloat16 and bool(torch.isfinite(a.float()).all())
        assert (a.float() - b.float()).abs().max() <= 5e-2 * b.float().abs().max()


def test_flash_attention_bwd_kernels_with_one_key():
    """Sk = 1: K4's only key tile and K5's second warpgroup lie past Sk. The
    softmax over one key is 1 whatever its logit, so dQ and dK are exactly 0
    (dP = dO . v_0 = delta): the plain version's dQ and dK are its bf16
    rounding of dP - delta (~1e-2), not a reference. The kernels' dQ and dK
    must be 0 up to fp32 summation order, far below that rounding, and dV
    (the sum of dO over the queries) must match the plain version."""
    gen = torch.Generator("cuda").manual_seed(9)
    q, k, v, out, lse, g = _bwd_case(gen, 3, 200, 1)
    dq, dk, dv = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, sm_scale=128 ** -0.5)
    want = fa.attention_bwd_plain(q, k, v, out, lse, g, sm_scale=128 ** -0.5)[2].float()
    assert all(bool(torch.isfinite(t.float()).all()) for t in (dq, dk, dv))
    assert (dv.float() - want).abs().max() <= 5e-2 * want.abs().max()
    assert dq.float().abs().max() <= 2e-4 * want.abs().max()
    assert dk.float().abs().max() <= 2e-4 * want.abs().max()


@pytest.mark.parametrize("bh,seq", [(24, 2600), (48, 2560)])
def test_flash_attention_bwd_kernels_are_deterministic(bh, seq):
    """Every accumulator has one owner (no float atomics): two runs agree bit
    for bit, at a ragged length and at the 512^2 LoRA micro-batch's shape."""
    gen = torch.Generator("cuda").manual_seed(10)
    case = _bwd_case(gen, bh, seq, seq)
    first = fa.flash_attention_bwd_cuda(*case, sm_scale=128 ** -0.5)
    second = fa.flash_attention_bwd_cuda(*case, sm_scale=128 ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_attention_bwd_refuses_other_head_dims_and_types():
    gen = torch.Generator("cuda").manual_seed(11)
    q = _randn(gen, (1, 2, 64, 64)).requires_grad_(True)   # head dim 64: no forward kernel either
    with pytest.raises(ValueError, match="head dim"):
        fa.attention(q, q, q)
    t64 = _randn(gen, (2, 64, 64))
    lse = torch.zeros((2, 64), device="cuda")
    with pytest.raises(ValueError, match="head dim 64"):
        fa.flash_attention_dq_cuda(t64, t64, t64, t64, lse, lse, sm_scale=1.0)
    with pytest.raises(ValueError, match="head dim 64"):
        fa.flash_attention_dkv_cuda(t64, t64, t64, t64, lse, lse, sm_scale=1.0)
    t128 = _randn(gen, (2, 64, 128))
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_dq_cuda(t128.float(), t128, t128, t128, lse, lse, sm_scale=1.0)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_dkv_cuda(t128, t128, t128, t128, lse[:, :10], lse, sm_scale=1.0)


# ---------------------------------------------------------------------------
# K9, K10, K11, K12: ragged shapes, refusals, bitwise reproducibility
# ---------------------------------------------------------------------------
def _int8_case(gen, m, k, n, dtype):
    x = (torch.randn((m, k), generator=gen, device="cuda")).to(dtype)
    wq = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    scale = (3.0 / math.sqrt(k) / 127.0) * (0.5 + torch.rand((n,), generator=gen, device="cuda"))
    bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
    return x, wq, scale, bias


@pytest.mark.parametrize("m,k,n,dtype", [
    (300, 64, 3072, torch.bfloat16),        # x_embedder's K, a ragged M tile
    (1001, 80, 136, torch.bfloat16),        # every tile edge ragged
    (9, 3072, 64, torch.bfloat16),          # proj_out's N, just above the skinny kernel's rows
    (8, 256, 3072, torch.bfloat16),         # the skinny kernel in bf16
    (3, 3072, 1024, torch.float32),         # the fp32 modulation
    (13, 48, 24, torch.float32),            # fp32 past the skinny kernel's row block
    (512, 3088, 200, torch.bfloat16),       # the text stream's M, K past the 64-k stage, N past the 128 tile
    (9, 1040, 200, torch.bfloat16),         # just above the skinny rows, K and N ragged
    (2560, 3072, 3072, torch.bfloat16),     # the 256-token tile (a single block's stream at 512^2)
    (5, 4112, 72, torch.bfloat16),          # skinny: five x chunks of 1024, the last ragged; N past a block's 32
    (20, 2064, 40, torch.float32),          # fp32 in three row blocks of 8 and three x chunks
    (40, 16, 8, torch.bfloat16),            # the least K and N: one k-step, one box of 64 channels clipped to 8
])
def test_int8_matmul_kernel(m, k, n, dtype):
    from ragb_vae_tpu_torch.ops.kernels import int8_matmul as i8

    gen = torch.Generator("cuda").manual_seed(20)
    x, wq, scale, bias = _int8_case(gen, m, k, n, dtype)
    before = i8.LAUNCHES
    out = i8.int8_matmul(x[None], wq, scale, bias)[0]      # a leading dim folds into M
    assert i8.LAUNCHES == before + 1 and out.shape == (m, n) and out.dtype == dtype
    exact = (x.float() @ wq.float().t() * scale + bias).to(dtype).float()
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4      # one bf16 ulp / an fp32 sum's order
    assert (out.float() - exact).abs().max() <= tol * exact.abs().max()
    no_bias = i8.int8_matmul(x, wq, scale, None)
    exact = (x.float() @ wq.float().t() * scale).to(dtype).float()
    assert (no_bias.float() - exact).abs().max() <= tol * exact.abs().max()
    again = i8.int8_matmul(x, wq, scale, None)
    assert torch.equal(no_bias, again)                    # one block per output tile, no atomics


def test_int8_matmul_gradient_reaches_x_on_the_card():
    from ragb_vae_tpu_torch.ops.kernels import int8_matmul as i8

    gen = torch.Generator("cuda").manual_seed(21)
    x, wq, scale, bias = _int8_case(gen, 40, 64, 48, torch.bfloat16)
    x.requires_grad_(True)
    g = torch.randn((40, 48), generator=gen, device="cuda").to(torch.bfloat16)
    i8.int8_matmul(x, wq, scale, bias).backward(g)
    want = (g.float() * scale) @ wq.float()
    assert (x.grad.float() - want).abs().max() <= 2e-2 * want.abs().max()


def test_int8_matmul_refuses_what_the_kernel_does_not_take():
    from ragb_vae_tpu_torch.ops.kernels import int8_matmul as i8

    ok = torch.zeros((4, 32), device="cuda", dtype=torch.bfloat16)
    wq = torch.zeros((16, 32), device="cuda", dtype=torch.int8)
    scale = torch.ones(16, device="cuda")
    with pytest.raises(ValueError, match="multiple of 16"):
        i8.int8_matmul(ok[:, :24], wq[:, :24].contiguous(), scale, None)
    with pytest.raises(ValueError, match="multiple of 16"):
        i8.int8_matmul(ok, wq[:12], scale[:12], None)       # N % 8
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        i8.int8_matmul(ok.half(), wq, scale, None)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        i8.int8_matmul(ok, wq, scale.cpu(), None)


@pytest.mark.parametrize("shape,n", [((2, 37, 50, 64), 96), ((1, 64, 48, 128), 128), ((3, 18, 14, 16), 24),
                                     ((1, 64, 95, 128), 200)])
def test_downsample_kernel(shape, n):
    gen = torch.Generator("cuda").manual_seed(22)
    x = _randn(gen, shape)
    wt = _randn(gen, (3, 3, shape[3], n), 1.0 / math.sqrt(9 * shape[3]))
    bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
    before = rb.DOWNSAMPLE_LAUNCHES
    y, s = rb.fused_downsample_conv3x3_stats(x, wt, bias)
    assert rb.DOWNSAMPLE_LAUNCHES == before + 1
    assert y.shape == (shape[0], shape[1] // 2, shape[2] // 2, n)
    _check_conv(y, s, *rb.downsample_conv3x3_stats_plain(x, wt, bias))
    y2, s2 = rb.fused_downsample_conv3x3_stats(x, wt, bias)
    assert torch.equal(y, y2) and torch.equal(s, s2)
    # the backward differentiates the plain version, the statistics' cotangent included
    x.requires_grad_(True)
    y, s = rb.fused_downsample_conv3x3_stats(x, wt, bias)
    (y.float().sum() + 0.1 * s.sum()).backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad.float()).all())


@pytest.mark.parametrize("shape,n", [((1, 19, 27, 64), 40), ((2, 36, 24, 128), 128), ((2, 33, 70, 72), 136)])
def test_conv3x3_same_and_fused_gn_silu_conv_kernels(shape, n):
    from ragb_vae_tpu_torch.ops.kernels import conv3x3 as c3
    from ragb_vae_tpu_torch.ops.kernels import fused_gn_silu_conv as fgc

    gen = torch.Generator("cuda").manual_seed(23)
    bsz, _, _, c = shape
    x = _randn(gen, shape)
    wt = _randn(gen, (3, 3, c, n), 1.0 / math.sqrt(9 * c))
    bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
    a = 1.0 + 0.1 * torch.randn((bsz, c), generator=gen, device="cuda")
    b = 0.1 * torch.randn((bsz, c), generator=gen, device="cuda")
    counts = (c3.LAUNCHES, fgc.LAUNCHES)
    y = c3.conv3x3_same_batched(x, wt)
    ref = c3.conv3x3_same_plain(x, wt).float()
    assert (y.float() - ref).abs().max() <= 3e-2 * ref.abs().max()
    assert torch.equal(y, c3.conv3x3_same_batched(x, wt))
    assert torch.equal(y[0], c3.conv3x3_same(x[0], wt))                   # the unbatched entry point
    z = fgc.fused_gn_silu_conv3x3_batched(x, a, b, wt, bias)
    ref = fgc.fused_gn_silu_conv3x3_plain(x, a, b, wt, bias).float()
    assert (z.float() - ref).abs().max() <= 3e-2 * ref.abs().max()
    assert torch.equal(z, fgc.fused_gn_silu_conv3x3_batched(x, a, b, wt, bias))
    assert (c3.LAUNCHES, fgc.LAUNCHES) == (counts[0] + 3, counts[1] + 2)


def _own_stats(y):
    yd = y.double()
    return torch.stack([yd.sum(dim=(1, 2)), yd.square().sum(dim=(1, 2))], dim=1)


# K9 and K11 on the Hopper conv engine at ragged shapes: y against the exact
# fp32 conv of the same bf16 inputs rounded once (one bf16 ulp of the largest
# value), K9's statistics against fp64 sums of its own rounded y (fp32
# summation order: 1e-4 of H*W*mean(y^2)), both bit for bit over two calls
@pytest.mark.parametrize("shape,n", [((2, 33, 70, 72), 136), ((1, 19, 27, 64), 40), ((3, 18, 14, 16), 24),
                                     ((1, 9, 130, 200), 64)])
def test_conv3x3_same_kernel_against_exact(shape, n):
    from ragb_vae_tpu_torch.ops.kernels import conv3x3 as c3

    gen = torch.Generator("cuda").manual_seed(24)
    x = _randn(gen, shape)
    wt = _randn(gen, (3, 3, shape[3], n), 1.0 / math.sqrt(9 * shape[3]))
    y = c3.conv3x3_same_batched(x, wt)
    exact = torch.nn.functional.conv2d(x.float().permute(0, 3, 1, 2), wt.float().permute(3, 2, 0, 1), padding=1)
    exact = exact.permute(0, 2, 3, 1)
    assert y.shape == (*shape[:3], n)
    assert (y.float() - exact).abs().max() <= 1e-2 * exact.abs().max()
    assert torch.equal(y, c3.conv3x3_same_batched(x, wt))


def _guarded(t):
    """t (B, C) fp32 in memory followed by 64 NaN: the kernel reads t, not past it."""
    flat = torch.full((t.numel() + 64,), float("nan"), device=t.device)
    flat[: t.numel()] = t.reshape(-1)
    return flat[: t.numel()].view(t.shape)


# K1 on the conv engine at ragged shapes against its exact arithmetic (the
# activation x*a + b rounded to bf16, fp32 sums of its products, bias and
# skip in fp32, one rounding): one bf16 ulp of the largest value; the
# statistics against fp64 sums of its own rounded y (fp32 summation order:
# 1e-4 of H*W*mean(y^2)); bit for bit over two calls. a and b are followed in
# memory by NaN, so a coefficient read past channel C poisons y.
@pytest.mark.parametrize("shape,n,skip,act", [
    ((2, 37, 50, 72), 136, 40, "silu"),              # C, Cs, N, H, W all ragged; a 1x1 projection
    ((1, 19, 33, 64), 64, "identity", "identity"),
    ((2, 9, 130, 200), 64, None, "silu"),            # C = 200: a partial fourth chunk
])
def test_conv3x3_stats_kernel_against_exact(shape, n, skip, act):
    gen = torch.Generator("cuda").manual_seed(26)
    bsz, h, w, c = shape
    x = _randn(gen, shape)
    a = _guarded(1.0 + 0.1 * torch.randn((bsz, c), generator=gen, device="cuda"))
    b = _guarded(0.1 * torch.randn((bsz, c), generator=gen, device="cuda"))
    wt = _randn(gen, (3, 3, c, n), 1.0 / math.sqrt(9 * c))
    bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
    sk = ws = wsb = None
    if skip == "identity":
        sk = _randn(gen, (bsz, h, w, n))
    elif skip is not None:
        sk, ws = _randn(gen, (bsz, h, w, skip)), _randn(gen, (skip, n), skip ** -0.5)
        wsb = 0.1 * torch.randn((n,), generator=gen, device="cuda")
    y, s = rb.conv3x3_stats_cuda(x, a, b, wt, bias, sk, ws, wsb, act)
    t = x.float() * a[:, None, None, :] + b[:, None, None, :]
    t = (torch.nn.functional.silu(t) if act == "silu" else t).to(torch.bfloat16).float()
    exact = torch.nn.functional.conv2d(t.permute(0, 3, 1, 2), wt.float().permute(3, 2, 0, 1), padding=1)
    exact = exact.permute(0, 2, 3, 1) + bias
    if ws is not None:
        exact = exact + sk.float() @ ws.float() + wsb
    elif sk is not None:
        exact = exact + sk.float()
    assert y.shape == (bsz, h, w, n) and bool(torch.isfinite(y.float()).all())
    assert (y.float() - exact).abs().max() <= 1e-2 * exact.abs().max()
    norm = h * w * y.float().square().mean()
    assert (s.double() - _own_stats(y)).abs().max() <= 1e-4 * norm
    y2, s2 = rb.conv3x3_stats_cuda(x, a, b, wt, bias, sk, ws, wsb, act)
    assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.parametrize("shape,n", [((2, 37, 50, 64), 96), ((1, 64, 95, 128), 200), ((1, 2, 2, 8), 8),
                                     ((2, 20, 131, 72), 136)])
def test_downsample_kernel_against_exact(shape, n):
    gen = torch.Generator("cuda").manual_seed(25)
    x = _randn(gen, shape)
    wt = _randn(gen, (3, 3, shape[3], n), 1.0 / math.sqrt(9 * shape[3]))
    bias = 0.1 * torch.randn((n,), generator=gen, device="cuda")
    y, s = rb.downsample_conv3x3_stats_cuda(x, wt, bias)
    xp = torch.nn.functional.pad(x.float().permute(0, 3, 1, 2), (0, 1, 0, 1))
    exact = torch.nn.functional.conv2d(xp, wt.float().permute(3, 2, 0, 1), stride=2).permute(0, 2, 3, 1) + bias
    assert y.shape == (shape[0], shape[1] // 2, shape[2] // 2, n)
    assert (y.float() - exact).abs().max() <= 1e-2 * exact.abs().max()
    norm = y.shape[1] * y.shape[2] * y.float().square().mean()
    assert (s.double() - _own_stats(y)).abs().max() <= 1e-4 * norm
    y2, s2 = rb.downsample_conv3x3_stats_cuda(x, wt, bias)
    assert torch.equal(y, y2) and torch.equal(s, s2)


def test_engine_wrappers_refuse_n_not_a_multiple_of_8_and_cpu_tensors():
    from ragb_vae_tpu_torch.ops.kernels import conv3x3 as c3

    x = torch.zeros((1, 8, 8, 16), device="cuda", dtype=torch.bfloat16)
    w = torch.zeros((3, 3, 16, 12), device="cuda", dtype=torch.bfloat16)      # N % 8 != 0
    bias = torch.zeros(12, device="cuda")
    with pytest.raises(ValueError, match="multiples of 8"):
        c3.conv3x3_same_cuda(x, w)
    with pytest.raises(ValueError, match="multiples of 8"):
        rb.downsample_conv3x3_stats_cuda(x, w, bias)
    w16 = torch.zeros((3, 3, 16, 16), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        c3.conv3x3_same_cuda(x.cpu(), w16.cpu())
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        c3.conv3x3_same_cuda(x, w16.cpu())
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        rb.downsample_conv3x3_stats_cuda(x, w16, torch.zeros(16))


def test_new_conv_wrappers_refuse_what_the_kernels_do_not_take():
    from ragb_vae_tpu_torch.ops.kernels import conv3x3 as c3
    from ragb_vae_tpu_torch.ops.kernels import fused_gn_silu_conv as fgc

    x = torch.zeros((1, 8, 8, 12), device="cuda", dtype=torch.bfloat16)  # C % 8 != 0
    w = torch.zeros((3, 3, 12, 16), device="cuda", dtype=torch.bfloat16)
    ones, bias = torch.ones((1, 12), device="cuda"), torch.zeros(16, device="cuda")
    for call in (lambda: c3.conv3x3_same_batched(x, w),
                 lambda: fgc.fused_gn_silu_conv3x3_batched(x, ones, ones, w, bias),
                 lambda: rb.fused_downsample_conv3x3_stats(x, w, bias)):
        with pytest.raises(ValueError, match="multiples of 8"):
            call()
    x32 = torch.zeros((1, 8, 8, 16), device="cuda")                        # fp32
    w32 = torch.zeros((3, 3, 16, 16), device="cuda")
    with pytest.raises(ValueError, match="must be torch.bfloat16"):
        c3.conv3x3_same_batched(x32, w32)
    with pytest.raises(ValueError, match="at least 2 x 2"):
        rb.fused_downsample_conv3x3_stats(x[:, :1, :, :8].contiguous(), w[:, :, :8].contiguous(), bias)


# K8: the Winograd conv against its plain version, which rounds V, U and y
# where the kernel does (one bf16 ulp of the largest y, fp32 sum order in the
# statistics), at ragged tiles and odd channel counts the kernel takes (H and W
# even, C and N multiples of 8) besides the aligned shapes the route sends it
@pytest.mark.parametrize("shape,n,skip,act", [
    ((1, 36, 24, 128), 128, None, "silu"),           # ragged 8 x 32 tiles
    ((2, 18, 48, 256), 128, "proj", "silu"),
    ((1, 10, 14, 64), 40, "identity", "identity"),   # N short of the 64-channel tile
    ((2, 16, 32, 128), 256, "proj", "identity"),
    # every edge ragged: C and Cs not multiples of the 64-channel chunk, N
    # past one 64-channel tile, H and W off the 8 x 32 tile
    ((2, 22, 70, 72), 136, "proj40", "silu"),
])
def test_wino_conv3x3_stats_kernel(shape, n, skip, act):
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
    elif skip is not None:
        sk = x if skip == "proj" else _randn(gen, (bsz, h, w, int(skip[4:])))
        ws = _randn(gen, (sk.shape[3], n), 1.0 / math.sqrt(sk.shape[3]))
        wsb = 0.1 * torch.randn((n,), generator=gen, device="cuda")
    args = (x, a, b, wt, bias, sk, ws, wsb, act)
    rb.reset_launch_counts()
    y, s = rb.wino_conv3x3_stats_cuda(*args)
    y_p, s_p = rb.wino_conv3x3_stats_plain(*args)
    torch.cuda.synchronize()
    assert rb.WINO_LAUNCHES == 1 and rb.CONV_LAUNCHES == 0
    rf = y_p.float()
    assert (y.float() - rf).abs().max() <= 1e-2 * rf.abs().max()
    # over the whole tensor, y differs from the plain version only where the
    # order of fp32 sums flips a rounding
    assert (y.float() - rf).norm() <= 3e-4 * rf.norm()
    # the statistics against the plain version's, allowed beside the sums'
    # own order what those flips of y move them by (each channel's sum of
    # |y - y_p| and of |y^2 - y_p^2|): a lost tile or partial still fails
    yd, pd = y.double(), y_p.double()
    flips = torch.stack([(yd - pd).abs().sum(dim=(1, 2)), (yd.square() - pd.square()).abs().sum(dim=(1, 2))], dim=1)
    assert ((s.double() - s_p.double()).abs() <= 1e-4 * h * w * rf.square().mean() + flips).all()
    # and against fp64 sums of the kernel's own y
    own = torch.stack([yd.sum(dim=(1, 2)), yd.square().sum(dim=(1, 2))], dim=1)
    assert (s.double() - own).abs().max() <= 1e-4 * h * w * rf.square().mean()
    y2, s2 = rb.wino_conv3x3_stats_cuda(*args)
    assert torch.equal(y, y2) and torch.equal(s, s2)     # bitwise reproducible
    y3, s3 = rb.wino_conv3x3_stats_cuda(*args, u=rb.wino_tiles(wt, torch.bfloat16))
    assert torch.equal(y, y3) and torch.equal(s, s3)     # the cached tiles are the given ones


def test_wino_tiles_are_folded_once_per_weight_version(monkeypatch):
    """A fused ResnetBlock on the Winograd route passes K8 the tiles it keeps
    per weight, under autograd too (two calls, one fold, the same y), and an
    in-place step folds them again."""
    from ragb_vae_tpu_torch.models.vae import ResnetBlock

    monkeypatch.setattr(rb, "CONV_ALGO", "winograd")
    torch.manual_seed(2)
    block = ResnetBlock(128, 128, num_groups=32, fused=True).cuda()      # the route's widths: multiples of 128
    block.compute_dtype = torch.bfloat16
    x = torch.randn((1, 8, 32, 128), device="cuda").to(torch.bfloat16)
    rb.reset_launch_counts()
    y, _ = block(x)
    first = block.__dict__["_derived_cache"]["conv1.u"][1]
    hwio = lambda: block.conv1.weight.detach().permute(2, 3, 1, 0).to(torch.bfloat16)
    assert torch.equal(first, rb.wino_tiles(hwio()))
    assert rb.WINO_LAUNCHES == 2 and block(x)[0].equal(y)
    assert block.__dict__["_derived_cache"]["conv1.u"][1] is first
    with torch.no_grad():
        block.conv1.weight.mul_(2.0)
    block(x)
    again = block.__dict__["_derived_cache"]["conv1.u"][1]
    assert again is not first and torch.equal(again, rb.wino_tiles(hwio()))


# K6's dskip alone (the conv engine's one-tap mode) against the exact fp32
# dye @ ws^T rounded once: one bf16 ulp of the largest value; Cs ragged
# against the 128-channel tile and N against the 64-channel chunk
@pytest.mark.parametrize("shape,c_skip", [((2, 37, 50, 136), 40), ((1, 16, 64, 256), 200), ((4, 64, 64, 256), 512)])
def test_skip_grad_kernel_against_exact(shape, c_skip):
    gen = torch.Generator("cuda").manual_seed(3)
    dye = _randn(gen, shape)
    ws = _randn(gen, (c_skip, shape[3]), 1.0 / math.sqrt(shape[3]))
    rb.reset_launch_counts()
    got = rb.skip_grad_cuda(dye, ws)
    want = rb.skip_grad_plain(dye, ws)                 # the fp32 product rounded once
    torch.cuda.synchronize()
    assert rb.SKIP_GRAD_LAUNCHES == 1 and got.shape == shape[:3] + (c_skip,)
    assert (got.float() - want.float()).abs().max() <= 1e-2 * want.float().abs().max()


def test_winograd_route_launches_k8_and_differentiates_through_k6(monkeypatch):
    monkeypatch.setattr(rb, "CONV_ALGO", "winograd")
    gen = torch.Generator("cuda").manual_seed(1)
    x = _randn(gen, (2, 8, 32, 128)).requires_grad_(True)
    a, b = torch.ones((2, 128), device="cuda"), torch.zeros((2, 128), device="cuda")
    wt = (torch.randn((3, 3, 128, 128), generator=gen, device="cuda") / 34.0).requires_grad_(True)
    bias = torch.zeros(128, device="cuda", requires_grad=True)
    rb.reset_launch_counts()
    y, s = rb.gn_silu_conv3x3_stats(x, a, b, wt, bias)
    (y.float().square().sum() + s.sum()).backward()
    torch.cuda.synchronize()
    assert (rb.WINO_LAUNCHES, rb.CONV_LAUNCHES, rb.CONV_BWD_LAUNCHES) == (1, 0, 1)
    assert torch.isfinite(x.grad.float()).all() and wt.grad.dtype == torch.float32
    rb.gn_silu_conv3x3_stats(x[:, :, :24], a, b, wt, bias)    # W % 16 != 0: the direct route
    assert (rb.WINO_LAUNCHES, rb.CONV_LAUNCHES) == (1, 1)


def test_wino_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((1, 5, 16, 128), dtype=torch.bfloat16, device="cuda")
    a, b = torch.ones((1, 128), device="cuda"), torch.zeros((1, 128), device="cuda")
    wt, bias = torch.zeros((3, 3, 128, 128), dtype=torch.bfloat16, device="cuda"), torch.zeros(128, device="cuda")
    with pytest.raises(ValueError, match="even"):
        rb.wino_conv3x3_stats_cuda(x, a, b, wt, bias)
    with pytest.raises(ValueError, match="multiples of 8"):
        rb.wino_conv3x3_stats_cuda(x[:, :4, :, :124], a[:, :124], b[:, :124], wt[:, :, :124], bias)
