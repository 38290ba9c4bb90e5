"""The three stand-alone VAE convs of the port against the JAX package: the
bare conv3x3 (`conv3x3.py`), the fused GN-apply + SiLU + conv3x3
(`fused_gn_silu_conv.py`) and the stride-2 downsample conv with statistics
(`resnet_block.py`), and the `Conv3x3` and `Downsample(fused=True)` modules.

On the CPU the port takes each kernel's plain version. It is held against the
Pallas kernel in interpret mode (at a shape the JAX entry point routes to it)
and against the XLA reference (at a ragged shape), fp32 on both sides: nine
taps of products summed in another order, 1e-4. Statistics are sums over the
image of values of order 1: 1e-4 relative to their largest entry. Gradients,
the statistics' cotangent included, differentiate the XLA reference on the JAX
side and the plain version here: 1e-4 relative to the largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ragb_vae_tpu.ops.pallas.conv3x3 as jc3
import ragb_vae_tpu.ops.pallas.fused_gn_silu_conv as jfg
import ragb_vae_tpu.ops.pallas.resnet_block as jrb
from ragb_vae_tpu.models import vae as jvae
from ragb_vae_tpu_torch.models import vae as tvae
from ragb_vae_tpu_torch.ops.kernels import conv3x3 as tc3
from ragb_vae_tpu_torch.ops.kernels import fused_gn_silu_conv as tfg
from ragb_vae_tpu_torch.ops.kernels import resnet_block as trb

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: tiny tensors gain
    nothing from intra-op threads, and the workers stop fighting for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _interpret():
    jc3.INTERPRET = jfg.INTERPRET = jrb.INTERPRET = True
    yield
    jc3.INTERPRET = jfg.INTERPRET = jrb.INTERPRET = False


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL, atol=TOL * max(1.0, np.abs(want).max()),
                               err_msg=name)


def _conv_inputs(seed, shape, n):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, n)) / np.sqrt(9 * c)).astype(np.float32)
    bias = (rng.standard_normal(n) * 0.1).astype(np.float32)
    a = (rng.standard_normal(c) * 0.5 + 1.0).astype(np.float32)
    b = (rng.standard_normal(c) * 0.2).astype(np.float32)
    return x, w, bias, a, b


# ---------------------------------------------------------------------------
# K11: bare conv3x3
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,n,pallas", [((16, 128, 128), 128, True), ((10, 12, 8), 16, False)],
                         ids=["pallas", "ragged-xla"])
def test_conv3x3_same_matches_jax(shape, n, pallas):
    x, w, *_ = _conv_inputs(0, shape, n)
    want = jc3.conv3x3_same(jnp.asarray(x), jnp.asarray(w))
    got = tc3.conv3x3_same(_t(x), _t(w))
    assert got.shape == (*shape[:2], n)
    _close(got, want)
    _close(got, jc3._xla_conv(jnp.asarray(x), jnp.asarray(w)))
    assert tc3.LAUNCHES == 0


def test_conv3x3_same_batched_and_gradients_match_jax():
    x, w, *_ = _conv_inputs(1, (3, 6, 10, 8), 16)
    want = jc3.conv3x3_same_batched(jnp.asarray(x), jnp.asarray(w))
    loss = lambda x_, w_: jnp.sum(jc3.conv3x3_same_batched(x_, w_) ** 2)
    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    got = tc3.conv3x3_same_batched(tx, tw)
    got.square().sum().backward()
    _close(got, want)
    _close(tx.grad, gx, "dx")
    _close(tw.grad, gw, "dw")
    with pytest.raises(ValueError, match=r"must be \(H, W, C\)"):
        tc3.conv3x3_same(tx, tw)


def test_conv3x3_module_matches_the_jax_module():
    x, w, bias, *_ = _conv_inputs(2, (2, 8, 16, 8), 24)
    want = jvae.Conv3x3(24).apply({"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(bias)}}, jnp.asarray(x))
    module = tvae.Conv3x3(8, 24)
    module.load_state_dict({"conv.weight": _t(w).permute(3, 2, 0, 1).contiguous(), "conv.bias": _t(bias)})
    with torch.no_grad():
        _close(module(_t(x)), want)


# ---------------------------------------------------------------------------
# K12: GN-apply + SiLU + conv3x3 + bias
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,n,pallas", [((16, 128, 128), 128, True), ((10, 12, 8), 16, False)],
                         ids=["pallas", "ragged-xla"])
def test_fused_gn_silu_conv_matches_jax(shape, n, pallas):
    x, w, bias, a, b = _conv_inputs(3, shape, n)
    jargs = [jnp.asarray(v) for v in (x, a, b, w, bias)]
    want = jfg.fused_gn_silu_conv3x3(*jargs, tile_h=8) if pallas else jfg.fused_gn_silu_conv3x3(*jargs)
    got = tfg.fused_gn_silu_conv3x3(*(_t(v) for v in (x, a, b, w, bias)))
    _close(got, want)
    _close(got, jfg._xla_ref(*jargs))
    assert tfg.LAUNCHES == 0


def test_fused_gn_silu_conv_batched_coeffs_and_gradients_match_jax():
    """Per-sample (B, C) coefficients from `group_norm_coeffs`, and every
    cotangent (x, a, b, w, bias) against jax.grad."""
    x, w, bias, *_ = _conv_inputs(4, (2, 6, 8, 16), 8)
    rng = np.random.default_rng(5)
    scale, shift = (rng.standard_normal(16).astype(np.float32) * 0.3 + 1.0,
                    rng.standard_normal(16).astype(np.float32) * 0.1)
    ja, jb = jfg.group_norm_coeffs(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift), 4)
    ta, tb = tfg.group_norm_coeffs(_t(x), _t(scale), _t(shift), 4)
    _close(ta, ja, "a")
    _close(tb, jb, "b")
    jargs = [jnp.asarray(x), ja, jb, jnp.asarray(w), jnp.asarray(bias)]
    loss = lambda *args: jnp.sum(jfg.fused_gn_silu_conv3x3_batched(*args) ** 2)
    want_grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*jargs)
    targs = [_t(v).requires_grad_(True) for v in jargs]
    got = tfg.fused_gn_silu_conv3x3_batched(*targs)
    _close(got, jfg.fused_gn_silu_conv3x3_batched(*jargs))
    got.square().sum().backward()
    for t, g, name in zip(targs, want_grads, ("dx", "da", "db", "dw", "dbias")):
        _close(t.grad, g, name)


def test_fused_gn_silu_conv_rounds_the_activation_before_the_conv():
    """In bf16 the plain version rounds silu(x*a + b) to bf16 and adds the
    bias in bf16, as `_xla_ref` does: both roundings are 2^-8 relative."""
    x, w, bias, a, b = _conv_inputs(6, (8, 8, 16), 8)
    jargs = [jnp.asarray(x, jnp.bfloat16), jnp.asarray(a), jnp.asarray(b), jnp.asarray(w, jnp.bfloat16),
             jnp.asarray(bias)]
    want = np.asarray(jfg._xla_ref(*jargs), np.float32)
    got = tfg.fused_gn_silu_conv3x3(_t(x).bfloat16(), _t(a), _t(b), _t(w).bfloat16(), _t(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# K9: stride-2 downsample conv with statistics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,n,pallas", [((2, 8, 32, 128), 128, True), ((2, 9, 14, 8), 16, False),
                                            ((1, 6, 6, 8), 8, False)], ids=["pallas", "ragged-odd", "small"])
def test_downsample_conv_matches_jax(shape, n, pallas):
    x, w, bias, *_ = _conv_inputs(7, shape, n)
    jargs = [jnp.asarray(v) for v in (x, w, bias)]
    y_j, st_j = jrb.fused_downsample_conv3x3_stats(*jargs)
    y, st = trb.fused_downsample_conv3x3_stats(_t(x), _t(w), _t(bias))
    assert y.shape == (shape[0], shape[1] // 2, shape[2] // 2, n) and st.shape == (shape[0], 2, n)
    _close(y, y_j, "y")
    _close(st, st_j, "stats")
    y_x, st_x = jrb._xla_downsample_conv(*jargs)
    _close(y, y_x, "y vs xla")
    _close(st, st_x, "stats vs xla")
    assert trb.DOWNSAMPLE_LAUNCHES == 0


def test_downsample_conv_gradients_with_the_statistics_cotangent_match_jax():
    x, w, bias, *_ = _conv_inputs(8, (2, 8, 10, 8), 16)
    rng = np.random.default_rng(9)
    gy = rng.standard_normal((2, 4, 5, 16)).astype(np.float32)
    gst = (rng.standard_normal((2, 2, 16)) * 0.1).astype(np.float32)

    def loss(x_, w_, b_):
        y, st = jrb.fused_downsample_conv3x3_stats(x_, w_, b_)
        return jnp.sum(y * gy) + jnp.sum(st * gst)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    targs = [_t(v).requires_grad_(True) for v in (x, w, bias)]
    y, st = trb.fused_downsample_conv3x3_stats(*targs)
    ((y * _t(gy)).sum() + (st * _t(gst)).sum()).backward()
    for t, g, name in zip(targs, want, ("dx", "dw", "dbias")):
        _close(t.grad, g, name)
    # only the statistics used downstream: the image cotangent is absent, not zero-filled
    for t in targs:
        t.grad = None
    _, st = trb.fused_downsample_conv3x3_stats(*targs)
    (st * _t(gst)).sum().backward()
    want_st = jax.grad(lambda x_: jnp.sum(jrb.fused_downsample_conv3x3_stats(x_, jnp.asarray(w), jnp.asarray(bias))[1]
                                           * gst))(jnp.asarray(x))
    _close(targs[0].grad, want_st, "dx from stats only")


@pytest.mark.parametrize("fused", [True, False])
def test_downsample_module_matches_the_jax_module(fused):
    x, w, bias, *_ = _conv_inputs(10, (2, 8, 12, 8), 8)
    params = {"conv": {"kernel": jnp.asarray(w), "bias": jnp.asarray(bias)}}
    y_j, st_j = jvae.Downsample(8, fused=fused).apply({"params": params}, jnp.asarray(x))
    module = tvae.Downsample(8, fused=fused)
    module.load_state_dict({"conv.weight": _t(w).permute(3, 2, 0, 1).contiguous(), "conv.bias": _t(bias)})
    with torch.no_grad():
        y, st = module(_t(x))
    _close(y, y_j)
    assert (st is None) == (st_j is None)
    if fused:
        _close(st, st_j, "stats")
        _close(st, trb.tensor_stats(y), "stats are those of y")


def test_the_encoder_builds_its_downsamplers_unfused():
    """As the JAX package's fused path: the whole-block kernels are on, the
    stride-2 conv stays the plain one."""
    from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig

    vae = tvae.AutoencoderKL(AutoencoderConfig.tiny(), fused=True)
    downs = [m for m in vae.modules() if isinstance(m, tvae.Downsample)]
    assert downs and not any(m.fused for m in downs)
    vae.set_fused(True)
    assert not any(m.fused for m in downs)


@pytest.mark.parametrize("which", ["conv3x3", "fused_gn_silu", "downsample"])
def test_launch_wrappers_refuse_cpu_tensors_and_bad_channels(which):
    """The wrappers check before they touch the library, so the refusals can
    be pinned without a card."""
    x = torch.zeros((1, 8, 8, 12), dtype=torch.bfloat16)       # C % 8 != 0, and on the CPU
    w = torch.zeros((3, 3, 12, 16), dtype=torch.bfloat16)
    ones, bias = torch.ones((1, 12)), torch.zeros(16)
    call = {"conv3x3": lambda: tc3.conv3x3_same_cuda(x, w),
            "fused_gn_silu": lambda: tfg.fused_gn_silu_conv3x3_cuda(x, ones, ones, w, bias),
            "downsample": lambda: trb.downsample_conv3x3_stats_cuda(x, w, bias)}[which]
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        call()
    with pytest.raises(ValueError, match="do not match"):
        {"conv3x3": lambda: tc3.conv3x3_same_cuda(x, w[:, :, :8]),
         "fused_gn_silu": lambda: tfg.fused_gn_silu_conv3x3_cuda(x, ones, ones, w[:, :, :8], bias),
         "downsample": lambda: trb.downsample_conv3x3_stats_cuda(x, w[:, :, :8], bias)}[which]()
