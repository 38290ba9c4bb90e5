"""Port of the Winograd conv route (K8) against the JAX package.

The JAX side runs `gn_silu_conv3x3_stats(algo="winograd")` through the
Pallas `_wino_kernel` in interpret mode at the smallest shape its predicate
accepts (H = 2, W = 16, C = N = 128). Both sides run in fp32 on the same
numpy inputs, so V and U round nowhere and only the order of fp32 sums
differs: y agrees to 1e-4, the (sum, sumsq) statistics to 1e-3 relative.
The CUDA kernel itself runs only on the card (tests/test_torch_kernels_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ragb_vae_tpu.ops.pallas.resnet_block as jrb
from ragb_vae_tpu_torch.ops.kernels import resnet_block as trb

Y_TOL = 1e-4
STATS_RTOL, STATS_ATOL = 1e-3, 1e-3
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4


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
    jrb.INTERPRET = True
    yield
    jrb.INTERPRET = False


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _operands(skip, n=128, c=128, seed=0):
    """(x, a, b, w, bias, skip, ws, wsb) as numpy, shape (1, 2, 16, c) -> n."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, shift=0.0: (rng.standard_normal(s) * scale + shift).astype(np.float32)
    x = f(1, 2, 16, c)
    ops = [x, f(1, c, scale=0.5, shift=1.0), f(1, c, scale=0.2), f(3, 3, c, n, scale=0.05), f(n, scale=0.1)]
    if skip == "identity":
        return ops + [f(1, 2, 16, n), None, None]
    if skip == "proj":
        return ops + [x, f(c, n, scale=0.05), f(n, scale=0.1)]
    return ops + [None, None, None]


def _jax_call(ops, activation):
    x, a, b, w, bias, sk, ws, wsb = (None if o is None else jnp.asarray(o) for o in ops)
    return jrb.gn_silu_conv3x3_stats(x, a, b, w, bias, sk, proj=None if ws is None else (ws, wsb),
                                     activation=activation, algo="winograd")


def test_wino_weights_match_jax():
    """`wino_weights` is the JAX package's row fold (2, 4, 3C, N) bit for bit;
    K8's 16 unsigned tiles fold to it, and the cast comes after the fp32 fold."""
    w = np.random.default_rng(1).standard_normal((3, 3, 8, 12)).astype(np.float32)
    folded = trb.wino_weights(_t(w))
    assert folded.shape == (2, 4, 24, 12) and folded.dtype == torch.float32
    np.testing.assert_array_equal(folded.numpy(), np.asarray(jrb._wino_weights(jnp.asarray(w))))
    u = trb.wino_tiles(_t(w))
    assert u.shape == (4, 4, 8, 12) and u.dtype == torch.float32
    assert folded.equal(torch.stack([torch.cat([u[0], u[1], u[2]], dim=1), torch.cat([u[1], -u[2], -u[3]], dim=1)]))
    assert trb.wino_weights(_t(w), torch.bfloat16).equal(folded.to(torch.bfloat16))
    assert trb.wino_tiles(_t(w), torch.bfloat16).equal(u.to(torch.bfloat16))


@pytest.mark.parametrize("activation,skip", [("silu", None), ("silu", "identity"), ("identity", "proj")])
def test_wino_plain_matches_pallas(activation, skip):
    ops = _operands(skip, n=256 if skip == "proj" else 128)
    y_j, s_j = _jax_call(ops, activation)
    x, a, b, w, bias, sk, ws, wsb = (None if o is None else _t(o) for o in ops)
    y_t, s_t = trb.gn_silu_conv3x3_stats(x, a, b, w, bias, sk, proj=None if ws is None else (ws, wsb),
                                         activation=activation, algo="winograd")
    assert trb.WINO_LAUNCHES == 0 and trb.CONV_LAUNCHES == 0   # a CPU tensor takes the plain version
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=Y_TOL, atol=Y_TOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=STATS_RTOL, atol=STATS_ATOL)
    # the same function as the direct route
    y_d, _ = trb.conv3x3_stats_plain(x, a, b, w, bias, sk, ws, wsb, activation)
    np.testing.assert_allclose(y_t.numpy(), y_d.numpy(), rtol=Y_TOL, atol=Y_TOL)


def test_wino_gradients_match_pallas():
    """Every operand's cotangent, the statistics' included, through the
    Winograd route against `jax.grad` through `_wino_chain` (whose backward
    is the direct chain's)."""
    ops = _operands("proj", n=128, seed=2)
    gy = np.random.default_rng(3).standard_normal((1, 2, 16, 128)).astype(np.float32)
    gs = np.random.default_rng(4).standard_normal((1, 2, 128)).astype(np.float32) * 0.1

    def jax_loss(x, a, b, w, bias, sk, ws, wsb):
        y, s = jrb.gn_silu_conv3x3_stats(x, a, b, w, bias, sk, proj=(ws, wsb), algo="winograd")
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    want = jax.grad(jax_loss, argnums=tuple(range(8)))(*(jnp.asarray(o) for o in ops))
    leaves = [_t(o).requires_grad_(True) for o in ops]
    x, a, b, w, bias, sk, ws, wsb = leaves
    y, s = trb.gn_silu_conv3x3_stats(x, a, b, w, bias, sk, proj=(ws, wsb), algo="winograd")
    (torch.sum(y * _t(gy)) + torch.sum(s * _t(gs))).backward()
    for name, leaf, ref in zip(("x", "a", "b", "w", "bias", "skip", "ws", "wsb"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


# (H, W, C, N, C_skip): the JAX predicate's aligned shape and one shape that
# fails each of its clauses
ROUTE_SHAPES = [
    ((2, 16, 128, 128, None), True),
    ((3, 16, 128, 128, None), False),     # H odd
    ((2, 8, 128, 128, None), False),      # W % 16
    ((2, 16, 64, 128, None), False),      # C % 128
    ((2, 16, 128, 64, None), False),      # N % 128
    ((2, 16, 128, 128, 64), False),       # C_skip % 128
]


@pytest.mark.parametrize("shape,aligned", ROUTE_SHAPES, ids=[str(s[0]) for s in ROUTE_SHAPES])
def test_router_matches_the_jax_predicate(monkeypatch, shape, aligned):
    """Which route the JAX entry takes under algo="winograd" (its routes
    stubbed, so nothing runs) against the port's `conv_route`."""
    h, w, c, n, c_skip = shape
    taken = []
    stub = lambda route: lambda *a, **k: taken.append(route) or (None, None)
    monkeypatch.setattr(jrb, "_wino_chain", stub("winograd"))
    monkeypatch.setattr(jrb, "_chain", stub("direct"))
    monkeypatch.setattr(jrb, "_xla_chain", stub("direct"))
    x = np.zeros((1, h, w, c), np.float32)
    skip = None if c_skip is None else np.zeros((1, h, w, c_skip), np.float32)
    proj = None if c_skip is None else (np.zeros((c_skip, n), np.float32), np.zeros(n, np.float32))
    wt = np.zeros((3, 3, c, n), np.float32)
    jrb.gn_silu_conv3x3_stats(x, np.zeros((1, c)), np.zeros((1, c)), wt, np.zeros(n), skip, proj=proj,
                              algo="winograd")
    ws = None if proj is None else _t(proj[0])
    route = trb.conv_route(_t(x), _t(wt), None if skip is None else _t(skip), ws, "winograd")
    assert taken == [route] == ["winograd" if aligned else "direct"]
    assert trb.wino_aligned(h, w, c, n, c_skip) is aligned
    assert trb.conv_route(_t(x), _t(wt), None, None, "direct") == "direct"


def test_conv_algo_defaults_to_direct_and_a_call_overrides_it(monkeypatch):
    assert trb.CONV_ALGO == jrb.CONV_ALGO == "direct"
    x, wt = torch.zeros((1, 2, 16, 128)), torch.zeros((3, 3, 128, 128))
    assert trb.conv_route(x, wt, None, None) == "direct"
    monkeypatch.setattr(trb, "CONV_ALGO", "winograd")
    assert trb.conv_route(x, wt, None, None) == "winograd"
    assert trb.conv_route(x, wt, None, None, "direct") == "direct"
    with pytest.raises(ValueError, match="unknown conv algo"):
        trb.conv_route(x, wt, None, None, "fft")


def test_resnet_block_takes_the_winograd_route(monkeypatch):
    """A fused ResnetBlock of the ae's width at the module default
    "winograd": both convs go through the Winograd plain version (which a
    CUDA tensor would send to K8) and match the direct route."""
    calls = []
    original = trb.wino_conv3x3_stats_plain
    monkeypatch.setattr(trb, "wino_conv3x3_stats_plain", lambda *a: calls.append(a[0].shape) or original(*a))
    rng = np.random.default_rng(5)
    f = lambda *s, scale=1.0, shift=0.0: _t(rng.standard_normal(s) * scale + shift)
    params = {"norm1": {"scale": f(128, scale=0.2, shift=1.0), "bias": f(128, scale=0.1)},
              "conv1": {"kernel": f(3, 3, 128, 256, scale=0.05), "bias": f(256, scale=0.1)},
              "norm2": {"scale": f(256, scale=0.2, shift=1.0), "bias": f(256, scale=0.1)},
              "conv2": {"kernel": f(3, 3, 256, 256, scale=0.05), "bias": f(256, scale=0.1)},
              "conv_shortcut": {"kernel": f(128, 256, scale=0.05), "bias": f(256, scale=0.1)}}
    x = f(2, 4, 16, 128)
    want, want_stats = trb.fused_resnet_block(x, params, num_groups=32)
    monkeypatch.setattr(trb, "CONV_ALGO", "winograd")
    got, got_stats = trb.fused_resnet_block(x, params, num_groups=32)
    assert calls == [(2, 4, 16, 128), (2, 4, 16, 256)]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=Y_TOL, atol=Y_TOL)
    np.testing.assert_allclose(got_stats.numpy(), want_stats.numpy(), rtol=STATS_RTOL, atol=STATS_ATOL)


def test_wino_cuda_wrapper_refuses_cpu_tensors_and_odd_sizes():
    x, a, b = torch.zeros((1, 2, 16, 8), dtype=torch.bfloat16), torch.ones((1, 8)), torch.zeros((1, 8))
    w, bias = torch.zeros((3, 3, 8, 8), dtype=torch.bfloat16), torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        trb.wino_conv3x3_stats_cuda(x, a, b, w, bias)
    with pytest.raises(ValueError, match="even"):
        trb.wino_conv3x3_stats_plain(x[:, :1], a, b, w, bias)


def test_wino_tiles_are_folded_once_per_weight_and_version():
    """A fused ResnetBlock keeps its convs' Winograd tiles per weight and
    version, under autograd too (U is detached), and folds them again after
    an in-place step, a cast of the module (which keeps the Parameter and
    its version), a new `.data` and a loaded state dict."""
    from ragb_vae_tpu_torch.models.vae import ResnetBlock

    torch.manual_seed(6)
    block = ResnetBlock(8, 16, num_groups=4, fused=True)
    tiles = lambda: block._wino_tiles("conv1", block.conv1, torch.bfloat16)
    want = lambda: trb.wino_tiles(block.conv1.weight.detach().permute(2, 3, 1, 0).to(torch.bfloat16))
    first = tiles()
    assert tiles() is first and first.equal(want()) and first.is_contiguous() and not first.requires_grad
    with torch.no_grad():
        block.conv1.weight.mul_(2.0)
    again = tiles()
    assert again is not first and again.equal(want())
    block.to(torch.float64)
    cast = tiles()
    assert cast is not again and cast.equal(want())
    block.conv1.weight.data = torch.randn_like(block.conv1.weight)
    assert tiles().equal(want())
    state = {k: torch.randn_like(v) for k, v in block.state_dict().items()}
    block.load_state_dict(state)
    assert tiles().equal(want())
