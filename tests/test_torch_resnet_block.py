"""Port of the whole-resnet-block kernels (K1 conv+stats, K2 sub-pixel
upsample) against the JAX Pallas kernels run in interpret mode.

Both sides run in fp32 on the same numpy inputs, so only the order of the
sums differs: outputs agree to 1e-4; the (sum, sumsq) statistics, sums of
~10^2-10^3 terms of size ~10, to 1e-4 relative (plus 1e-3 absolute for
channel sums near zero). C = N = 128 and W % 8 == 0 so JAX takes the kernel,
not its XLA fallback.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ragb_vae_tpu.ops.pallas.resnet_block as jrb
from ragb_vae_tpu_torch.ops.kernels import resnet_block as trb

Y_TOL = 1e-4
STATS_RTOL, STATS_ATOL = 1e-4, 1e-3


@pytest.fixture(autouse=True)
def _interpret():
    jrb.INTERPRET = True
    yield
    jrb.INTERPRET = False


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _inputs(bsz, h, w, c, n, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((bsz, h, w, c)).astype(np.float32),
        (rng.standard_normal((bsz, c)) * 0.5 + 1.0).astype(np.float32),
        (rng.standard_normal((bsz, c)) * 0.2).astype(np.float32),
        (rng.standard_normal((3, 3, c, n)) * 0.05).astype(np.float32),
        (rng.standard_normal(n) * 0.1).astype(np.float32),
    )


def _close(got, want, *, stats=False):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if stats:
        np.testing.assert_allclose(got, np.asarray(want), rtol=STATS_RTOL, atol=STATS_ATOL)
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=Y_TOL, atol=Y_TOL)


@pytest.mark.parametrize("activation", ["silu", "identity"])
@pytest.mark.parametrize("skip", ["none", "identity", "proj"])
def test_conv3x3_stats_plain_matches_pallas(activation, skip):
    n = 256 if skip == "proj" else 128
    x, a, b, w, bias = _inputs(2, 8, 16, 128, n)
    rng = np.random.default_rng(1)
    sk, proj_np = None, None
    if skip == "identity":
        sk = rng.standard_normal((2, 8, 16, n)).astype(np.float32)
    elif skip == "proj":
        sk = x
        proj_np = ((rng.standard_normal((128, n)) * 0.05).astype(np.float32),
                   (rng.standard_normal(n) * 0.1).astype(np.float32))
    y_j, s_j = jrb.gn_silu_conv3x3_stats(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(w), jnp.asarray(bias),
        None if sk is None else jnp.asarray(sk),
        proj=None if proj_np is None else tuple(jnp.asarray(p) for p in proj_np),
        activation=activation,
    )
    y_t, s_t = trb.gn_silu_conv3x3_stats(
        _t(x), _t(a), _t(b), _t(w), _t(bias), None if sk is None else _t(sk),
        proj=None if proj_np is None else tuple(_t(p) for p in proj_np),
        activation=activation,
    )
    assert trb.CONV_LAUNCHES == 0  # a CPU tensor never reaches the CUDA kernel
    _close(y_t, y_j)
    _close(s_t, s_j, stats=True)


def _block_params(c_in, c_out, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, shift=0.0: (rng.standard_normal(s) * scale + shift).astype(np.float32)
    p = {
        "norm1": {"scale": f(c_in, scale=0.2, shift=1.0), "bias": f(c_in, scale=0.1)},
        "conv1": {"kernel": f(3, 3, c_in, c_out, scale=0.05), "bias": f(c_out, scale=0.1)},
        "norm2": {"scale": f(c_out, scale=0.2, shift=1.0), "bias": f(c_out, scale=0.1)},
        "conv2": {"kernel": f(3, 3, c_out, c_out, scale=0.05), "bias": f(c_out, scale=0.1)},
    }
    if c_in != c_out:
        p["conv_shortcut"] = {"kernel": f(1, 1, c_in, c_out, scale=0.05), "bias": f(c_out, scale=0.1)}
    return p


def _to_jax(p):
    return {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in p.items()}


def _to_port(p):
    out = {k: {kk: _t(vv) for kk, vv in v.items()} for k, v in p.items()}
    if "conv_shortcut" in out:  # the port's block takes the 1x1 kernel as (C_in, N)
        ks = out["conv_shortcut"]["kernel"]
        out["conv_shortcut"]["kernel"] = ks.reshape(ks.shape[-2], ks.shape[-1])
    return out


@pytest.mark.parametrize("c_in,c_out", [(128, 128), (128, 256)])
def test_fused_resnet_block_matches_pallas(c_in, c_out):
    x = np.random.default_rng(3).standard_normal((2, 8, 16, c_in)).astype(np.float32)
    p = _block_params(c_in, c_out, seed=4)
    y_j, s_j = jrb.fused_resnet_block(jnp.asarray(x), _to_jax(p), num_groups=32)
    y_t, s_t = trb.fused_resnet_block(_t(x), _to_port(p), num_groups=32)
    _close(y_t, y_j)
    _close(s_t, s_j, stats=True)


def test_stats_chain_over_two_blocks_matches_pallas():
    """Block 2's GroupNorm runs from block 1's epilogue stats (stats_to_coeffs)."""
    x = np.random.default_rng(5).standard_normal((1, 8, 16, 128)).astype(np.float32)
    p1, p2 = _block_params(128, 128, seed=6), _block_params(128, 128, seed=7)
    yj, sj = jrb.fused_resnet_block(jnp.asarray(x), _to_jax(p1), num_groups=32)
    yj, sj = jrb.fused_resnet_block(yj, _to_jax(p2), num_groups=32, stats=sj)
    yt, st = trb.fused_resnet_block(_t(x), _to_port(p1), num_groups=32)
    yt, st = trb.fused_resnet_block(yt, _to_port(p2), num_groups=32, stats=st)
    _close(yt, yj)
    _close(st, sj, stats=True)
    scale, bias = p2["norm1"]["scale"], p2["norm1"]["bias"]
    a_j, b_j = jrb.stats_to_coeffs(sj, jnp.asarray(scale), jnp.asarray(bias), 32, 8 * 16)
    a_t, b_t = trb.stats_to_coeffs(st, _t(scale), _t(bias), 32, 8 * 16)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-4, atol=1e-5)


def test_tensor_stats_matches_jax():
    x = np.random.default_rng(8).standard_normal((2, 5, 7, 16)).astype(np.float32)
    _close(trb.tensor_stats(_t(x)), jrb.tensor_stats(jnp.asarray(x)), stats=True)


def test_upsample_plain_matches_pallas_subpixel():
    x, _, _, w, bias = _inputs(1, 8, 16, 128, 128, seed=9)
    y_j, s_j = jrb.fused_upsample_conv3x3_stats(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    y_t, s_t = trb.fused_upsample_conv3x3_stats(_t(x), _t(w), _t(bias))
    assert trb.UPSAMPLE_LAUNCHES == 0
    assert y_t.shape == (1, 16, 32, 128)
    _close(y_t, y_j)
    _close(s_t, s_j, stats=True)


def test_fold_subpixel_weights_matches_jax():
    w = np.random.default_rng(10).standard_normal((3, 3, 8, 12)).astype(np.float32)
    np.testing.assert_allclose(
        trb.fold_subpixel_weights(_t(w)).numpy(), np.asarray(jrb._fold_subpixel_weights(jnp.asarray(w))),
        rtol=1e-6, atol=1e-6,
    )


def test_subpixel_indexing_of_the_cuda_kernel_reproduces_literal_upsample():
    """Restates, in torch, the index map the K2 kernel uses (output pixel
    (2r+a, 2c+b) reads small pixels (r+a+u-1, c+b+v-1) through the folded
    weights [a][b][u][v*C:(v+1)*C]) and checks it against the literal
    nearest-2x + conv3x3. fp32, so 1e-4 covers the re-associated sums."""
    rng = np.random.default_rng(11)
    x, w, bias = (_t(rng.standard_normal(s)) for s in ((2, 5, 6, 8), (3, 3, 8, 4), (4,)))
    wf = trb.fold_subpixel_weights(w)
    bsz, h, wd, c = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))  # zero halo on H and W
    out = torch.zeros(bsz, 2 * h, 2 * wd, 4)
    for a in range(2):
        for b in range(2):
            acc = bias.expand(bsz, h, wd, 4).clone()
            for u in range(2):
                for v in range(2):
                    patch = xp[:, a + u : a + u + h, b + v : b + v + wd]
                    acc = acc + patch @ wf[a, b, u, v * c : (v + 1) * c]
            out[:, a::2, b::2] = acc
    y_ref, _ = trb.upsample_conv3x3_stats_plain(x, w, bias)
    np.testing.assert_allclose(out.numpy(), y_ref.numpy(), rtol=1e-4, atol=1e-4)
