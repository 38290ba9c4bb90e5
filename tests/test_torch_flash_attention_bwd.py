"""The port's FlashAttention-2 backward (the plain version of K4 and K5) against
the JAX Pallas dQ and dK/dV kernels run in interpret mode, and the routing of
the attention Function by head dim.

fp32 inputs on both sides. Both compute P = exp(scale * Q K^T - lse),
dS = P * (dP - delta) * scale and the three products from the same operands;
they differ in the order of the fp32 sums (the Pallas kernels add block by
block, the plain version chunk by chunk) and in the log-sum-exp they start
from (online softmax against one pass), so 1e-4 holds.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ragb_vae_tpu.ops.pallas.flash_attention as jfa
from ragb_vae_tpu_torch.ops.kernels import flash_attention as tfa

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
def _interpret_mode():
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = False


def _operands(bh, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(bh, sq, d), f(bh, sk, d), f(bh, sk, d), f(bh, sq, d)


@pytest.mark.parametrize("bh,sq,sk,d", [
    (2, 300, 300, 32),    # three blocks of 128 on both axes, ragged tail
    (1, 256, 256, 128),   # the FLUX head dim, whole blocks
    (2, 200, 200, 64),    # ragged
    (2, 77, 200, 32),     # Sq != Sk
    (1, 200, 77, 128),    # Sq != Sk the other way
])
def test_attention_bwd_plain_matches_pallas_kernels(bh, sq, sk, d):
    q, k, v, g = _operands(bh, sq, sk, d, seed=sq + sk + d)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    out_j, lse_j = jfa._flash_fwd_impl(jq, jk, jv, sm_scale=scale, block_q=128, block_k=128)
    want = jfa.flash_attention_bwd_3d(jq, jk, jv, out_j, lse_j, jg, sm_scale=scale,
                                      block_q=128, block_k=128)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out_t, lse_t = tfa.attention_lse_plain(tq, tk, tv, sm_scale=scale)
    # the port's lse is (BH, Sq) with no padding; JAX's is padded to the block, (BH, S_pad, 1)
    assert lse_t.shape == (bh, sq)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[:, :sq, 0], rtol=TOL, atol=TOL)
    got = tfa.attention_bwd_plain(tq, tk, tv, out_t, lse_t, tg, sm_scale=scale, chunk=128)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("chunk", [16, 50, 1024])
def test_attention_bwd_plain_equals_native_autograd_for_any_chunk(chunk):
    """dK and dV add up over the query chunks; dQ is cut by them."""
    q, k, v, g = (torch.from_numpy(a) for a in _operands(2, 70, 90, 32, seed=1))
    out, lse = tfa.attention_lse_plain(q, k, v, sm_scale=0.2)
    got = tfa.attention_bwd_plain(q, k, v, out, lse, g, sm_scale=0.2, chunk=chunk)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = torch.softmax(leaves[0] @ leaves[1].transpose(1, 2) * 0.2, dim=-1) @ leaves[2]
    want = torch.autograd.grad(ref, leaves, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_attention_lse_plain_is_the_logsumexp_of_the_scaled_logits():
    q, k, v, _ = (torch.from_numpy(a) for a in _operands(2, 40, 60, 16, seed=2))
    out, lse = tfa.attention_lse_plain(q, k, v, sm_scale=0.3, chunk=16)
    logits = q @ k.transpose(1, 2) * 0.3
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(logits, dim=-1).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), tfa.attention_plain(q, k, v, sm_scale=0.3).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d,n_saved", [(16, 5), (128, 5), (383, 5), (384, 3), (512, 3)])
def test_attention_function_saves_what_its_route_needs(d, n_saved):
    """Below 384 the fused backward needs q, k, v, the output and the
    log-sum-exp; from 384 up the recompute needs q, k, v only (the JAX
    package's `_flash_fwd` keeps the same residuals)."""
    q, k, v, _ = (torch.from_numpy(a).requires_grad_(True) for a in _operands(2, 24, 24, d, seed=3))
    out = tfa.attention(q[None], k[None], v[None])
    saved = out.grad_fn.next_functions[0][0].saved_tensors
    assert len(saved) == n_saved
    assert (n_saved == 5) == jfa._uses_fused_bwd(d)
    if n_saved == 5:
        assert saved[3].shape == (2, 24, d) and saved[4].shape == (2, 24) and saved[4].dtype == torch.float32


@pytest.mark.parametrize("d,sq,sk", [(32, 70, 70), (128, 40, 90)])
def test_attention_gradient_through_the_fused_route_matches_jax(d, sq, sk):
    """The (B, H, S, D) entry on its d < 384 route against the gradient of the
    JAX package's chunked attention."""
    import jax

    rng = np.random.default_rng(d)
    q, g = (rng.standard_normal((1, 2, sq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((1, 2, sk, d)).astype(np.float32) for _ in range(2))
    scale = 1.0 / math.sqrt(d)
    _, vjp = jax.vjp(lambda a, b, c: jfa.chunked_attention_3d(a[0], b[0], c[0], sm_scale=scale)[None],
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = torch.autograd.grad(tfa.attention(*leaves), leaves, torch.from_numpy(g))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL, err_msg=f"d{name}")


def test_cpu_tensors_count_no_launch_and_the_kernel_wrappers_refuse_them():
    tfa.reset_launch_counts()
    q, k, v, g = (torch.from_numpy(a) for a in _operands(1, 20, 20, 128, seed=4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tfa.attention(*(t[None] for t in leaves)).sum().backward()
    assert (tfa.LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES) == (0, 0, 0)
    lse = torch.zeros(1, 20)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_dq_cuda(q, k, v, g, lse, lse, sm_scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_dkv_cuda(q, k, v, g, lse, lse, sm_scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_cuda(q, k, v, q, lse, g, sm_scale=1.0)


def test_reset_launch_counts_zeroes_all_three():
    tfa.LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES = 3, 4, 5
    tfa.reset_launch_counts()
    assert (tfa.LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES) == (0, 0, 0)
