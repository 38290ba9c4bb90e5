"""Port of the flash-attention forward (K3) against the JAX Pallas kernel
run in interpret mode, and of its gradient against the JAX package's.

fp32 inputs on both sides: the Pallas kernel's online softmax and the plain
version's one-pass softmax differ only in summation order and in the
exp(m_old - m_new) rescaling, so 1e-4 holds; the recompute backward (d >= 384)
and the FlashAttention-2 plain backward (d < 384) sum the same products chunk
by chunk, so 1e-4 holds for the gradients too. The fused backward against the
Pallas dQ / dK,dV kernels is in `tests/test_torch_flash_attention_bwd.py`.
"""
import math

import jax
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


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("d", [32, 128, 512])
def test_attention_plain_matches_pallas_ragged(d):
    """S = 200 is not a multiple of the 128-row blocks: the ragged key tail
    is masked in the Pallas kernel and simply absent in the plain version."""
    q, k, v = _qkv((2, 200, d), seed=d)
    scale = 1.0 / math.sqrt(d)
    want = jfa.flash_attention_fwd_3d(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm_scale=scale, block_q=128, block_k=128
    )
    got = tfa.attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), sm_scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_attention_4d_entry_matches_pallas_entry():
    """The (B, H, S, D) dispatcher against the JAX `attention` entry on its
    kernel route; a CPU tensor takes the plain version and counts no launch."""
    q, k, v = _qkv((1, 3, 150, 64), seed=1)
    want = jfa.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), force_xla=False)
    got = tfa.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert tfa.LAUNCHES == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_attention_plain_chunking_is_exact():
    """Query chunking changes nothing: chunk 16 over S = 70 equals one chunk."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 70, 32), seed=2))
    whole = tfa.attention_plain(q, k, v, sm_scale=0.2, chunk=1024)
    chunked = tfa.attention_plain(q, k, v, sm_scale=0.2, chunk=16)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)


def _port_grads(q, k, v, g, **kw):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tfa.attention(*leaves, **kw)
    assert out.grad_fn is not None
    return out, torch.autograd.grad(out, leaves, torch.from_numpy(g))


@pytest.mark.parametrize("d,seq", [(512, 200), (64, 150)])
def test_attention_backward_matches_jax_chunked_recompute(d, seq):
    """d = 512 is the VAE mid-block's head: the JAX package differentiates the
    rematerialised `chunked_attention_3d` there, and so does the port. At
    d = 64 the port's CPU route is the FlashAttention-2 plain backward, which
    must give the same gradient."""
    q, k, v = _qkv((1, 1, seq, d), seed=10 + d)
    g = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    scale = 1.0 / math.sqrt(d)

    def f(q_, k_, v_):
        return jfa.chunked_attention_3d(q_[0], k_[0], v_[0], sm_scale=scale, chunk=64)[None]

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    _, got = _port_grads(q, k, v, g)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL, err_msg=f"d{name}")


def test_attention_recompute_backward_matches_native_autograd_across_chunks():
    """S = 70 over chunks of 16: dk and dv add up over the query chunks."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 70, 32), seed=4))
    g = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 70, 32)).astype(np.float32))
    got = tfa.attention_bwd_recompute(q, k, v, g, sm_scale=0.2, chunk=16)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(tfa.attention_plain(*leaves, sm_scale=0.2), leaves, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_attention_function_saves_only_q_k_v():
    """On the recompute route (head dim 384 and up) neither the output nor
    the log-sum-exp is kept."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv((1, 1, 40, 384), seed=6))
    out = tfa.attention(q, k, v)
    saved = out.grad_fn.next_functions[0][0].saved_tensors
    assert len(saved) == 3 and all(t.shape[-1] == 384 for t in saved)


@pytest.mark.parametrize("device,d,route", [
    ("cuda", 64, "kernels"), ("cuda", 128, "kernels"), ("cuda", 383, "kernels"),
    ("cuda", 384, "recompute"), ("cuda", 512, "recompute"),
    ("cpu", 64, "plain"), ("cpu", 128, "plain"), ("cpu", 384, "recompute"), ("cpu", 512, "recompute"),
])
def test_backward_route_follows_the_jax_head_dim_split(device, d, route):
    """Below 384 the fused FlashAttention-2 backward (the dQ and dK/dV kernels
    on CUDA, their plain version on the CPU), from 384 up the recompute: the
    same split as the JAX package's `_uses_fused_bwd`. No route is unported."""
    assert tfa.backward_route(device, d) == route
    assert (route != "recompute") == jfa._uses_fused_bwd(d)
