"""Port of the flash-attention forward (K3) against the JAX Pallas kernel
run in interpret mode.

fp32 inputs on both sides: the Pallas kernel's online softmax and the plain
version's one-pass softmax differ only in summation order and in the
exp(m_old - m_new) rescaling, so 1e-4 holds.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ragb_vae_tpu.ops.pallas.flash_attention as jfa
from ragb_vae_tpu_torch.ops.kernels import flash_attention as tfa

TOL = 1e-4


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
