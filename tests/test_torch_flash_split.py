"""The key-split arithmetic of the flash-attention forward (K3) at head dim
512: each key range's partial result (unnormalised O, row max m, row sum l,
in fp32) and their merge, as plain PyTorch functions, against the one-pass
plain version and against the JAX Pallas kernel run in interpret mode; and
the split count the wrapper picks.

fp32 inputs: splitting only reorders fp32 sums and rescales each range by
exp(m_s - M), so 1e-5 relative holds.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ragb_vae_tpu.ops.pallas.flash_attention as jfa
from ragb_vae_tpu_torch.ops.kernels import flash_attention as tfa

TOL = 1e-5


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


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("splits", [1, 2, 3, 5])
def test_merged_key_splits_match_plain_and_pallas(splits):
    """200 keys in 7 tiles of 32 (the last holds 8): every split count cuts
    whole tiles and only the last range is ragged."""
    rng = np.random.default_rng(splits)
    q = rng.standard_normal((2, 150, 128)).astype(np.float32)
    k, v = (rng.standard_normal((2, 200, 128)).astype(np.float32) for _ in range(2))
    scale = 1.0 / math.sqrt(128)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ranges = tfa.split_ranges(200, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == 200 and len(ranges) == splits
    assert all(a[1] == b[0] and a[1] % 32 == 0 for a, b in zip(ranges, ranges[1:]))
    parts = [tfa.attention_partials_plain(tq, tk, tv, sm_scale=scale, start=s, end=e) for s, e in ranges]
    out, lse = tfa.merge_partials_plain(*(torch.stack(p) for p in zip(*parts)), torch.float32)

    plain_out, plain_lse = tfa.attention_lse_plain(tq, tk, tv, sm_scale=scale)
    _close(out.numpy(), plain_out.numpy())
    _close(lse.numpy(), plain_lse.numpy())
    want_out, want_lse = jfa._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm_scale=scale,
                                              block_q=128, block_k=128)
    _close(out.numpy(), want_out)
    _close(lse.numpy(), np.asarray(want_lse)[:, :150, 0])


def test_partials_round_p_like_the_kernel():
    """In bf16, P is rounded before P V while l sums the unrounded P."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 40, 128)).astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    o, m, l = tfa.attention_partials_plain(q, k, v, sm_scale=0.1, start=0, end=40)
    logits = torch.matmul(q, k.transpose(1, 2)).float() * 0.1
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    assert torch.equal(m, logits.amax(-1)) and torch.equal(l, p.sum(-1))
    assert torch.equal(o, torch.matmul(p.to(torch.bfloat16).float(), v.float()))


@pytest.mark.parametrize("bh,seq,want", [
    (1, 4096, 2), (1, 16384, 1), (4, 4096, 1), (4, 16384, 1), (12, 4096, 1), (12, 16384, 1)])
def test_key_splits_fill_the_card_at_head_dim_512(bh, seq, want):
    """One head of 4096 tokens is 64 blocks of 64 query rows for 132 SMs:
    two key ranges; 16384 tokens or 4 and 12 heads (training) fill it unsplit."""
    assert tfa.key_splits(bh, seq, seq, 512, sm_count=132) == want
    assert tfa.key_splits(bh, seq, seq, 128, sm_count=132) == 1


def test_key_splits_keep_a_minimum_of_tiles_per_range():
    # 120 keys are 4 tiles: fewer than MIN_TILES_PER_SPLIT, no split
    assert tfa.key_splits(1, 120, 120, 512, sm_count=132) == 1
    # 3 heads x 1000 rows = 48 blocks: 132 // 48 = 2 ranges of 16 tiles
    assert tfa.key_splits(3, 1000, 1000, 512, sm_count=132) == 2
    for bh, seq in ((1, 4096), (1, 300), (2, 2000)):
        n = tfa.key_splits(bh, seq, seq, 512, sm_count=132)
        assert all(e - s >= 1 for s, e in tfa.split_ranges(seq, n))
    with pytest.raises(ValueError):
        tfa.split_ranges(64, 3)   # 2 tiles cannot make 3 ranges
