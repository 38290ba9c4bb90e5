"""Port of the training step's plain pieces against the JAX package: the
AlphaVAE loss bundle (`models/losses.py`), the posterior's KL / NLL
(`ops/gaussian.py`), the compositing functions (`ops/rgba.py`), the
detail-augmentation triplet (`ops/triplet.py`) and the validation metrics
(`ops/metrics.py`).

Same numpy inputs on both sides, fp32, elementwise algebra and sums of a few
thousand terms: 1e-5 relative (1e-6 absolute for values near zero).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragb_vae_tpu.models import losses as jl
from ragb_vae_tpu.ops import gaussian as jg
from ragb_vae_tpu.ops import metrics as jm
from ragb_vae_tpu.ops import rgba as jr
from ragb_vae_tpu.ops import triplet as jt
from ragb_vae_tpu_torch.models import losses as tl
from ragb_vae_tpu_torch.ops import gaussian as tg
from ragb_vae_tpu_torch.ops import metrics as tm
from ragb_vae_tpu_torch.ops import rgba as tr
from ragb_vae_tpu_torch.ops import triplet as tt

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: tiny tensors gain
    nothing from intra-op threads, and the workers stop fighting for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _pair(seed, shape=(3, 6, 5, 4)):
    rng = _rng(seed)
    return (rng.uniform(-1, 1, shape).astype(np.float32), rng.uniform(-1, 1, shape).astype(np.float32))


WEIGHTS = [None, np.array([1.0, 0.0, 2.0], np.float32)]


@pytest.mark.parametrize("weights", WEIGHTS, ids=["unweighted", "weighted"])
@pytest.mark.parametrize("reduce_mean", [False, True])
@pytest.mark.parametrize("naive", [False, True])
def test_reconstruction_loss_matches(naive, reduce_mean, weights):
    pred, target = _pair(0)
    jcfg = jl.AlphaVaeLossConfig(reduce_mean=reduce_mean, use_naive_mse=naive)
    tcfg = tl.AlphaVaeLossConfig(reduce_mean=reduce_mean, use_naive_mse=naive)
    want = jcfg.reconstruction_loss(jnp.asarray(pred), jnp.asarray(target),
                                    None if weights is None else jnp.asarray(weights))
    got = tcfg.reconstruction_loss(_t(pred), _t(target), None if weights is None else _t(weights))
    _close(got, want)


def test_reconstruction_loss_gradient_matches():
    import jax

    pred, target = _pair(1)
    want = jax.grad(lambda p: jl.alphavae_reconstruction_loss(p, jnp.asarray(target), reduce_mean=True))(
        jnp.asarray(pred))
    p = _t(pred).requires_grad_(True)
    tl.alphavae_reconstruction_loss(p, _t(target), reduce_mean=True).backward()
    _close(p.grad, want)


def _posteriors(seed, shape=(3, 4, 4, 8)):
    rng = _rng(seed)
    params = rng.standard_normal(shape).astype(np.float32)
    other = rng.standard_normal(shape).astype(np.float32)
    return params, other


@pytest.mark.parametrize("weights", WEIGHTS, ids=["unweighted", "weighted"])
@pytest.mark.parametrize("against_reference", [False, True])
def test_kl_loss_matches(against_reference, weights):
    params, other = _posteriors(2)
    jp, jo = jg.DiagonalGaussian.from_params(jnp.asarray(params)), jg.DiagonalGaussian.from_params(jnp.asarray(other))
    tp, to = tg.DiagonalGaussian.from_params(_t(params)), tg.DiagonalGaussian.from_params(_t(other))
    want = jl.kl_loss(jp, jo if against_reference else None, reduce_mean=True,
                      weights=None if weights is None else jnp.asarray(weights))
    got = tl.kl_loss(tp, to if against_reference else None, reduce_mean=True,
                     weights=None if weights is None else _t(weights))
    _close(got, want)


def test_gaussian_var_nll_and_split_match():
    params, _ = _posteriors(3)
    sample = _rng(4).standard_normal((3, 4, 4, 4)).astype(np.float32)
    jp, tp = jg.DiagonalGaussian.from_params(jnp.asarray(params)), tg.DiagonalGaussian.from_params(_t(params))
    _close(tp.var, jp.var)
    _close(tp.nll(_t(sample)), jp.nll(jnp.asarray(sample)))
    for a, b in zip(tg.split_batch(tp, 3), jg.split_batch(jp, 3)):
        _close(a.mean, b.mean)
        _close(a.logvar, b.logvar)
    with pytest.raises(ValueError):
        tg.split_batch(tp, 2)


def test_perceptual_composites_match():
    pred, target = _pair(5)
    for got, want in zip(tl.perceptual_composites(_t(pred), _t(target)),
                         jl.perceptual_composites(jnp.asarray(pred), jnp.asarray(target))):
        _close(got, want)


def test_weighted_reduction_ignores_padding_samples():
    """A zero-weight sample changes nothing, whatever it holds."""
    pred, target = _pair(6)
    w = _t([1.0, 1.0, 0.0])
    base = tl.alphavae_reconstruction_loss(_t(pred), _t(target), reduce_mean=True, weights=w)
    pred[2] = 1e3
    again = tl.alphavae_reconstruction_loss(_t(pred), _t(target), reduce_mean=True, weights=w)
    assert base.item() == again.item()


def test_loss_config_rejects_wrong_priors():
    with pytest.raises(ValueError):
        tl.AlphaVaeLossConfig(eb=(0.0, 0.0))


BACKGROUNDS = [0.25, (0.1, 0.5, 0.9), "tensor", "gray"]


@pytest.mark.parametrize("background", BACKGROUNDS, ids=["scalar", "color", "image", "gray-image"])
def test_composite_over_background_matches(background):
    rgba = _rng(7).uniform(size=(2, 6, 5, 4)).astype(np.float32)
    if background == "tensor":
        background = _rng(8).uniform(size=(2, 6, 5, 3)).astype(np.float32)
    elif background == "gray":
        background = _rng(8).uniform(size=(2, 6, 5, 1)).astype(np.float32)
    is_array = isinstance(background, np.ndarray)
    want = jr.composite_over_background(jnp.asarray(rgba), jnp.asarray(background) if is_array else background)
    got = tr.composite_over_background(_t(rgba), _t(background) if is_array else background)
    _close(got, want)


def test_white_black_blend_and_checkerboard_match():
    rgba = _rng(9).uniform(size=(2, 20, 36, 4)).astype(np.float32)
    _close(tr.composite_over_white(_t(rgba)), jr.composite_over_white(jnp.asarray(rgba)))
    _close(tr.composite_over_black(_t(rgba)), jr.composite_over_black(jnp.asarray(rgba)))
    _close(tr.blend_to_white(_t(rgba)), jr.blend_to_white(jnp.asarray(rgba)))
    _close(tr.checkerboard(20, 36, tile=8), jr.checkerboard(20, 36, tile=8))
    _close(tr.composite_over_checkerboard(_t(rgba), tile=8),
           jr.composite_over_checkerboard(jnp.asarray(rgba), tile=8))
    with pytest.raises(ValueError):
        tr.composite_over_background(_t(rgba), (0.1, 0.2))


def test_triplet_matches_and_splits_back():
    target = _rng(10).uniform(-1, 1, (2, 6, 5, 4)).astype(np.float32)
    got = tt.detail_augmented_triplet(_t(target))
    _close(got, jt.detail_augmented_triplet(jnp.asarray(target)))
    original, black, white = tt.split_triplet(got)
    _close(original, target)
    assert bool((black[..., 3] == 1).all()) and bool((white[..., 3] == 1).all())
    with pytest.raises(ValueError):
        tt.split_triplet(got[:4])
    with pytest.raises(ValueError):
        tt.detail_augmented_triplet(_t(target[..., :3]))


def test_metrics_match():
    pred, target = (_rng(11).uniform(size=(3, 6, 5, 4)).astype(np.float32) for _ in range(2))
    _close(tm.psnr(_t(pred), _t(target)), jm.psnr(jnp.asarray(pred), jnp.asarray(target)))
    _close(tm.alpha_mae(_t(pred), _t(target)), jm.alpha_mae(jnp.asarray(pred), jnp.asarray(target)))
    _close(tm.psnr(_t(pred), _t(pred)), jm.psnr(jnp.asarray(pred), jnp.asarray(pred)))
