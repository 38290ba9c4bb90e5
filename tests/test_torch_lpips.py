"""Port of the LPIPS perceptual loss (`models/lpips.py`) against the JAX
package's, one set of weights in both.

The weights are the random `lpips.LPIPS(net="vgg")`-keyed state dict of
`tests/torch_lpips_ref.py`; the JAX side loads it through its `.pt` loader,
the port through the same file and through the JAX package's numpy store.
fp32 on both sides, 13 convs deep with sums of up to 4608 products: 2e-4
relative on the distance, 2e-3 of the largest entry on its gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragb_vae_tpu.models import lpips as jlp
from ragb_vae_tpu_torch.models import lpips as tlp
from torch_lpips_ref import lpips_distance_torch, make_lpips_state

D_RTOL = 2e-4
G_TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: tiny tensors gain
    nothing from intra-op threads, and the workers stop fighting for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("lpips") / "lpips_vgg.pt"
    torch.save({k: torch.from_numpy(v) for k, v in make_lpips_state(seed=0).items()}, path)
    return path, jlp.load_lpips_params(path), tlp.load_lpips_params(path)


def _images(seed, shape=(2, 32, 32, 3)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, shape).astype(np.float32), rng.uniform(-1, 1, shape).astype(np.float32))


@pytest.mark.parametrize("remat", [True, False])
def test_distance_matches_jax_and_the_torch_restatement(weights, remat):
    _, jparams, model = weights
    x, y = _images(1)
    want = np.asarray(jlp.lpips_distance(jnp.asarray(x), jnp.asarray(y), jparams, remat=remat))
    got = tlp.lpips_distance(torch.from_numpy(x), torch.from_numpy(y), model, remat=remat).numpy()
    np.testing.assert_allclose(got, want, rtol=D_RTOL)
    golden = lpips_distance_torch(x.transpose(0, 3, 1, 2), y.transpose(0, 3, 1, 2), make_lpips_state(seed=0))
    np.testing.assert_allclose(got, golden, rtol=D_RTOL)


@pytest.mark.parametrize("remat", [True, False])
def test_gradient_flows_through_pred_only_and_matches_jax(weights, remat):
    _, jparams, model = weights
    x, y = _images(2)
    want = jax.grad(lambda p: jlp.lpips_distance(p, jnp.asarray(y), jparams, remat=remat).sum())(jnp.asarray(x))
    pred = torch.from_numpy(x).requires_grad_(True)
    target = torch.from_numpy(y).requires_grad_(True)
    tlp.lpips_distance(pred, target, model, remat=remat).sum().backward()
    assert target.grad is None  # the target stream is data: detached
    want = np.asarray(want)
    np.testing.assert_allclose(pred.grad.numpy(), want, rtol=0, atol=G_TOL * np.abs(want).max())


def test_features_match_slice_by_slice(weights):
    _, jparams, model = weights
    x, _ = _images(3)
    want = jlp.lpips_features(jnp.asarray(x), jparams, remat=False)
    got = model.features(torch.from_numpy(x), remat=False)
    assert [tuple(f.shape) for f in got] == [tuple(f.shape) for f in want]
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max())


def test_numpy_store_converter_gives_the_same_model(weights):
    _, jparams, model = weights
    converted = tlp.lpips_from_numpy_store(jparams.convs, jparams.lins)
    x, y = (torch.from_numpy(a) for a in _images(4))
    torch.testing.assert_close(tlp.lpips_distance(x, y, converted), tlp.lpips_distance(x, y, model),
                               rtol=0, atol=0)


@pytest.mark.parametrize("weighted", [False, True])
def test_perceptual_loss_over_composites_matches_jax(weights, weighted):
    path, _, _ = weights
    jfn = jlp.maybe_build_lpips(path)
    tfn = tlp.maybe_build_lpips(path)
    rng = np.random.default_rng(5)
    pred = rng.uniform(-1, 1, (2, 32, 32, 4)).astype(np.float32)
    target = rng.uniform(-1, 1, (2, 32, 32, 4)).astype(np.float32)
    w = np.array([2.0, 0.0], np.float32) if weighted else None
    want = jfn(jnp.asarray(pred), jnp.asarray(target), None if w is None else jnp.asarray(w))
    got = tfn(torch.from_numpy(pred), torch.from_numpy(target), None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.item(), float(want), rtol=D_RTOL)


def test_baseline_mode_and_missing_layers(weights):
    state = make_lpips_state(seed=1)
    bare = {k: v for k, v in state.items() if not k.startswith("lin")}
    model = tlp.lpips_from_state(bare)
    assert all(bool((getattr(model, f"lin{k}") == 1).all()) for k in range(5))
    bare.pop("net.slice3.12.weight")
    with pytest.raises(ValueError):
        tlp.lpips_from_state(bare)
    assert tlp.maybe_build_lpips(None) is None


def test_bf16_compute_stays_close_to_fp32(weights):
    """`compute_dtype` runs the convs in bf16; normalisation and distances stay
    fp32. 13 bf16 convs: within 5% of the fp32 distance."""
    _, _, model = weights
    x, y = (torch.from_numpy(a) for a in _images(6))
    full = tlp.lpips_distance(x, y, model)
    half = tlp.lpips_distance(x, y, model, compute_dtype=torch.bfloat16)
    assert half.dtype == torch.float32
    torch.testing.assert_close(half, full, rtol=5e-2, atol=0)


def test_random_lpips_is_seeded_and_differentiable():
    a, b = tlp.random_lpips(3), tlp.random_lpips(3)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    x, y = (torch.from_numpy(v) for v in _images(7))
    x.requires_grad_(True)
    d = tlp.lpips_distance(x, y, a)
    d.sum().backward()
    assert bool((d > 0).all()) and bool(torch.isfinite(x.grad).all()) and x.grad.abs().max() > 0
