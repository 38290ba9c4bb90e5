"""`RgbaVAE.loss` of the port against the JAX package's, on the same numpy
inputs and posterior moments, in fp32 (rtol 1e-5): the weights of
`tests/test_rgba_vae_model.py`'s loss cases, naive MSE, `loss_reduce_mean`,
custom channel priors and RGB inputs. Also the loss weights that the stage-1
loop of each package reads from `model.*` and hands to `from_pretrained_rgb`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragb_vae_tpu.models.rgba_vae import RgbaVAE as JaxRgbaVAE
from ragb_vae_tpu.models.vae_config import AutoencoderConfig as JaxAutoencoderConfig
from ragb_vae_tpu.ops.gaussian import DiagonalGaussian as JaxGaussian
from ragb_vae_tpu.training import rgba_vae_stage as jstage
from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
from ragb_vae_tpu_torch.ops.gaussian import DiagonalGaussian
from ragb_vae_tpu_torch.training import rgba_vae_stage as tstage

CASES = {
    "defaults": {},
    "composition": dict(beta=0.25, white_bg_weight=0.5, black_bg_weight=0.5, alpha_l1_weight=0.1),
    "naive_mse": dict(use_naive_mse=True, white_bg_weight=0.2),
    "reduce_mean": dict(loss_reduce_mean=True, black_bg_weight=0.3, alpha_l1_weight=0.05),
    "naive_mse_reduce_mean": dict(use_naive_mse=True, loss_reduce_mean=True),
    "custom_priors": dict(eb=(0.1, -0.2, 0.05), eb2=(0.5, 0.4, 0.3), rgb_loss_weight=2.0, alpha_loss_weight=0.0),
    "kl_only": dict(rgb_loss_weight=0.0, alpha_loss_weight=0.0, beta=0.7),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: tiny tensors gain
    nothing from intra-op threads, and the workers stop fighting for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed, channels=4):
    rng = np.random.default_rng(seed)
    recon = rng.uniform(size=(2, 16, 16, channels)).astype(np.float32)
    target = rng.uniform(size=(2, 16, 16, channels)).astype(np.float32)
    moments = np.concatenate([rng.normal(size=(2, 2, 2, 4)), rng.normal(-1.0, 0.5, size=(2, 2, 2, 4))],
                             axis=-1).astype(np.float32)
    return recon, target, moments


def _losses(weights, recon, target, moments):
    jcfg = JaxAutoencoderConfig.tiny()
    want = JaxRgbaVAE(config=jcfg, **weights).loss(
        jnp.asarray(recon), jnp.asarray(target), JaxGaussian.from_params(jnp.asarray(moments)))
    model = RgbaVAE(AutoencoderConfig.tiny(), device="meta", **weights)
    got = model.loss(torch.from_numpy(recon), torch.from_numpy(target),
                     DiagonalGaussian.from_params(torch.from_numpy(moments)))
    assert got.dtype == torch.float32 and got.shape == ()
    return float(got), float(want)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("channels", [4, 3], ids=["rgba", "rgb"])
def test_loss_matches_jax(name, channels):
    got, want = _losses(CASES[name], *_inputs(len(name), channels))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_identical_recon_and_target_leave_only_the_kl_term():
    _, target, moments = _inputs(1)
    got, want = _losses(CASES["composition"], target, target, moments)
    kl = float(DiagonalGaussian.from_params(torch.from_numpy(moments)).kl().mean())
    np.testing.assert_allclose(got, 0.25 * kl, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_priors_must_have_three_channels():
    with pytest.raises(ValueError, match="three channel weights"):
        RgbaVAE(AutoencoderConfig.tiny(), device="meta", eb=(0.1, 0.2))


class _Built(Exception):
    pass


def test_stage1_passes_the_model_loss_weights_as_jax_does(monkeypatch):
    model = {"rgb_checkpoint": "ckpt", "base_arch": "flux", "beta": 0.5, "alpha_loss_weight": 2.0,
             "alpha_l1_weight": 0.3, "rgb_loss_weight": 0.7, "white_bg_loss_weight": 0.4,
             "black_bg_loss_weight": 0.6, "alpha_bias_init": 0.1}
    seen = {}

    def recorder(side):
        def from_pretrained_rgb(path, subfolder=None, **kw):
            seen[side] = dict(kw, path=path, subfolder=subfolder)
            raise _Built

        return staticmethod(from_pretrained_rgb)

    monkeypatch.setattr(jstage.RgbaVAE, "from_pretrained_rgb", recorder("jax"))
    monkeypatch.setattr(tstage.RgbaVAE, "from_pretrained_rgb", recorder("torch"))
    for side, run in (("jax", lambda cfg: jstage.train_rgba_vae(cfg)),
                      ("torch", lambda cfg: tstage.train_rgba_vae(cfg, device="cpu"))):
        with pytest.raises(_Built):
            run({"model": dict(model), "training": {}, "data": {}})
    keys = ("path", "subfolder", "alpha_bias_init", "beta", "alpha_loss_weight", "alpha_l1_weight",
            "rgb_loss_weight", "white_bg_weight", "black_bg_weight")
    want = {k: seen["jax"][k] for k in keys}
    assert {k: seen["torch"][k] for k in keys} == want
    assert (want["white_bg_weight"], want["black_bg_weight"], want["beta"]) == (0.4, 0.6, 0.5)
    # and the port's model keeps what it was given
    built = RgbaVAE(AutoencoderConfig.tiny(), device="meta",
                    **{k: want[k] for k in keys[3:]})
    assert (built.white_bg_weight, built.black_bg_weight, built.rgb_loss_weight) == (0.4, 0.6, 0.7)
