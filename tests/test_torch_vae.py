"""Port of the RGBA VAE (`AutoencoderConfig.tiny()`, 4 channels in and out)
against the JAX package's CPU path, one set of weights in both.

Random numpy weights in the JAX tree's structure (biases and norm affines
not trivially 0/1) cross over through `params_from_flax` and load with
strict=True. The JAX side runs under jit (one compile instead of one per
op). fp32 on both sides; the convolutions and GroupNorm sums run in another
order, so 1e-4 holds through the whole encoder / decoder.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragb_vae_tpu.models.rgba_vae import RgbaVAE as JaxRgbaVAE
from ragb_vae_tpu.models.vae_config import AutoencoderConfig as JaxAutoencoderConfig
from ragb_vae_tpu_torch.models import weights as tw
from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig

TOL = 1e-4


def _configs():
    jcfg = JaxAutoencoderConfig.tiny()
    jcfg.in_channels = jcfg.out_channels = 4
    tcfg = AutoencoderConfig.tiny()
    tcfg.in_channels = tcfg.out_channels = 4
    return jcfg, tcfg


def _random_params(jcfg, seed=0):
    """Random numpy weights in the JAX tree's structure (from eval_shape,
    which traces the init without running it): kernels at lecun scale,
    norm scales near 1, biases and norm shifts small but non-zero."""
    shapes = jax.eval_shape(
        lambda: JaxRgbaVAE(config=jcfg).init_params(jax.random.PRNGKey(0), image_size=32)
    )
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return (noise / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return (noise * 0.1 + (1.0 if path[-1].key == "scale" else 0.0)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _configs()
    params = _random_params(jcfg)
    port = RgbaVAE(tcfg)
    port.module.load_state_dict(tw.params_from_flax(params), strict=True)
    return jcfg, params, port


def _img(seed, shape=(2, 32, 24, 4)):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def test_params_from_flax_round_trip(models):
    _, params, port = models
    back = tw.params_to_flax(port.module.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), flat_b[path])


def test_encoder_moments_match(models):
    jcfg, params, port = models
    x = _img(1) * 2.0 - 1.0
    module = JaxRgbaVAE(config=jcfg).module
    want = jax.jit(
        lambda p, v: module.apply({"params": p}, v, method=lambda m, t: m.encode(t).params)
    )(params, jnp.asarray(x))
    with torch.no_grad():
        got = port.encode(torch.from_numpy(x)).params
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_decoder_matches(models):
    jcfg, params, port = models
    z = np.random.default_rng(2).standard_normal((2, 4, 3, jcfg.latent_channels)).astype(np.float32)
    want = jax.jit(JaxRgbaVAE(config=jcfg).decode)(params, jnp.asarray(z))
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_forward_mode_matches(models, fused):
    """RgbaVAE.forward(sample=False); fused routes every ResnetBlock and
    Upsample through the kernel modules' plain versions on CPU, threading
    the epilogue statistics exactly as the JAX fused path does."""
    jcfg, params, port = models
    x = _img(3)
    jvae = JaxRgbaVAE(config=jcfg, fused=fused)
    want, post = jax.jit(
        lambda p, v: jvae.forward(p, v, jax.random.PRNGKey(0), sample=False)
    )(params, jnp.asarray(x))
    port.enable_fused() if fused else port.disable_fused()
    try:
        with torch.no_grad():
            got, got_post = port.forward(torch.from_numpy(x), sample=False)
    finally:
        port.disable_fused()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_post.mean.numpy(), np.asarray(post.mean), rtol=TOL, atol=TOL)


def test_forward_sample_with_injected_eps(models):
    """sample=True with the same eps in both packages (JAX draws its own, so
    the posterior is sampled by hand on the JAX side)."""
    jcfg, params, port = models
    x = _img(4, (1, 32, 32, 4))
    jvae = JaxRgbaVAE(config=jcfg)
    eps = np.random.default_rng(5).standard_normal((1, 16, 16, jcfg.latent_channels)).astype(np.float32)

    def jax_forward(p, v, e):
        post = jvae.encode(p, v * 2.0 - 1.0)
        return jnp.clip((jvae.decode(p, post.mean + post.std * e) + 1.0) / 2.0, 0.0, 1.0)

    want = jax.jit(jax_forward)(params, jnp.asarray(x), jnp.asarray(eps))
    with torch.no_grad():
        got, _ = port.forward(torch.from_numpy(x), eps=torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_checkpoint_saved_by_jax_loads_into_port(tmp_path, models):
    from ragb_vae_tpu.models.weights import save_autoencoder_params

    jcfg, params, port = models
    save_autoencoder_params(jcfg, params, tmp_path / "ae")
    loaded = RgbaVAE.from_pretrained_rgb(tmp_path, "ae")
    assert loaded.config.in_channels == 4
    for key, value in port.module.state_dict().items():
        torch.testing.assert_close(loaded.module.state_dict()[key], value, rtol=0, atol=0)


def test_rgb_checkpoint_is_widened_with_zero_alpha(tmp_path, models):
    from ragb_vae_tpu.models.weights import save_autoencoder_params

    jcfg, params, _ = models
    rgb_cfg = JaxAutoencoderConfig.tiny()
    rgb_params = jax.tree_util.tree_map(np.array, params)
    rgb_params["encoder"]["conv_in"]["kernel"] = rgb_params["encoder"]["conv_in"]["kernel"][:, :, :3]
    rgb_params["decoder"]["conv_out"]["kernel"] = rgb_params["decoder"]["conv_out"]["kernel"][..., :3]
    rgb_params["decoder"]["conv_out"]["bias"] = rgb_params["decoder"]["conv_out"]["bias"][:3]
    save_autoencoder_params(rgb_cfg, rgb_params, tmp_path / "vae")
    model = RgbaVAE.from_pretrained_rgb(tmp_path, "vae", alpha_bias_init=0.5)
    sd = model.module.state_dict()
    assert model.config.in_channels == model.config.out_channels == 4
    assert torch.all(sd["encoder.conv_in.weight"][:, 3] == 0)
    assert torch.all(sd["decoder.conv_out.weight"][3] == 0)
    assert sd["decoder.conv_out.bias"][3].item() == 0.5


def test_fused_block_weight_cache_follows_the_weights():
    """The fused ResnetBlock keeps its kernel-layout weights across calls; an
    in-place write, a state-dict load and a cast must each reach the next
    call. Checked against the unfused block with the same weights."""
    from ragb_vae_tpu_torch.models.vae import ResnetBlock

    torch.manual_seed(0)
    fused, plain = ResnetBlock(8, 16, 4, fused=True), ResnetBlock(8, 16, 4, fused=False)
    x = torch.randn(2, 6, 5, 8)

    def agree():
        torch.testing.assert_close(fused(x)[0], plain(x)[0], rtol=TOL, atol=TOL)

    with torch.no_grad():
        plain.load_state_dict(fused.state_dict())
        agree()
        assert fused.__dict__["_derived_cache"], "fused weights are not kept across calls"
        for m in (fused, plain):
            m.conv1.weight.mul_(-2.0)
            m.conv_shortcut.bias.add_(0.5)
        agree()
        state = {k: torch.randn_like(v) * 0.2 for k, v in fused.state_dict().items()}
        fused.load_state_dict(state)
        plain.load_state_dict(state)
        agree()
        fused.double(), plain.double()
        x = x.double()
        agree()
