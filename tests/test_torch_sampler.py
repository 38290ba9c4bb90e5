"""The serving slice as a whole, port against JAX: RGBA-VAE encode with an
injected posterior eps, the flow-matching sampler with injected initial and
per-step noises (`sample_latents_from_noise`), then decode and clip.

Tiny transformer and VAE, one set of random numpy weights in both packages.
fp32; each step's transformer error (~1e-5) feeds the next step, so the
trajectory is held to 1e-3 and the decoded image (through the VAE, then
clipped) to 1e-3 as well.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragb_vae_tpu.models.flux_kontext_textalpha import FluxTextAlphaModel as JaxModel
from ragb_vae_tpu.models.rgba_vae import RgbaVAE as JaxRgbaVAE
from ragb_vae_tpu.models.scheduler import FlowMatchEulerScheduler as JaxScheduler
from ragb_vae_tpu.models.vae_config import AutoencoderConfig as JaxAutoencoderConfig
from ragb_vae_tpu.models.flux_transformer import FluxTransformerConfig as JaxFluxConfig
from ragb_vae_tpu_torch.models import flux_weights as tfw
from ragb_vae_tpu_torch.models import weights as tw
from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel
from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformer2D, FluxTransformerConfig
from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
from ragb_vae_tpu_torch.models.scheduler import FlowMatchEulerScheduler
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
from tests.test_torch_flux import random_flux_params
from tests.test_torch_vae import _random_params as random_vae_params

TRAJ_TOL = 1e-3
IMAGE_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: tiny tensors gain
    nothing from intra-op threads, and the workers stop fighting for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    jt_cfg, tt_cfg = JaxFluxConfig.tiny(), FluxTransformerConfig.tiny()
    jv_cfg, tv_cfg = JaxAutoencoderConfig.tiny(), AutoencoderConfig.tiny()
    jv_cfg.in_channels = jv_cfg.out_channels = tv_cfg.in_channels = tv_cfg.out_channels = 4
    t_params, v_params = random_flux_params(jt_cfg, seed=1), random_vae_params(jv_cfg, seed=2)
    prompt = rng.standard_normal((1, 4, jt_cfg.joint_attention_dim)).astype(np.float32)
    pooled = rng.standard_normal((1, jt_cfg.pooled_projection_dim)).astype(np.float32)
    text_ids = np.zeros((4, 3), np.float32)
    jmodel = JaxModel(
        transformer_config=jt_cfg, vae=JaxRgbaVAE(config=jv_cfg), scheduler=JaxScheduler(),
        prompt_embeds=jnp.asarray(prompt), pooled_prompt_embeds=jnp.asarray(pooled),
        text_ids=jnp.asarray(text_ids), remat=False,
    )
    transformer = FluxTransformer2D(tt_cfg)
    transformer.load_state_dict(tfw.params_from_flax(t_params), strict=True)
    vae = RgbaVAE(tv_cfg, fused=True)
    vae.module.load_state_dict(tw.params_from_flax(v_params), strict=True)
    tmodel = FluxTextAlphaModel(
        transformer, vae, FlowMatchEulerScheduler(), torch.from_numpy(prompt),
        torch.from_numpy(pooled), torch.from_numpy(text_ids),
    )
    return jmodel, t_params, v_params, tmodel


def test_slice_matches_jax_with_injected_noise(pair):
    jmodel, t_params, v_params, tmodel = pair
    rng = np.random.default_rng(3)
    bsz, steps = 2, 4
    gt = rng.uniform(size=(bsz, 32, 32, 4)).astype(np.float32)
    lat_shape = (bsz, 16, 16, 4)
    eps, init = (rng.standard_normal(lat_shape).astype(np.float32) for _ in range(2))
    step_noises = rng.standard_normal((steps,) + lat_shape).astype(np.float32)

    def jax_slice(tp, vp, gt, eps, init, noises):
        post = jmodel.vae.encode(vp, gt * 2.0 - 1.0)
        cond = (post.mean + post.std * eps - jmodel.shift_factor) * jmodel.scaling_factor
        final, traj = jmodel.sample_latents_from_noise(tp, cond, init, noises, return_trajectory=True)
        dec = jmodel.vae.decode(vp, final / jmodel.scaling_factor + jmodel.shift_factor)
        return cond, traj, jnp.clip((dec + 1.0) / 2.0, 0.0, 1.0)

    cond_j, traj_j, img_j = jax.jit(jax_slice)(
        t_params, v_params, *(jnp.asarray(a) for a in (gt, eps, init, step_noises))
    )
    with torch.no_grad():
        cond_t = tmodel.encode_latents(torch.from_numpy(gt), torch.from_numpy(eps))
        final_t, traj_t = tmodel.sample_latents_from_noise(
            cond_t, torch.from_numpy(init), torch.from_numpy(step_noises), return_trajectory=True
        )
        img_t = tmodel.decode_latents(final_t)
    np.testing.assert_allclose(cond_t.numpy(), np.asarray(cond_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(traj_t.numpy(), np.asarray(traj_j), rtol=TRAJ_TOL, atol=TRAJ_TOL)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=IMAGE_TOL, atol=IMAGE_TOL)
    np.testing.assert_array_equal(final_t.numpy(), traj_t[-1].numpy())


def test_schedule_matches_jax(pair):
    jmodel, _, _, tmodel = pair
    js, ts = jmodel.sampling_schedule(6), tmodel.sampling_schedule(6)
    np.testing.assert_array_equal(ts.sigmas, js.sigmas)
    np.testing.assert_array_equal(ts.timesteps, js.timesteps)


@pytest.mark.parametrize("per_sample", [False, True], ids=["float-sigma", "per-sample-sigma"])
def test_scale_noise_matches_jax(per_sample):
    rng = np.random.default_rng(5)
    x0, noise = (rng.standard_normal((2, 16, 8)).astype(np.float32) for _ in range(2))
    js, ts = JaxScheduler(), FlowMatchEulerScheduler()
    sigma = rng.uniform(size=(2, 1, 1)).astype(np.float32) if per_sample else float(ts.sigmas[3])
    want = np.asarray(js.scale_noise(jnp.asarray(x0), jnp.asarray(sigma) if per_sample else sigma,
                                     jnp.asarray(noise)))
    got = ts.scale_noise(torch.from_numpy(x0), torch.from_numpy(sigma) if per_sample else sigma,
                         torch.from_numpy(noise))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_per_step_noise_is_consumed(pair):
    """The reference's re-noising quirk is live: changing only step 2's noise
    leaves steps 0-1 bit-identical and moves step 2."""
    _, _, _, tmodel = pair
    rng = np.random.default_rng(4)
    cond, init = (torch.from_numpy(rng.standard_normal((1, 4, 4, 4)).astype(np.float32)) for _ in range(2))
    noises = torch.from_numpy(rng.standard_normal((4, 1, 4, 4, 4)).astype(np.float32))
    with torch.no_grad():
        _, a = tmodel.sample_latents_from_noise(cond, init, noises, return_trajectory=True)
        noises[2] += 1.0
        _, b = tmodel.sample_latents_from_noise(cond, init, noises, return_trajectory=True)
    assert torch.equal(a[:2], b[:2])
    assert (a[2] - b[2]).abs().max() > 1e-4


def test_sample_is_deterministic_per_generator(pair):
    _, _, _, tmodel = pair
    gt = torch.from_numpy(np.random.default_rng(5).uniform(size=(1, 32, 32, 4)).astype(np.float32))
    a = tmodel.sample(gt, num_inference_steps=2, generator=torch.Generator().manual_seed(7))
    b = tmodel.sample(gt, num_inference_steps=2, generator=torch.Generator().manual_seed(7))
    c = tmodel.sample(gt, num_inference_steps=2, generator=torch.Generator().manual_seed(8))
    assert a.shape == (1, 32, 32, 4)
    assert torch.equal(a, b) and not torch.equal(a, c)
