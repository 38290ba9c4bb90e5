"""Port of the FLUX transformer, latent packing and the flow-matching
scheduler against the JAX package (`FluxTransformerConfig.tiny()`).

One set of random numpy weights, in the JAX tree's structure, crosses over
through `params_from_flax` and loads with strict=True. fp32 on both sides;
2 double + 2 single blocks of matmuls, RMS/LayerNorms and softmax summed in
another order stay within 1e-4. Packing and the schedule are exact
reorderings / the same float32 arithmetic, so they must agree to 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragb_vae_tpu.models import scheduler as jsched
from ragb_vae_tpu.models.flux_transformer import FluxTransformer2D as JaxFlux
from ragb_vae_tpu.models.flux_transformer import FluxTransformerConfig as JaxFluxConfig
from ragb_vae_tpu.ops import packing as jpack
from ragb_vae_tpu_torch.models import flux_weights as tfw
from ragb_vae_tpu_torch.models import scheduler as tsched
from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformer2D, FluxTransformerConfig
from ragb_vae_tpu_torch.ops import packing as tpack

TOL = 1e-4


def random_flux_params(jcfg, seed=0):
    """Random numpy weights in the JAX transformer's tree structure (from
    eval_shape): kernels at lecun scale, everything else small and non-zero."""
    module = JaxFlux(jcfg, remat=False)
    dummy = dict(
        hidden_states=jnp.zeros((1, 8, jcfg.in_channels)),
        encoder_hidden_states=jnp.zeros((1, 4, jcfg.joint_attention_dim)),
        pooled_projections=jnp.zeros((1, jcfg.pooled_projection_dim)),
        timestep=jnp.zeros((1,)),
        img_ids=jnp.zeros((8, 3)),
        txt_ids=jnp.zeros((4, 3)),
        guidance=jnp.zeros((1,)) if jcfg.guidance_embeds else None,
    )
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), **dummy)["params"])
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.standard_normal(leaf.shape)
        if path[-1].key == "kernel":
            return (noise / np.sqrt(leaf.shape[0])).astype(np.float32)
        return (noise * 0.1 + (1.0 if path[-1].key == "weight" else 0.0)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _configs(guidance: bool):
    jcfg = dataclasses.replace(JaxFluxConfig.tiny(), guidance_embeds=guidance)
    tcfg = dataclasses.replace(FluxTransformerConfig.tiny(), guidance_embeds=guidance)
    return jcfg, tcfg


def _inputs(jcfg, bsz=2, img_seq=12, txt_seq=5, seed=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    ids = np.concatenate([np.zeros((img_seq, 1)), rng.integers(0, 6, (img_seq, 2))], 1)
    return dict(
        hidden_states=f(bsz, img_seq, jcfg.in_channels),
        encoder_hidden_states=f(bsz, txt_seq, jcfg.joint_attention_dim),
        pooled_projections=f(bsz, jcfg.pooled_projection_dim),
        timestep=rng.uniform(size=bsz).astype(np.float32),
        img_ids=ids.astype(np.float32),
        txt_ids=np.zeros((txt_seq, 3), np.float32),
        guidance=np.full((bsz,), 3.5, np.float32) if jcfg.guidance_embeds else None,
    )


@pytest.mark.parametrize("guidance", [True, False])
def test_transformer_matches_jax(guidance):
    jcfg, tcfg = _configs(guidance)
    params = random_flux_params(jcfg)
    port = FluxTransformer2D(tcfg)
    port.load_state_dict(tfw.params_from_flax(params), strict=True)
    inp = _inputs(jcfg)
    module = JaxFlux(jcfg, remat=False)
    want = jax.jit(lambda p, kw: module.apply({"params": p}, **kw))(
        params, {k: None if v is None else jnp.asarray(v) for k, v in inp.items()}
    )
    with torch.no_grad():
        got = port(**{k: None if v is None else torch.from_numpy(v) for k, v in inp.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_flux_params_round_trip_and_lora_keys():
    jcfg, tcfg = _configs(True)
    params = random_flux_params(jcfg)
    back = tfw.params_to_flax(tfw.params_from_flax(params))
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(leaves) == len(flat)
    for path, leaf in leaves:
        np.testing.assert_array_equal(leaf, flat[path])
    # a LoRA-carrying port model maps its adapters onto the JAX lora_a / lora_b leaves
    lora = FluxTransformer2D(tcfg, lora_rank=4, lora_alpha=8.0)
    tree = tfw.params_to_flax(lora.state_dict())
    a = tree["transformer_blocks_0"]["attn"]["to_q"]["lora_a"]
    b = tree["transformer_blocks_0"]["attn"]["to_q"]["lora_b"]
    assert a.shape == (tcfg.inner_dim, 4) and b.shape == (4, tcfg.inner_dim)
    assert not any(k.endswith(("lora_A", "lora_B")) for k in tfw.params_to_flux_state(lora.state_dict()))


def test_lora_bypass_matches_jax_lora_dense():
    from ragb_vae_tpu.models.flux_transformer import LoraDense as JaxLoraDense
    from ragb_vae_tpu_torch.models.flux_transformer import LoraDense

    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    kernel, bias = rng.standard_normal((8, 6)).astype(np.float32), rng.standard_normal(6).astype(np.float32)
    la, lb = rng.standard_normal((8, 2)).astype(np.float32), rng.standard_normal((2, 6)).astype(np.float32)
    params = {"base": {"kernel": kernel, "bias": bias}, "lora_a": la, "lora_b": lb}
    want = JaxLoraDense(6, lora_rank=2, lora_alpha=3.0).apply({"params": params}, jnp.asarray(x))
    layer = LoraDense(8, 6, lora_rank=2, lora_alpha=3.0)
    layer.load_state_dict({"weight": torch.from_numpy(kernel.T.copy()), "bias": torch.from_numpy(bias),
                           "lora_A": torch.from_numpy(la.T.copy()), "lora_B": torch.from_numpy(lb.T.copy())})
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_packing_matches_jax():
    lat = np.random.default_rng(3).standard_normal((2, 6, 8, 4)).astype(np.float32)
    packed = tpack.pack_latents(torch.from_numpy(lat))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpack.pack_latents(jnp.asarray(lat))))
    np.testing.assert_array_equal(tpack.unpack_latents(packed, 6, 8).numpy(), lat)
    np.testing.assert_array_equal(
        tpack.prepare_latent_image_ids(3, 4).numpy(), np.asarray(jpack.prepare_latent_image_ids(3, 4))
    )
    assert tpack.latent_dims_for_pixels(600, 400) == jpack.latent_dims_for_pixels(600, 400)


@pytest.mark.parametrize("steps,seq_len", [(4, 1024), (20, 4096), (7, None)])
def test_scheduler_timesteps_and_sigmas_match_jax(steps, seq_len):
    jcfg, tcfg = jsched.FlowMatchEulerConfig(), tsched.FlowMatchEulerConfig()
    mu_j, mu_t = jsched.calc_mu(jcfg, seq_len), tsched.calc_mu(tcfg, seq_len)
    assert mu_t == mu_j
    js, ts = jsched.FlowMatchEulerScheduler(jcfg), tsched.FlowMatchEulerScheduler(tcfg)
    js.set_timesteps(steps, mu=mu_j)
    ts.set_timesteps(steps, mu=mu_t)
    np.testing.assert_array_equal(ts.sigmas, js.sigmas)
    np.testing.assert_array_equal(ts.timesteps, js.timesteps)
    v = np.random.default_rng(4).standard_normal((1, 2, 2, 4)).astype(np.float32)
    x = np.random.default_rng(5).standard_normal((1, 2, 2, 4)).astype(np.float32)
    np.testing.assert_allclose(
        ts.step(torch.from_numpy(v), 1, torch.from_numpy(x)).numpy(),
        np.asarray(js.step(jnp.asarray(v), 1, jnp.asarray(x))), rtol=1e-6, atol=1e-6,
    )


def test_static_shift_schedule_matches_jax():
    jcfg = jsched.FlowMatchEulerConfig(use_dynamic_shifting=False)
    tcfg = tsched.FlowMatchEulerConfig(use_dynamic_shifting=False)
    js, ts = jsched.FlowMatchEulerScheduler(jcfg), tsched.FlowMatchEulerScheduler(tcfg)
    js.set_timesteps(10)
    ts.set_timesteps(10)
    np.testing.assert_array_equal(ts.sigmas, js.sigmas)
    with pytest.raises(ValueError):
        tsched.FlowMatchEulerScheduler().step(torch.zeros(1), 0, torch.zeros(1))
