"""The LoRA training loss of the port against the JAX package: timestep
density and SD3 weighting, the train-time schedule, `compute_loss_from_latents`
with injected noise and density on `FluxTransformerConfig.tiny()`, the adapter
gradient tree leaf by leaf, and the peft file format both ways.

One set of random numpy weights (base and non-zero adapters) in the JAX
tree's structure crosses over through `params_from_flax` (strict). fp32 on
both sides. The loss is a mean of squares over 2 double + 2 single blocks:
1e-4 relative, as the forward parity. A gradient leaf sums products over
tokens and batch in another order in the two frameworks: 2e-3 relative with
an absolute floor of 2e-6 (leaves are of order 1e-3..1e-1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragb_vae_tpu.models import flux_weights as jfw
from ragb_vae_tpu.models import scheduler as jsched
from ragb_vae_tpu.models import weights as jw
from ragb_vae_tpu.models.flux_kontext_textalpha import FluxTextAlphaModel as JaxModel
from ragb_vae_tpu.models.flux_transformer import FluxTransformer2D as JaxFlux
from ragb_vae_tpu.models.flux_transformer import FluxTransformerConfig as JaxFluxConfig
from ragb_vae_tpu.models.rgba_vae import RgbaVAE as JaxRgbaVAE
from ragb_vae_tpu.models.scheduler import FlowMatchEulerScheduler as JaxScheduler
from ragb_vae_tpu.models.vae_config import AutoencoderConfig as JaxAutoencoderConfig
from ragb_vae_tpu_torch.models import flux_weights as tfw
from ragb_vae_tpu_torch.models import scheduler as tsched
from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel, init_random_
from ragb_vae_tpu_torch.models.flux_transformer import (
    FluxTransformer2D,
    FluxTransformerConfig,
    LoraDense,
    freeze_base_parameters,
    lora_target_modules,
)
from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
from ragb_vae_tpu_torch.models.scheduler import FlowMatchEulerScheduler
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig

LOSS_TOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-6
RANK, ALPHA = 4, 6.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: tiny tensors gain
    nothing from intra-op threads, and the workers stop fighting for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def random_lora_flux_params(jcfg, seed=0):
    """Random numpy weights in the tree of the JAX transformer WITH adapters:
    kernels at lecun scale, lora_a / lora_b and everything else small and
    non-zero (a zero lora_b would leave lora_a without a gradient)."""
    module = JaxFlux(jcfg, lora_rank=RANK, lora_alpha=ALPHA, remat=False)
    dummy = dict(
        hidden_states=jnp.zeros((1, 8, jcfg.in_channels)),
        encoder_hidden_states=jnp.zeros((1, 4, jcfg.joint_attention_dim)),
        pooled_projections=jnp.zeros((1, jcfg.pooled_projection_dim)),
        timestep=jnp.zeros((1,)), img_ids=jnp.zeros((8, 3)), txt_ids=jnp.zeros((4, 3)),
        guidance=jnp.zeros((1,)),
    )
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), **dummy)["params"])
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.standard_normal(leaf.shape)
        if path[-1].key == "kernel":
            return (noise / np.sqrt(leaf.shape[0])).astype(np.float32)
        return (noise * 0.1 + (1.0 if path[-1].key == "weight" else 0.0)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    jt_cfg, tt_cfg = JaxFluxConfig.tiny(), FluxTransformerConfig.tiny()
    jv_cfg, tv_cfg = JaxAutoencoderConfig.tiny(), AutoencoderConfig.tiny()
    jv_cfg.in_channels = jv_cfg.out_channels = tv_cfg.in_channels = tv_cfg.out_channels = 4
    params = random_lora_flux_params(jt_cfg, seed=1)
    prompt = rng.standard_normal((1, 4, jt_cfg.joint_attention_dim)).astype(np.float32)
    pooled = rng.standard_normal((1, jt_cfg.pooled_projection_dim)).astype(np.float32)
    text_ids = np.zeros((4, 3), np.float32)
    jmodel = JaxModel(
        transformer_config=jt_cfg, vae=JaxRgbaVAE(config=jv_cfg), scheduler=JaxScheduler(),
        prompt_embeds=jnp.asarray(prompt), pooled_prompt_embeds=jnp.asarray(pooled),
        text_ids=jnp.asarray(text_ids), lora_rank=RANK, lora_alpha=ALPHA, remat=False,
    )
    transformer = FluxTransformer2D(tt_cfg, lora_rank=RANK, lora_alpha=ALPHA)
    transformer.load_state_dict(tfw.params_from_flax(params), strict=True)
    freeze_base_parameters(transformer)
    torch.manual_seed(0)
    tmodel = FluxTextAlphaModel(
        transformer.eval(), RgbaVAE(tv_cfg), FlowMatchEulerScheduler(), torch.from_numpy(prompt),
        torch.from_numpy(pooled), torch.from_numpy(text_ids), lora_rank=RANK, lora_alpha=ALPHA,
    )
    return jmodel, params, tmodel


def _latents(seed=2, bsz=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bsz, 8, 8, 4)).astype(np.float32) for _ in range(3)]


# ---------------------------------------------------------------------------
# density, weighting, schedule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheme", ["logit_normal", "mode", "uniform"])
def test_density_matches_jax_on_the_same_draw(scheme):
    key = jax.random.PRNGKey(3)
    kw = dict(weighting_scheme=scheme, logit_mean=0.3, logit_std=1.2, mode_scale=1.1)
    want = jsched.compute_density_for_timestep_sampling(key, 16, **kw)
    raw = jax.random.normal(key, (16,)) if scheme == "logit_normal" else jax.random.uniform(key, (16,))
    got = tsched.compute_density_for_timestep_sampling(None, 16, draw=torch.from_numpy(np.array(raw)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scheme", ["logit_normal", "mode", "uniform"])
def test_density_draws_from_the_generator(scheme):
    draw = lambda seed: tsched.compute_density_for_timestep_sampling(
        torch.Generator().manual_seed(seed), 64, weighting_scheme=scheme)
    a, b, c = draw(1), draw(1), draw(2)
    assert a.shape == (64,) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool((a > 0).all()) and bool((a < 1).all())


@pytest.mark.parametrize("scheme", ["logit_normal", "sigma_sqrt", "cosmap"])
def test_loss_weighting_matches_jax(scheme):
    sigmas = np.random.default_rng(4).uniform(0.05, 1.0, (3, 1, 1, 1)).astype(np.float32)
    want = jsched.compute_loss_weighting_for_sd3(jnp.asarray(sigmas), weighting_scheme=scheme)
    got = tsched.compute_loss_weighting_for_sd3(torch.from_numpy(sigmas), weighting_scheme=scheme)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_train_schedule_matches_jax(pair):
    jmodel, _, tmodel = pair
    assert len(tmodel._train_sched.timesteps) == 1000 and len(tmodel._train_sched.sigmas) == 1001
    np.testing.assert_array_equal(tmodel._train_sched.sigmas, jmodel._train_sched.sigmas)
    np.testing.assert_array_equal(tmodel._train_sched.timesteps, jmodel._train_sched.timesteps)


# ---------------------------------------------------------------------------
# the loss and its gradient tree
# ---------------------------------------------------------------------------
def _port_loss_and_grads(tmodel, cond, target, noise, u, weights):
    for p in tmodel.transformer.parameters():
        p.grad = None
    loss, stats = tmodel.compute_loss_from_latents(
        *(torch.from_numpy(a) for a in (cond, target, noise, u)),
        weights=None if weights is None else torch.from_numpy(weights))
    loss.backward()
    return loss, stats


@pytest.mark.parametrize("weights", [None, np.asarray([1.0, 0.25], np.float32)], ids=["mean", "weighted"])
def test_loss_stats_and_adapter_gradients_match_jax(pair, weights):
    """u = 1.0 lands on index 1000, past the 1000 timesteps: both clip it to 999."""
    jmodel, params, tmodel = pair
    cond, target, noise = _latents()
    u = np.asarray([0.3, 1.0], np.float32)
    base, lora = jfw.split_lora_params(params)

    def jax_loss(lora_tree):
        return jmodel.compute_loss_from_latents(
            jfw.merge_params(base, lora_tree), *(jnp.asarray(a) for a in (cond, target, noise, u)),
            weights=None if weights is None else jnp.asarray(weights))

    (want_loss, want_stats), want_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(lora)
    loss, stats = _port_loss_and_grads(tmodel, cond, target, noise, u, weights)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_TOL)
    for key in ("timesteps_mean", "sigmas_mean"):
        np.testing.assert_allclose(stats[key].item(), float(want_stats[key]), rtol=1e-6)

    got_grads = tfw.lora_grads_to_flax(tmodel.transformer)
    want_leaves = jax.tree_util.tree_leaves_with_path(want_grads)
    got_flat = dict(jax.tree_util.tree_leaves_with_path(got_grads))
    assert len(want_leaves) == len(got_flat) == 2 * len(lora_target_modules(tmodel.transformer))
    for path, leaf in want_leaves:
        want = np.asarray(leaf)
        assert np.abs(want).max() > 0, path
        np.testing.assert_allclose(got_flat[path], want, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=jax.tree_util.keystr(path))
    # the base is frozen: no gradient reaches it
    assert all(p.grad is None for n, p in tmodel.transformer.named_parameters() if not tfw.is_lora_key(n))


def test_zero_weight_sample_changes_nothing(pair):
    """A padding row (weight 0) leaves loss and gradients as the batch without it."""
    _, _, tmodel = pair
    cond, target, noise = _latents(seed=5)
    u = np.asarray([0.4, 0.7], np.float32)
    loss_pad, _ = _port_loss_and_grads(tmodel, cond, target, noise, u, np.asarray([1.0, 0.0], np.float32))
    grads_pad = {k: p.grad.clone() for k, p in tfw.lora_parameters(tmodel.transformer).items()}
    loss_one, _ = _port_loss_and_grads(tmodel, cond[:1], target[:1], noise[:1], u[:1], None)
    np.testing.assert_allclose(loss_pad.item(), loss_one.item(), rtol=1e-5)
    for key, p in tfw.lora_parameters(tmodel.transformer).items():
        np.testing.assert_allclose(grads_pad[key].numpy(), p.grad.numpy(), rtol=1e-4, atol=1e-7, err_msg=key)


def test_remat_changes_neither_loss_nor_gradients(pair):
    _, _, tmodel = pair
    cond, target, noise = _latents(seed=6)
    u = np.asarray([0.2, 0.8], np.float32)
    results = []
    try:
        for remat in (False, True):
            tmodel.transformer.remat = remat
            loss, _ = _port_loss_and_grads(tmodel, cond, target, noise, u, None)
            results.append((loss.item(), [p.grad.clone() for p in tfw.lora_parameters(tmodel.transformer).values()]))
    finally:
        tmodel.transformer.remat = False
    assert results[0][0] == results[1][0]
    assert all(torch.equal(a, b) for a, b in zip(results[0][1], results[1][1]))


def test_remat_is_off_without_a_gradient(pair, monkeypatch):
    """Under no_grad (serving, validation) no block goes through checkpoint."""
    from ragb_vae_tpu_torch.models import flux_transformer as ft

    _, _, tmodel = pair
    calls = []
    real = ft.checkpoint
    monkeypatch.setattr(ft, "checkpoint", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    cond, target, noise = (torch.from_numpy(a) for a in _latents(seed=7))
    u = torch.tensor([0.5, 0.5])
    tmodel.transformer.remat = True
    try:
        with torch.no_grad():
            tmodel.compute_loss_from_latents(cond, target, noise, u)
        assert not calls
        tmodel.compute_loss_from_latents(cond, target, noise, u)
        assert len(calls) == 4  # 2 double + 2 single blocks
    finally:
        tmodel.transformer.remat = False


def test_compute_loss_draws_from_one_generator_and_keeps_the_vae_out_of_the_graph(pair):
    _, _, tmodel = pair
    rng = np.random.default_rng(8)
    gt, ta = (torch.from_numpy(rng.uniform(size=(2, 16, 16, 4)).astype(np.float32)) for _ in range(2))
    run = lambda seed: tmodel.compute_loss(gt, ta, torch.Generator().manual_seed(seed))
    (a, stats), (b, _), (c, _) = run(1), run(1), run(2)
    assert a.item() == b.item() and a.item() != c.item()
    assert set(stats) == {"timesteps_mean", "sigmas_mean"}
    for p in list(tmodel.vae.module.parameters()) + list(tmodel.transformer.parameters()):
        p.grad = None
    a.backward()
    assert all(p.grad is None for p in tmodel.vae.module.parameters())
    assert all(p.grad is not None for p in tfw.lora_parameters(tmodel.transformer).values())
    # four draws in a fixed order: cond eps, target eps, noise, density
    gen, ref = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    tmodel.compute_loss(gt, ta, gen)
    for _ in range(3):
        torch.randn((2, 8, 8, 4), generator=ref)
    torch.randn((2,), generator=ref)
    assert torch.equal(gen.get_state(), ref.get_state())


# ---------------------------------------------------------------------------
# adapters: dtype, targets, init
# ---------------------------------------------------------------------------
def test_adapters_stay_fp32_under_a_bf16_base():
    layer = LoraDense(8, 6, lora_rank=2, lora_alpha=4.0, dtype=torch.bfloat16)
    assert layer.weight.dtype == torch.bfloat16
    assert layer.lora_A.dtype == layer.lora_B.dtype == torch.float32
    with torch.no_grad():
        layer.lora_B.normal_()
    y = layer(torch.randn(3, 8))
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert layer.lora_A.grad.dtype == layer.lora_B.grad.dtype == torch.float32
    assert layer.lora_A.grad.abs().max() > 0


def test_random_init_and_flax_weights_keep_the_adapters_fp32():
    cfg = FluxTransformerConfig.tiny()
    model = FluxTransformer2D(cfg, lora_rank=RANK, lora_alpha=ALPHA, device="meta",
                              dtype=torch.bfloat16).to_empty(device="cpu")
    init_random_(model, torch.Generator().manual_seed(0))
    lora = tfw.lora_parameters(model)
    assert lora and all(p.dtype == torch.float32 for p in lora.values())
    assert all(float(p.detach().abs().max()) == 0.0 for k, p in lora.items() if k.endswith("lora_B"))
    assert all(float(p.detach().abs().max()) > 0.0 for k, p in lora.items() if k.endswith("lora_A"))
    model.load_state_dict(tfw.params_from_flax(random_lora_flux_params(JaxFluxConfig.tiny())), strict=True)
    assert all(p.dtype == torch.float32 for p in tfw.lora_parameters(model).values())
    assert model.x_embedder.weight.dtype == torch.bfloat16


def test_lora_targets_and_freeze():
    cfg = FluxTransformerConfig.tiny()
    model = FluxTransformer2D(cfg, lora_rank=RANK, lora_alpha=ALPHA)
    targets = lora_target_modules(model)
    # 12 linears per double block (8 attention, 4 feed-forward), 3 per single block
    assert len(targets) == 12 * cfg.num_layers + 3 * cfg.num_single_layers
    assert all(m.lora_rank == RANK for _, m in targets)
    others = [m for m in model.modules() if isinstance(m, LoraDense) and m.lora_rank == 0]
    assert others and model.x_embedder.lora_rank == 0 and model.single_transformer_blocks[0].proj_out.lora_rank == 0
    adapters = freeze_base_parameters(model)
    assert len(adapters) == 2 * len(targets)
    assert {n for n, p in model.named_parameters() if p.requires_grad} == set(tfw.lora_parameters(model))


def test_init_lora_attaches_adapters_to_a_plain_model_and_needs_a_rank(pair):
    cfg = FluxTransformerConfig.tiny()
    vcfg = AutoencoderConfig.tiny()
    vcfg.in_channels = vcfg.out_channels = 4
    model = FluxTextAlphaModel.random(cfg, vcfg, seed=0, device="cpu", prompt_len=4)
    assert not tfw.lora_parameters(model.transformer)
    with pytest.raises(ValueError, match="lora_rank"):
        model.init_lora()
    model.lora_rank, model.lora_alpha = 2, 4.0
    model.init_lora(torch.Generator().manual_seed(0))
    lora = tfw.lora_parameters(model.transformer)
    assert len(lora) == 2 * len(lora_target_modules(model.transformer))
    assert model.transformer.transformer_blocks[0].attn.to_q.scaling == 2.0
    with_rank = FluxTextAlphaModel.random(cfg, vcfg, seed=0, device="cpu", prompt_len=4, lora_rank=2, lora_alpha=4.0,
                                          use_gradient_checkpointing=False)
    assert set(tfw.lora_parameters(with_rank.transformer)) == set(lora)
    assert with_rank.transformer.remat is False and model.transformer.remat is True
    # same seed, same base: the adapters are drawn after it
    assert torch.equal(with_rank.transformer.x_embedder.weight, model.transformer.x_embedder.weight)


# ---------------------------------------------------------------------------
# peft files, both ways
# ---------------------------------------------------------------------------
def test_peft_file_written_by_the_port_loads_in_jax(pair, tmp_path):
    jmodel, params, tmodel = pair
    tmodel.save_lora_weights(tmp_path)
    state = jw.load_torch_state(tmp_path / "pytorch_lora_weights.safetensors")
    assert all(k.startswith("transformer.") and k.endswith(".weight") for k in state)
    assert "transformer.transformer_blocks.0.attn.to_out.0.lora_A.weight" in state
    assert "transformer.transformer_blocks.1.ff.net.0.proj.lora_B.weight" in state
    base, lora = jfw.split_lora_params(params)
    loaded = jfw.split_lora_params(jmodel.load_lora(base, tmp_path))[1]
    want = dict(jax.tree_util.tree_leaves_with_path(lora))
    got = jax.tree_util.tree_leaves_with_path(loaded)
    assert len(got) == len(want)
    for path, leaf in got:
        np.testing.assert_array_equal(np.asarray(leaf), want[path])


def test_peft_file_written_by_jax_loads_in_the_port(pair, tmp_path):
    jmodel, params, tmodel = pair
    rng = np.random.default_rng(9)
    _, lora = jfw.split_lora_params(params)
    other = jax.tree_util.tree_map(lambda x: rng.standard_normal(x.shape).astype(np.float32), lora)
    jmodel.save_lora_weights(other, tmp_path)
    before = tfw.lora_state(tmodel.transformer)
    try:
        tmodel.load_lora(tmp_path)
        back = tfw.params_to_flax(tfw.lora_state(tmodel.transformer))
        want = dict(jax.tree_util.tree_leaves_with_path(other))
        got = jax.tree_util.tree_leaves_with_path(back)
        assert len(got) == len(want)
        for path, leaf in got:
            np.testing.assert_array_equal(leaf, want[path])
    finally:
        tfw.load_lora_state(tmodel.transformer, before)


def test_peft_keys_with_default_adapter_names_and_bin_files(pair, tmp_path):
    _, _, tmodel = pair
    state = tmodel.lora_state_dict()
    nested = {k.replace(".lora_A.weight", ".lora_A.default.weight")
               .replace(".lora_B.weight", ".lora_B.default.weight"): v for k, v in state.items()}
    nested["transformer.x_embedder.weight"] = torch.zeros(1)   # not an adapter: skipped
    lora = tfw.peft_state_to_lora_params(nested)
    assert set(lora) == set(tfw.lora_parameters(tmodel.transformer))
    torch.save(state, tmp_path / "pytorch_lora_weights.bin")
    tmodel.load_lora(tmp_path)                                  # .bin when no .safetensors is there
    with pytest.raises(FileNotFoundError):
        tmodel.load_lora(tmp_path / "nowhere")
    with pytest.raises(KeyError, match="does not fit"):
        tfw.load_lora_state(tmodel.transformer, {"x_embedder.lora_A": torch.zeros(1)})
