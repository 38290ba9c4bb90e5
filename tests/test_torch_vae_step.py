"""The port's RGBA-VAE training slice as a whole against the JAX package's
compiled step: `training/vae_step.py` over `parallel/grad_accum.py`, the
losses, LPIPS, the triplet, the posterior and the VAE.

Tiny VAE (`AutoencoderConfig.tiny()`, 4 channels in and out), one set of
random numpy weights in both packages (`params_from_flax`), a frozen
reference with other weights, LPIPS over one random state dict, 32x32
images, the scales of configs/flux_vae.yaml raised so that every term
matters. The posterior noise is the JAX step's own: drawn on the JAX side
from the step's key exactly as `accumulated_grads` splits it, and injected
into the port as `eps`.

fp32 on both sides. Losses and metrics are sums in another order: 1e-4
relative. Gradients pass ~30 convs and GroupNorms in another summation
order: each leaf to 2e-3 of its largest entry. The parameters after two
optimizer steps are held in `tests/test_torch_vae_step_adamw.py`.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragb_vae_tpu.models import losses as jl
from ragb_vae_tpu.models import lpips as jlp
from ragb_vae_tpu.models.rgba_vae import RgbaVAE as JaxRgbaVAE
from ragb_vae_tpu.parallel import accumulated_grads as jax_accumulated_grads
from ragb_vae_tpu.training import vae_step as jvs
from ragb_vae_tpu_torch.models import losses as tl
from ragb_vae_tpu_torch.models import lpips as tlp
from ragb_vae_tpu_torch.models import weights as tw
from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
from ragb_vae_tpu_torch.parallel.grad_accum import accumulated_grads, split_microbatches
from ragb_vae_tpu_torch.parallel.mesh import Mesh
from ragb_vae_tpu_torch.parallel.zero_step import ZeroAdamW
from ragb_vae_tpu_torch.training import vae_step as tvs
from test_torch_vae import _configs, _random_params
from torch_lpips_ref import make_lpips_state

METRIC_RTOL = 1e-4
GRAD_TOL = 2e-3
LR = 1e-3
SCALES = dict(kl_scale=1e-4, ref_kl_scale=1e-3, lpips_scale=0.5)
WEIGHTS = np.array([1.0, 0.5, 0.0, 0.0], np.float32)   # the second microbatch of two is all padding


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: tiny tensors gain
    nothing from intra-op threads, and the workers stop fighting for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jcfg, tcfg = _configs()
    params, ref_params = _random_params(jcfg, seed=0), _random_params(jcfg, seed=1)
    path = tmp_path_factory.mktemp("lpips") / "lpips_vgg.pt"
    torch.save({k: torch.from_numpy(v) for k, v in make_lpips_state(seed=0).items()}, path)
    images = np.random.default_rng(2).uniform(size=(4, 32, 32, 4)).astype(np.float32)
    return {"jcfg": jcfg, "tcfg": tcfg, "params": params, "ref_params": ref_params,
            "jlpips": jlp.maybe_build_lpips(path), "tlpips": tlp.maybe_build_lpips(path), "images": images}


def _port_models(world, *, fused=False, remat="none"):
    model = RgbaVAE(world["tcfg"], fused=fused, remat=remat)
    model.module.load_state_dict(tw.params_from_flax(world["params"]), strict=True)
    ref = RgbaVAE(world["tcfg"])
    ref.module.load_state_dict(tw.params_from_flax(world["ref_params"]), strict=True)
    ref.module.requires_grad_(False)
    return model, ref


def _jax_eps(key, accum, latent_shape):
    """The noise the JAX step draws: one key for a single microbatch, else
    `split(key, accum)` with one draw per microbatch, in order."""
    keys = [key] if accum <= 1 else list(jax.random.split(key, accum))
    per = (latent_shape[0] // max(accum, 1),) + latent_shape[1:]
    return np.concatenate([np.asarray(jax.random.normal(k, per, jnp.float32)) for k in keys])


def _batches(world, weighted):
    jb = {"images": jnp.asarray(world["images"])}
    tb = {"images": torch.from_numpy(world["images"])}
    if weighted:
        jb["weights"], tb["weights"] = jnp.asarray(WEIGHTS), torch.from_numpy(WEIGHTS)
    return jb, tb


def _assert_tree_close(got, want, *, rel, what):
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        leaf = np.asarray(leaf)
        np.testing.assert_allclose(flat_got[path], leaf, rtol=0, atol=rel * np.abs(leaf).max() + 1e-9,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("accum,weighted", [(1, False), (2, True)], ids=["accum1", "accum2-padded"])
def test_loss_metrics_and_gradient_tree_match_jax(world, accum, weighted):
    jvae = JaxRgbaVAE(config=world["jcfg"])
    loss_kw = dict(loss_cfg=jl.AlphaVaeLossConfig(reduce_mean=True),
                   step_cfg=jvs.VaeStepConfig(gradient_accumulation_steps=accum, **SCALES),
                   ref_params=world["ref_params"], lpips_fn=world["jlpips"])
    jb, tb = _batches(world, weighted)
    key = jax.random.PRNGKey(7)
    jloss = partial(jvs.vae_loss_fn, model=jvae, **loss_kw)
    want_loss, want_metrics, want_grads = jax.jit(
        lambda p, b, k: jax_accumulated_grads(
            jloss, p, b, k, accum,
            micro_weight_fn=(lambda mb: jnp.sum(mb["weights"])) if weighted else None)
    )(world["params"], jb, key)

    model, ref = _port_models(world)
    step_cfg = tvs.VaeStepConfig(gradient_accumulation_steps=accum, **SCALES)
    eps = torch.from_numpy(_jax_eps(key, accum, (4, 16, 16, 4))).chunk(accum)

    def loss(micro, index):
        return tvs.vae_loss_fn(model, micro, loss_cfg=tl.AlphaVaeLossConfig(reduce_mean=True),
                               step_cfg=step_cfg, ref_model=ref, lpips_fn=world["tlpips"], eps=eps[index])

    got_loss, got_metrics = accumulated_grads(
        loss, tvs.trainable_parameters(model), tb, accum,
        micro_weight_fn=(lambda mb: mb["weights"].sum()) if weighted else None)

    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=METRIC_RTOL)
    assert set(got_metrics) == set(want_metrics) == {
        "train/recon", "train/lpips", "train/kl", "train/ref_kl", "train/loss"}
    for name, value in want_metrics.items():
        np.testing.assert_allclose(got_metrics[name].item(), float(value), rtol=METRIC_RTOL, err_msg=name)
    _assert_tree_close(tw.grads_to_flax(model.module), want_grads, rel=GRAD_TOL, what="gradient")


def _port_grads(world, *, fused, remat):
    model, ref = _port_models(world, fused=fused, remat=remat)
    _, tb = _batches(world, True)
    eps = torch.from_numpy(_jax_eps(jax.random.PRNGKey(3), 1, (4, 16, 16, 4)))
    loss, _ = tvs.vae_loss_fn(model, tb, loss_cfg=tl.AlphaVaeLossConfig(reduce_mean=True),
                              step_cfg=tvs.VaeStepConfig(**SCALES), ref_model=ref,
                              lpips_fn=world["tlpips"], eps=eps)
    loss.backward()
    return loss.item(), tw.grads_to_flax(model.module)


@pytest.fixture(scope="module")
def unfused_grads(world):
    return _port_grads(world, fused=False, remat="none")


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("remat", ["all", "half"])
def test_remat_changes_no_gradient(world, unfused_grads, fused, remat):
    """Checkpointing recomputes the same arithmetic: the gradients are those
    of remat="none" on the same route (1e-6 of each leaf's largest entry;
    they are bitwise equal where the recompute repeats the same kernels)."""
    base_loss, base = unfused_grads if not fused else _port_grads(world, fused=True, remat="none")
    loss, grads = _port_grads(world, fused=fused, remat=remat)
    assert loss == base_loss
    _assert_tree_close(grads, base, rel=1e-6, what=f"remat={remat}")


def test_fused_route_gradients_equal_unfused(world, unfused_grads):
    """The fused modules (the kernels' plain versions on the CPU, statistics
    threaded from block to block) against the plain modules: same function,
    sums in another order."""
    base_loss, base = unfused_grads
    loss, grads = _port_grads(world, fused=True, remat="none")
    np.testing.assert_allclose(loss, base_loss, rtol=1e-5)
    _assert_tree_close(grads, base, rel=GRAD_TOL, what="fused")


def test_eval_step_metrics_match_jax(world):
    jvae = JaxRgbaVAE(config=world["jcfg"])
    key = jax.random.PRNGKey(11)
    want = jvs.make_eval_step(jvae, background_specs=("white", "black", 0.5))(
        world["params"], jnp.asarray(world["images"]), key)
    model, _ = _port_models(world)
    got = tvs.make_eval_step(model, background_specs=("white", "black", 0.5))(
        torch.from_numpy(world["images"]), eps=torch.from_numpy(_jax_eps(key, 1, (4, 16, 16, 4))))
    assert set(got) == set(want) == {"psnr_white", "psnr_black", "psnr_0.5", "alpha_mae", "recon"}
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(value), rtol=1e-4, atol=1e-4, err_msg=name)
    assert not got["recon"].requires_grad


def test_optimizer_step_reaches_a_later_eval_through_the_weight_cache(world):
    """The fused modules keep kernel-layout copies of their weights under
    no_grad; after `optimizer.step()` writes the parameters in place, the
    next eval must see the new weights (checked against the unfused path)."""
    model, ref = _port_models(world, fused=True)
    optimizer = tvs.make_optimizer(tvs.trainable_parameters(model), 1e-2, max_grad_norm=1.0)
    train = tvs.make_train_step(model, optimizer, tl.AlphaVaeLossConfig(reduce_mean=True),
                                tvs.VaeStepConfig(**SCALES), ref_model=ref)
    evaluate = tvs.make_eval_step(model)
    images = torch.from_numpy(world["images"])
    eps = torch.zeros(4, 16, 16, 4)
    before = evaluate(images, eps=eps)["recon"]
    assert any("_derived_cache" in m.__dict__ for m in model.module.modules())
    train({"images": images}, generator=torch.Generator().manual_seed(0))
    after = evaluate(images, eps=eps)["recon"]
    model.disable_fused()
    want = evaluate(images, eps=eps)["recon"]
    assert (after - before).abs().max() > 1e-3
    torch.testing.assert_close(after, want, rtol=1e-4, atol=1e-4)


def test_generator_draws_per_microbatch_in_order(world):
    """Without `eps` the step draws from its generator once per microbatch, in
    order: the same as handing it those draws as `eps`."""
    images = torch.from_numpy(world["images"])
    results = []
    for use_eps in (False, True):
        model, ref = _port_models(world)
        optimizer = tvs.make_optimizer(tvs.trainable_parameters(model), LR)
        step = tvs.make_train_step(model, optimizer, tl.AlphaVaeLossConfig(reduce_mean=True),
                                   tvs.VaeStepConfig(gradient_accumulation_steps=2, **SCALES), ref_model=ref)
        gen = torch.Generator().manual_seed(5)
        if use_eps:
            eps = torch.cat([torch.randn((2, 16, 16, 4), generator=gen) for _ in range(2)])
            results.append(step({"images": images}, eps=eps))
        else:
            results.append(step({"images": images}, generator=gen))
    for name in results[0]:
        assert results[0][name].item() == results[1][name].item(), name


def test_split_microbatches_and_unported_options(world):
    batch = {"images": torch.zeros(4, 2, 2, 4), "weights": torch.arange(4.0)}
    parts = split_microbatches(batch, 2)
    assert [p["weights"].tolist() for p in parts] == [[0.0, 1.0], [2.0, 3.0]]
    with pytest.raises(ValueError):
        split_microbatches(batch, 3)
    model, _ = _port_models(world)
    optimizer = tvs.make_optimizer(tvs.trainable_parameters(model), LR)
    cfg = (tl.AlphaVaeLossConfig(), tvs.VaeStepConfig())
    # a mesh makes the step ZeRO-2 (tests/test_torch_zero_step.py); offload needs one, as in JAX
    zero = tvs.init_train_state(model, optimizer, mesh=Mesh(), offload=True)
    assert isinstance(zero, ZeroAdamW) and zero.offload and callable(
        tvs.make_train_step(model, zero, *cfg, mesh=Mesh(), offload_opt_state=True))
    with pytest.raises(ValueError, match="requires a mesh"):
        tvs.make_train_step(model, optimizer, *cfg, offload_opt_state=True)
    assert callable(tvs.make_eval_step(model, mesh=Mesh()))
    with pytest.raises(ValueError):
        tvs.resolve_background_spec("green")
    with pytest.raises(ValueError):
        RgbaVAE(world["tcfg"], remat="some")
    assert dataclasses.asdict(tvs.VaeStepConfig())["gradient_accumulation_steps"] == 1
