"""The weight-only int8 path of the port as a whole, against the JAX package.

A tiny FLUX configuration (base and non-zero adapters, random numpy weights)
is quantised by the JAX function and carried across by `params_from_flax`
(strict), so both packages hold the same integers and scales. fp32
activations on both sides; the JAX side runs `int8_matmul` through its XLA
epilogue, the port through its plain version.

Tolerances as for the float path: the forward 1e-4 (2 double + 2 single blocks
of products summed in another order), the sampler's trajectory and image 1e-3
(each step's error feeds the next), the loss 1e-4, a gradient leaf 2e-3
relative with a 2e-6 floor, two AdamW steps as in the LoRA stage's own test
(mean error below 0.5% of one update, at most 1% of a leaf's elements off by
more than 5% of it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ragb_vae_tpu.models import flux_weights as jfw
from ragb_vae_tpu.models import quantize as jq
from ragb_vae_tpu.models.flux_kontext_textalpha import FluxTextAlphaModel as JaxModel
from ragb_vae_tpu.models.flux_transformer import FluxTransformerConfig as JaxFluxConfig
from ragb_vae_tpu.models.rgba_vae import RgbaVAE as JaxRgbaVAE
from ragb_vae_tpu.models.scheduler import FlowMatchEulerScheduler as JaxScheduler
from ragb_vae_tpu.models.vae_config import AutoencoderConfig as JaxAutoencoderConfig
from ragb_vae_tpu_torch import inference
from ragb_vae_tpu_torch.data.image_io import load_rgba, save_rgba
from ragb_vae_tpu_torch.models import flux_weights as tfw
from ragb_vae_tpu_torch.models import weights as tw
from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel, load_transformer
from ragb_vae_tpu_torch.models.flux_transformer import (
    Fp32Linear,
    FluxTransformer2D,
    FluxTransformerConfig,
    QLinear,
    freeze_base_parameters,
    lora_target_modules,
)
from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
from ragb_vae_tpu_torch.models.scheduler import FlowMatchEulerScheduler
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
from ragb_vae_tpu_torch.ops.kernels import int8_matmul as tim
from ragb_vae_tpu_torch.training import flux_kontext_textalpha_lora as tstage
from tests.data_fixtures import make_text_alpha_tree
from tests.test_torch_flux import _inputs, random_flux_params
from tests.test_torch_lora_loss import ALPHA, RANK, random_lora_flux_params
from tests.test_torch_serving import _write_jax_checkpoint
from tests.test_torch_vae import _random_params as random_vae_params

FWD_TOL = 1e-4
TRAJ_TOL = IMAGE_TOL = 1e-3
LOSS_TOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-6
LR, T = 1e-3, 4


def _pair(lora: bool):
    """(JAX model, its quantised transformer tree, VAE tree, port model) over
    the same int8 weights, with adapters of RANK when `lora`."""
    rng = np.random.default_rng(0)
    jt_cfg, tt_cfg = JaxFluxConfig.tiny(), FluxTransformerConfig.tiny()
    jv_cfg, tv_cfg = JaxAutoencoderConfig.tiny(), AutoencoderConfig.tiny()
    jv_cfg.in_channels = jv_cfg.out_channels = tv_cfg.in_channels = tv_cfg.out_channels = 4
    plain = random_lora_flux_params(jt_cfg, seed=1) if lora else random_flux_params(jt_cfg, seed=1)
    qparams = jq.quantize_transformer_params(plain)
    v_params = random_vae_params(jv_cfg, seed=2)
    prompt = rng.standard_normal((1, 4, jt_cfg.joint_attention_dim)).astype(np.float32)
    pooled = rng.standard_normal((1, jt_cfg.pooled_projection_dim)).astype(np.float32)
    text_ids = np.zeros((4, 3), np.float32)
    rank, alpha = (RANK, ALPHA) if lora else (0, 0.0)
    jmodel = JaxModel(
        transformer_config=jt_cfg, vae=JaxRgbaVAE(config=jv_cfg), scheduler=JaxScheduler(),
        prompt_embeds=jnp.asarray(prompt), pooled_prompt_embeds=jnp.asarray(pooled),
        text_ids=jnp.asarray(text_ids), lora_rank=rank, lora_alpha=alpha, remat=False, weight_quant="int8",
    )
    transformer = FluxTransformer2D(tt_cfg, lora_rank=rank, lora_alpha=alpha, weight_quant="int8")
    transformer.load_state_dict(tfw.params_from_flax(qparams), strict=True)
    freeze_base_parameters(transformer)
    vae = RgbaVAE(tv_cfg, fused=True)
    vae.module.load_state_dict(tw.params_from_flax(v_params), strict=True)
    tmodel = FluxTextAlphaModel(
        transformer.eval(), vae, FlowMatchEulerScheduler(), torch.from_numpy(prompt),
        torch.from_numpy(pooled), torch.from_numpy(text_ids), lora_rank=rank, lora_alpha=alpha,
    )
    return jmodel, qparams, v_params, tmodel


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The models here are tiny: one thread computes them as fast as many, and
    a test run with several worker processes does not oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def base_pair():
    return _pair(lora=False)


@pytest.fixture(scope="module")
def lora_pair():
    return _pair(lora=True)


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------
def test_every_qdense_of_the_jax_tree_is_an_int8_linear_of_buffers(base_pair):
    _, qparams, _, tmodel = base_pair
    linears = [m for m in tmodel.transformer.modules() if isinstance(m, QLinear)]
    n_jax = sum(1 for p, _ in jax.tree_util.tree_leaves_with_path(qparams) if p[-1].key == "kernel_q")
    assert len(linears) == n_jax
    assert all(m.weight_quant == "int8" and m.weight_q.dtype == torch.int8
               and m.weight_scale.dtype == torch.float32 and m.bias.dtype == torch.float32 for m in linears)
    assert all(m.weight_q.shape == (m.out_features, m.in_features) for m in linears)
    names = {n.rsplit(".", 1)[-1] for n, _ in tmodel.transformer.named_parameters()}
    assert names == {"weight"}                       # what is left as a parameter: the RMSNorm scales
    assert sum(isinstance(m, Fp32Linear) for m in linears) == 2 * 2 + 2 + 1   # the AdaLN modulations


def test_unknown_weight_quant_raises():
    with pytest.raises(ValueError, match="Unknown weight_quant mode 'int4'"):
        FluxTransformer2D(FluxTransformerConfig.tiny(), weight_quant="int4")
    with pytest.raises(ValueError, match="Unknown weight_quant mode"):
        QLinear(4, 4, weight_quant="fp8")


@pytest.mark.parametrize("with_lora", [False, True], ids=["base", "lora"])
def test_int8_transformer_forward_matches_jax(base_pair, lora_pair, with_lora):
    jmodel, qparams, _, tmodel = lora_pair if with_lora else base_pair
    inp = _inputs(JaxFluxConfig.tiny())
    want = jax.jit(lambda p, kw: jmodel.transformer.apply({"params": p}, **kw))(
        qparams, {k: None if v is None else jnp.asarray(v) for k, v in inp.items()})
    tim.reset_launch_counts()
    with torch.no_grad():
        got = tmodel.transformer(**{k: None if v is None else torch.from_numpy(v) for k, v in inp.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)
    assert tim.LAUNCHES == 0                         # the CPU takes the plain version


def test_int8_forward_tracks_the_float_forward():
    """As the JAX package's own test: small median relative error, cosine
    above 0.995 against the float weights the integers came from."""
    params = random_flux_params(JaxFluxConfig.tiny(), seed=1)
    plain = FluxTransformer2D(FluxTransformerConfig.tiny())
    plain.load_state_dict(tfw.params_from_flax(params), strict=True)
    inp = {k: None if v is None else torch.from_numpy(v) for k, v in _inputs(JaxFluxConfig.tiny()).items()}
    with torch.no_grad():
        ref = plain(**inp).numpy()
        from ragb_vae_tpu_torch.models.quantize import quantize_module_
        out = quantize_module_(plain)(**inp).numpy()
    rel = np.abs(out - ref) / np.maximum(np.abs(ref), 1e-2)
    assert np.median(rel) < 0.05
    assert np.sum(out * ref) / (np.linalg.norm(out) * np.linalg.norm(ref)) > 0.995


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_lora", [False, True], ids=["base", "lora"])
def test_int8_sampler_matches_jax_with_injected_noise(base_pair, lora_pair, with_lora):
    jmodel, qparams, v_params, tmodel = lora_pair if with_lora else base_pair
    rng = np.random.default_rng(3)
    bsz, steps = 2, 3
    gt = rng.uniform(size=(bsz, 32, 32, 4)).astype(np.float32)
    lat_shape = (bsz, 16, 16, 4)
    eps, init = (rng.standard_normal(lat_shape).astype(np.float32) for _ in range(2))
    step_noises = rng.standard_normal((steps,) + lat_shape).astype(np.float32)

    def jax_slice(tp, vp, gt, eps, init, noises):
        post = jmodel.vae.encode(vp, gt * 2.0 - 1.0)
        cond = (post.mean + post.std * eps - jmodel.shift_factor) * jmodel.scaling_factor
        final, traj = jmodel.sample_latents_from_noise(tp, cond, init, noises, return_trajectory=True)
        dec = jmodel.vae.decode(vp, final / jmodel.scaling_factor + jmodel.shift_factor)
        return traj, jnp.clip((dec + 1.0) / 2.0, 0.0, 1.0)

    traj_j, img_j = jax.jit(jax_slice)(qparams, v_params, *(jnp.asarray(a) for a in (gt, eps, init, step_noises)))
    with torch.no_grad():
        cond_t = tmodel.encode_latents(torch.from_numpy(gt), torch.from_numpy(eps))
        final_t, traj_t = tmodel.sample_latents_from_noise(
            cond_t, torch.from_numpy(init), torch.from_numpy(step_noises), return_trajectory=True)
        img_t = tmodel.decode_latents(final_t)
    np.testing.assert_allclose(traj_t.numpy(), np.asarray(traj_j), rtol=TRAJ_TOL, atol=TRAJ_TOL)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=IMAGE_TOL, atol=IMAGE_TOL)
    out = tmodel.sample(torch.from_numpy(gt), num_inference_steps=2, generator=torch.Generator().manual_seed(1))
    assert out.shape == gt.shape and bool(torch.isfinite(out).all())


def test_random_int8_model_samples(tmp_path):
    """`random(weight_quant="int8")`: integers and the 3 / sqrt(in) / 127
    scale drawn from the seed, finite samples, the same model from the same seed."""
    vcfg = AutoencoderConfig.tiny()
    vcfg.in_channels = vcfg.out_channels = 4
    make = lambda seed: FluxTextAlphaModel.random(FluxTransformerConfig.tiny(), vcfg, seed=seed, device="cpu",
                                                  prompt_len=4, weight_quant="int8", lora_rank=2, lora_alpha=4.0)
    a, b, c = make(0), make(0), make(1)
    lin = a.transformer.transformer_blocks[0].attn.to_q
    assert lin.weight_q.dtype == torch.int8 and int(lin.weight_q.abs().max()) > 100
    assert lin.weight_scale[0].item() == pytest.approx(3.0 / np.sqrt(lin.in_features) / 127.0)
    assert torch.equal(lin.weight_q, b.transformer.transformer_blocks[0].attn.to_q.weight_q)
    assert not torch.equal(lin.weight_q, c.transformer.transformer_blocks[0].attn.to_q.weight_q)
    assert a.device == torch.device("cpu") and len(tfw.lora_parameters(a.transformer)) == 2 * len(
        lora_target_modules(a.transformer))
    gt = torch.rand((1, 32, 32, 4), generator=torch.Generator().manual_seed(0))
    out = a.sample(gt, num_inference_steps=2, generator=torch.Generator().manual_seed(1))
    assert out.shape == (1, 32, 32, 4) and bool(torch.isfinite(out).all())


def test_inference_server_over_an_int8_model_warms_up_serves_and_drains():
    from ragb_vae_tpu_torch.serving import InferenceServer, ServeConfig

    vcfg = AutoencoderConfig.tiny()
    vcfg.in_channels = vcfg.out_channels = 4
    model = FluxTextAlphaModel.random(FluxTransformerConfig.tiny(), vcfg, seed=0, device="cpu", fused=True,
                                      prompt_len=4, weight_quant="int8")
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(size=s).astype(np.float32) for s in ((64, 64, 4), (64, 64, 4), (80, 50, 4))]
    server = InferenceServer(model, ServeConfig(max_batch=2, steps=2, auto_batch=True))
    server.warmup([(64, 64)])
    assert server._bucket_batch[(64, 64)] in (1, 2)
    with server:
        first = server.submit(imgs[0], seed=5).result(timeout=60)
        outs = [f.result(timeout=60) for f in [server.submit(img, seed=5 + i) for i, img in enumerate(imgs)]]
        assert server.drain(timeout=60)
    for img, out in zip(imgs, outs):
        assert out.shape == img.shape and np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0
    np.testing.assert_array_equal(first, outs[0])            # (image, seed) decides, not the batch
    assert server.stats["served"] == 4 and server.stats["pending"] == 0


# ---------------------------------------------------------------------------
# QLoRA: the loss, its gradient tree, two optimizer steps
# ---------------------------------------------------------------------------
def _latents(seed, bsz=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bsz, 8, 8, 4)).astype(np.float32) for _ in range(3)]


def test_qlora_loss_and_adapter_gradients_match_jax(lora_pair):
    jmodel, qparams, _, tmodel = lora_pair
    cond, target, noise = _latents(2)
    u = np.asarray([0.3, 0.8], np.float32)
    base, lora = jfw.split_lora_params(qparams)

    def jax_loss(lora_tree):
        return jmodel.compute_loss_from_latents(
            jfw.merge_params(base, lora_tree), *(jnp.asarray(a) for a in (cond, target, noise, u)))

    (want_loss, _), want_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(lora)
    for p in tmodel.transformer.parameters():
        p.grad = None
    loss, _ = tmodel.compute_loss_from_latents(*(torch.from_numpy(a) for a in (cond, target, noise, u)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_TOL)
    got = dict(jax.tree_util.tree_leaves_with_path(tfw.lora_grads_to_flax(tmodel.transformer)))
    want_leaves = jax.tree_util.tree_leaves_with_path(want_grads)
    assert len(want_leaves) == len(got) == 2 * len(lora_target_modules(tmodel.transformer))
    for path, leaf in want_leaves:
        want = np.asarray(leaf)
        assert np.abs(want).max() > 0, path
        np.testing.assert_allclose(got[path], want, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=jax.tree_util.keystr(path))
    # nothing but the adapters takes a gradient: the base is buffers and frozen norm scales
    assert all(p.grad is None for n, p in tmodel.transformer.named_parameters() if not tfw.is_lora_key(n))


def test_adapters_after_two_clipped_adamw_steps_match_optax_under_an_int8_base(lora_pair, monkeypatch):
    jmodel, qparams, _, tmodel = lora_pair
    rng = np.random.default_rng(11)
    f = lambda: rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    steps = [dict(cond=f(), target=f(), noise=f(), u=rng.uniform(0.05, 0.95, 4).astype(np.float32))
             for _ in range(2)]
    base, lora0 = jfw.split_lora_params(qparams)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(optax.cosine_decay_schedule(LR, T), b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01))

    @jax.jit
    def jax_step(lora, opt_state, mb):
        def loss_fn(tree):
            return jmodel.compute_loss_from_latents(jfw.merge_params(base, tree), mb["cond"], mb["target"],
                                                    mb["noise"], mb["u"])[0]
        loss, grads = jax.value_and_grad(loss_fn)(lora)
        updates, opt_state = tx.update(grads, opt_state, lora)
        return optax.apply_updates(lora, updates), opt_state, loss

    start = tfw.lora_state(tmodel.transformer)
    base_before = {k: v.clone() for k, v in tmodel.transformer.state_dict().items() if not tfw.is_lora_key(k)}
    pending = []
    monkeypatch.setattr(tmodel, "compute_loss", lambda gt, ta, gen, weights=None: tmodel.compute_loss_from_latents(
        gt, ta, *pending.pop(0), weights=weights))
    optimizer = tstage.make_lora_optimizer(list(tfw.lora_parameters(tmodel.transformer).values()), LR)
    train_step = tstage.make_lora_train_step(tmodel, optimizer, 1, tstage.cosine_decay_schedule(LR, T))
    try:
        lora, opt_state = lora0, tx.init(lora0)
        for i, s in enumerate(steps):
            pending.append((torch.from_numpy(s["noise"]), torch.from_numpy(s["u"])))
            lora, opt_state, want_loss = jax_step(lora, opt_state, {k: jnp.asarray(v) for k, v in s.items()})
            loss, _, grad_norm = train_step(
                {"gt": torch.from_numpy(s["cond"]), "text_alpha": torch.from_numpy(s["target"])}, None, i)
            np.testing.assert_allclose(loss.item(), float(want_loss), rtol=5e-4, err_msg=f"step {i}")
            assert grad_norm.item() > 1.0            # the clip is active
        got = dict(jax.tree_util.tree_leaves_with_path(tfw.params_to_flax(tfw.lora_state(tmodel.transformer))))
        first = dict(jax.tree_util.tree_leaves_with_path(lora0))
        for path, leaf in jax.tree_util.tree_leaves_with_path(lora):
            name = jax.tree_util.keystr(path)
            err = np.abs(got[path] - np.asarray(leaf))
            assert np.abs(np.asarray(leaf) - first[path]).max() > 0.1 * LR, f"{name} did not move"
            assert err.mean() <= 0.005 * LR and np.mean(err > 0.05 * LR) <= 0.01, (name, err.max(), err.mean())
        after = tmodel.transformer.state_dict()
        assert all(torch.equal(after[k], v) for k, v in base_before.items())     # no base buffer changed
    finally:
        tfw.load_lora_state(tmodel.transformer, start)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------
def _quantize_checkpoint(root, dst):
    """root/flux (written by the JAX savers) -> dst with an int8 transformer/
    written by the JAX package, the rest copied."""
    import shutil

    from ragb_vae_tpu.models.flux_weights import load_flux_transformer_params

    shutil.copytree(root / "flux", dst, ignore=shutil.ignore_patterns("transformer"))
    cfg, params = load_flux_transformer_params(root / "flux")
    jq.save_quantized_transformer(
        cfg, jq.quantize_transformer_params(jax.tree_util.tree_map(np.asarray, params)), dst / "transformer")


def test_inference_quant_int8_on_a_quantised_and_on_a_plain_directory(tmp_path):
    """`--quant int8 --device cpu`: a directory quantised by the JAX package
    loads as it is, a plain one is quantised at load to the same integers, so
    the two answers are equal bit for bit; both differ from the float answer."""
    _write_jax_checkpoint(tmp_path)
    _quantize_checkpoint(tmp_path, tmp_path / "flux-int8")
    cfg, state, quantized = load_transformer(tmp_path / "flux-int8")
    assert quantized and state["x_embedder.weight_q"].dtype == torch.int8
    assert load_transformer(tmp_path / "flux")[2] is False
    src = tmp_path / "in.png"
    save_rgba(np.random.default_rng(3).uniform(size=(32, 32, 4)), src)

    def run(model_dir, name, *extra):
        inference.main(["--pretrained_model_name_or_path", str(model_dir), "--rgba_vae_path", str(tmp_path / "vae"),
                        "--input_image", str(src), "--output_path", str(tmp_path / name), "--steps", "2",
                        "--seed", "0", "--precision", "fp32", "--device", "cpu", *extra])
        return load_rgba(tmp_path / name)

    from_quantised = run(tmp_path / "flux-int8", "a.png", "--quant", "int8")
    from_plain = run(tmp_path / "flux", "b.png", "--quant", "int8")
    plain = run(tmp_path / "flux", "c.png")
    assert from_quantised.shape == (32, 32, 4)
    np.testing.assert_array_equal(from_quantised, from_plain)
    assert not np.array_equal(from_plain, plain)
    with pytest.raises(ValueError, match="weight-only int8 transformer"):
        run(tmp_path / "flux-int8", "d.png")


def test_from_pretrained_quantises_fp32_values_whatever_the_compute_dtype(tmp_path):
    """A plain checkpoint loaded at bf16 with weight_quant="int8" holds the
    integers of its fp32 values (the JAX package's), not of their bf16 rounding."""
    from ragb_vae_tpu.models.flux_weights import load_flux_transformer_params

    _write_jax_checkpoint(tmp_path)
    model = FluxTextAlphaModel.from_pretrained(tmp_path / "flux", vae_path=tmp_path / "vae", dtype=torch.bfloat16,
                                               device="cpu", weight_quant="int8")
    _, params = load_flux_transformer_params(tmp_path / "flux")
    want = jq.quantize_transformer_params(jax.tree_util.tree_map(np.asarray, params))
    got = tfw.params_to_flax(model.transformer.state_dict())
    for name in ("x_embedder", "proj_out", "norm_out_linear"):
        np.testing.assert_array_equal(got[name]["kernel_q"], want[name]["kernel_q"])
        np.testing.assert_array_equal(got[name]["kernel_scale"], want[name]["kernel_scale"])
    assert model.transformer.x_embedder.compute_dtype == torch.bfloat16
    assert model.transformer.norm_out.linear.compute_dtype == torch.float32
    assert model.transformer.transformer_blocks[0].attn.norm_q.weight.dtype == torch.bfloat16


def _stage_cfg(root, **training):
    return {
        "model": {"pretrained_model_name_or_path": str(root / "flux"), "rgba_vae_path": str(root / "vae")},
        "data": {"root": str(root / "data"), "batch_size": 2, "num_workers": 2},
        "training": {"mixed_precision": "fp32", "max_train_steps": 2, "rank": 4, "lora_alpha": 8, "log_every": 1,
                     "ckpt_every_steps": 1, "ckpt_dir": str(root / "ckpt"), "grad_accum_steps": 2,
                     "learning_rate": 1e-3, "val_every_steps": 1000, "seed": 3, "weight_quant": "int8",
                     **training},
    }


def test_qlora_stage_takes_two_steps_and_resumes(tmp_path):
    """`weight_quant: int8` from a plain checkpoint on disk: two steps, peft
    saves, then `resume_from: auto` for a third step; the saved adapters serve
    under `--quant int8`, at their metadata's rank and alpha when no flag
    gives them."""
    _write_jax_checkpoint(tmp_path)
    make_text_alpha_tree(tmp_path / "data", n=4)
    logged = []
    out = tstage.train_from_config(_stage_cfg(tmp_path), device="cpu", log_fn=lambda s, m: logged.append((s, m)))
    assert out["global_step"] == 2.0 and [s for s, _ in logged] == [1, 2]
    assert all(np.isfinite(m["train/loss"]) and m["train/grad_norm"] > 0 for _, m in logged)
    final = tmp_path / "ckpt" / "final"
    assert {p.name for p in final.iterdir()} == {"pytorch_lora_weights.safetensors", "metadata.json", "train_state.pt"}
    lora = tfw.peft_state_to_lora_params(tw.load_torch_state(final / "pytorch_lora_weights.safetensors"))
    assert float(lora["transformer_blocks.0.attn.to_q.lora_B"].abs().max()) > 0

    logged.clear()
    out = tstage.train_from_config(_stage_cfg(tmp_path, resume_from="auto", max_train_steps=3), device="cpu",
                                   log_fn=lambda s, m: logged.append((s, m)))
    assert out["global_step"] == 3.0 and [s for s, _ in logged] == [3]
    state = torch.load(tmp_path / "ckpt" / "checkpoint-3" / "train_state.pt", weights_only=True)
    assert {float(s["step"]) for s in state["optimizer"]["state"].values()} == {3.0}

    src = tmp_path / "in.png"
    save_rgba(np.random.default_rng(3).uniform(size=(32, 32, 4)), src)
    argv = ["--pretrained_model_name_or_path", str(tmp_path / "flux"), "--rgba_vae_path", str(tmp_path / "vae"),
            "--input_image", str(src), "--steps", "2", "--seed", "0", "--precision", "fp32", "--device", "cpu",
            "--quant", "int8"]
    inference.main(argv + ["--output_path", str(tmp_path / "base.png")])
    inference.main(argv + ["--output_path", str(tmp_path / "lora.png"), "--lora_path", str(final),
                           "--rank", "4", "--lora_alpha", "8"])
    assert not np.array_equal(load_rgba(tmp_path / "lora.png"), load_rgba(tmp_path / "base.png"))
    # no flags: the rank and alpha come from final/metadata.json
    inference.main(argv + ["--output_path", str(tmp_path / "meta.png"), "--lora_path", str(final)])
    assert (tmp_path / "meta.png").read_bytes() == (tmp_path / "lora.png").read_bytes()


def test_qlora_stage_checks_the_given_model_and_the_device(tmp_path, monkeypatch):
    make_text_alpha_tree(tmp_path / "data", n=2)
    vcfg = AutoencoderConfig.tiny()
    vcfg.in_channels = vcfg.out_channels = 4
    float_model = FluxTextAlphaModel.random(FluxTransformerConfig.tiny(), vcfg, seed=0, device="cpu", prompt_len=4)
    with pytest.raises(ValueError, match="stores its transformer as 'none'"):
        tstage.train_from_config(_stage_cfg(tmp_path), model=float_model, device="cpu")
    int8_model = FluxTextAlphaModel.random(FluxTransformerConfig.tiny(), vcfg, seed=0, device="cpu",
                                           prompt_len=4, weight_quant="int8")
    before = {k: v.clone() for k, v in int8_model.transformer.state_dict().items()}
    out = tstage.train_from_config(_stage_cfg(tmp_path, max_train_steps=1), model=int8_model, device="cpu")
    assert out["global_step"] == 1.0
    after = int8_model.transformer.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())        # base buffers and norm scales
    # the card is the default and a missing card is an error, not a run on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tstage.build_args_from_cfg(_stage_cfg(tmp_path)).device == "cuda"
    with pytest.raises(RuntimeError, match="is_available.. is False"):
        tstage.train_from_config(_stage_cfg(tmp_path), model=int8_model)
