"""Pipeline parallelism of the port (`parallel/pipeline.py`) on the CPU, in
one process: every stage on `cpu`, JAX's pipeline on its 8 virtual CPU
devices.

The JAX pipeline tests' config (`tests/test_pipeline_parallel.py::cfg4`:
3 double + 5 single blocks, 2 heads x 32), fp32, batch 2, 8 image and 4 text
tokens with non-zero image ids (with all-zero ids every token gets the same
rotation and a reordered joint stream would go unseen). One set of random
numpy weights in the JAX tree crosses into the port through
`params_from_flax`.

What is held, and how tightly:

- the cuts (`stage_ranges`) equal JAX's for cfg4 and FLUX.1 (19 + 38) at
  1..8 stages, and the state-dict split is a partition that maps one to one
  onto JAX's per-stage trees;
- the pipelined forward is the monolithic port bit for bit (`torch.equal`):
  at microbatch = batch against the whole batch, at a smaller microbatch
  against the monolithic forward of each microbatch's rows (a GEMM of other
  rows rounds differently, so against the whole batch it is held to 1e-5);
  against JAX's pipeline to 1e-4, the bound of the port's monolithic forward
  against JAX's (`tests/test_torch_flux.py`): the same math in another
  framework, whose sums round in another order (3.7e-5 at worst here);
- int8 and LoRA adapters through the pipeline bit for bit against their
  monolithic forms; the sampler with injected noise bit for bit against the
  port's `sample_latents_from_noise` and to 1e-3 of JAX's pipelined sampler
  (each step's transformer error feeds the next, as `tests/test_torch_sampler.py`);
- the GPipe loss and adapter gradients at (2 stages, microbatch 2) and
  (4, 1) against the monolithic `compute_loss_from_latents` and its backward
  (loss 1e-6, gradients 1e-5 relative, as JAX's own test) and against JAX's
  `pipelined_lora_loss_and_grads` (loss 1e-4, gradients 2e-3 relative with a
  2e-6 floor, as `tests/test_torch_lora_loss.py`); one `PipelineLoraTrainer`
  AdamW step with optax's defaults (weight decay 1e-4) against the
  monolithic step to 1e-3 (JAX's test's bound), and a second step;
- four planted faults each fail their bound: a stage range that drops a
  block, txt and img swapped at a single-range boundary, temb not carried
  (forward), each microbatch divided by its own weight sum (gradients, sample
  weights [1, 0.5], microbatch 1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ragb_vae_tpu.models.flux_kontext_textalpha import FluxTextAlphaModel as JaxModel
from ragb_vae_tpu.models.flux_transformer import FluxTransformerConfig as JaxFluxConfig
from ragb_vae_tpu.models.flux_weights import split_lora_params
from ragb_vae_tpu.models.rgba_vae import RgbaVAE as JaxRgbaVAE
from ragb_vae_tpu.models.scheduler import FlowMatchEulerScheduler as JaxScheduler
from ragb_vae_tpu.models.vae_config import AutoencoderConfig as JaxAutoencoderConfig
from ragb_vae_tpu.parallel import pipeline as jpp
from ragb_vae_tpu_torch.models import flux_weights as tfw
from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel
from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformer2D, FluxTransformerConfig, freeze_base_parameters
from ragb_vae_tpu_torch.models.quantize import quantize_module_
from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
from ragb_vae_tpu_torch.models.scheduler import FlowMatchEulerScheduler
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
from ragb_vae_tpu_torch.parallel import pipeline as tpp
from ragb_vae_tpu_torch.parallel.bootstrap import build_pipelined_transformer
from tests.test_torch_flux import _inputs
from tests.test_torch_lora_loss import ALPHA, RANK, random_lora_flux_params

ROWS_TOL = 1e-5
JAX_TOL = 1e-4
SAMPLE_JAX_TOL = 1e-3
LOSS_RTOL, GRAD_RTOL = 1e-6, 1e-5
JAX_LOSS_TOL, JAX_GRAD_RTOL, JAX_GRAD_ATOL = 1e-4, 2e-3, 2e-6
STEP_RTOL = 1e-3
FAULT_WEIGHTS = np.asarray([1.0, 0.5], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads beside the suite's workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg4(cls):
    return cls(in_channels=16, num_layers=3, num_single_layers=5, attention_head_dim=32, num_attention_heads=2,
               joint_attention_dim=32, pooled_projection_dim=16, guidance_embeds=True, axes_dims_rope=(8, 12, 12))


JCFG, TCFG = _cfg4(JaxFluxConfig), _cfg4(FluxTransformerConfig)


def _port(params, **kw) -> FluxTransformer2D:
    t = FluxTransformer2D(TCFG, **kw)
    t.load_state_dict(tfw.params_from_flax(params), strict=True)
    return t.eval()


@pytest.fixture(scope="module")
def lora_params():
    return random_lora_flux_params(JCFG, seed=1)


@pytest.fixture(scope="module")
def params(lora_params):
    return split_lora_params(lora_params)[0]


@pytest.fixture(scope="module")
def jax_pipes():
    """JAX's pipelines by stage count, kept for the module: a stage program
    compiled for one test's shapes serves the next."""
    return {}


def _jax_pipe(jax_pipes, n, params):
    if n not in jax_pipes:
        pipe = jpp.PipelinedFluxTransformer(JCFG, devices=jax.devices()[:n])
        jax_pipes[n] = (pipe, pipe.place_params(params))
    return jax_pipes[n]


@pytest.fixture(scope="module")
def inputs():
    return _inputs(JCFG, bsz=2, img_seq=8, txt_seq=4, seed=5)


def _t(inp):
    return {k: None if v is None else torch.from_numpy(v) for k, v in inp.items()}


def _j(inp):
    return {k: None if v is None else jnp.asarray(v) for k, v in inp.items()}


def _rows(inp, rows):
    """The batch's `rows` of every per-sample input (the ids carry no batch)."""
    return {k: v if k.endswith("_ids") or v is None else v[rows] for k, v in inp.items()}


def _pipe(transformer, n):
    return tpp.PipelinedFluxTransformer(TCFG, ["cpu"] * n).place_(transformer)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", range(1, 9))
def test_stage_ranges_equal_jax(n):
    for jcfg, tcfg in ((JCFG, TCFG), (JaxFluxConfig(num_layers=19, num_single_layers=38), FluxTransformerConfig())):
        assert tpp.stage_ranges(tcfg, n) == jpp.stage_ranges(jcfg, n)
    assert tpp.stage_ranges(FluxTransformerConfig(), 2) == [(range(0, 19), range(0, 0)), (range(19, 19), range(0, 38))]


def test_stage_ranges_refuse_more_stages_than_blocks():
    with pytest.raises(ValueError, match="exceeds"):
        tpp.stage_ranges(TCFG, 9)


@pytest.mark.parametrize("n", [2, 3, 8])
def test_split_is_a_partition_that_maps_onto_jax(params, n):
    port = _port(params)
    state = port.state_dict()
    split = tpp.split_transformer_params(state, TCFG, n)
    keys = [k for part in split for k in part]
    assert sorted(keys) == sorted(state) and len(keys) == len(set(keys))
    for part, jpart in zip(split, jpp.split_transformer_params(params, JCFG, n)):
        assert set(part) == set(tfw.params_from_flax(jpart))
    # a stage's modules are the transformer's own, under their global names
    pipe = _pipe(port, n)
    for stage, part in zip(pipe.stages, split):
        assert set(stage.state_dict()) == set(part)
        assert all(stage.get_parameter(k) is port.get_parameter(k) for k, _ in stage.named_parameters())
    with pytest.raises(KeyError, match="no pipeline stage"):
        tpp.split_transformer_params({"stray.weight": torch.zeros(1)}, TCFG, n)


def test_stage_bytes_add_up_to_the_whole():
    meta = FluxTransformer2D(FluxTransformerConfig(), device="meta", dtype=torch.bfloat16)
    whole = sum(t.numel() * t.element_size() for t in (*meta.parameters(), *meta.buffers()))
    for n in (2, 4, 8):
        got = tpp.stage_bytes(meta, n)
        assert len(got) == n and sum(got) == whole
    # pp 2 balances FLOPs, not bytes: stage 0's 19 double blocks outweigh 38 single ones
    first, second = tpp.stage_bytes(meta, 2)
    assert first > second


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,microbatch", [(2, 2), (4, 1), (8, 2)])
def test_pipelined_forward_equals_monolithic_and_matches_jax(params, inputs, jax_pipes, n, microbatch):
    port = _port(params)
    with torch.no_grad():
        whole = port(**_t(inputs))
        got = _pipe(port, n)(**_t(inputs), microbatch=microbatch)
        per_rows = torch.cat([port(**_t(_rows(inputs, slice(m, m + microbatch))))
                              for m in range(0, 2, microbatch)])
    assert torch.equal(got, per_rows)
    if microbatch == 2:
        assert torch.equal(got, whole)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=ROWS_TOL, atol=ROWS_TOL)
    jpipe, stage_params = _jax_pipe(jax_pipes, n, params)
    want = jpipe(stage_params, **_j(inputs), microbatch=microbatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=JAX_TOL, atol=JAX_TOL)


def test_pipelined_int8_forward_equals_monolithic_int8(params, inputs):
    port = quantize_module_(_port(params))
    with torch.no_grad():
        want = port(**_t(inputs))
        got = _pipe(port, 4)(**_t(inputs), microbatch=2)
    assert torch.equal(got, want)
    assert port.transformer_blocks[0].attn.to_q.weight_quant == "int8"


def test_pipelined_lora_forward_uses_the_adapters(lora_params, inputs):
    port = _port(lora_params, lora_rank=RANK, lora_alpha=ALPHA)
    pipe = _pipe(port, 4)
    with torch.no_grad():
        want = port(**_t(inputs))
        got = pipe(**_t(inputs), microbatch=2)
        for name, p in port.named_parameters():
            if name.endswith("lora_B"):
                p.zero_()
        zeroed = pipe(**_t(inputs), microbatch=2)
    assert torch.equal(got, want)
    assert float((zeroed - want).abs().max()) > 1e-4


@pytest.mark.parametrize("what", ["forward", "training"])
def test_bad_microbatch_is_not_divisible(params, lora_params, inputs, what):
    port = _port(params)
    pipe = _pipe(port, 2)
    with pytest.raises(ValueError, match="not divisible"):
        if what == "forward":
            pipe(**_t(inputs), microbatch=3)
        else:
            model = _port_model(lora_params)
            trainer = tpp.PipelineLoraTrainer(model, _pipe(model.transformer, 2),
                                              lambda ps: torch.optim.SGD(ps, lr=0.1))
            *latents, w = (torch.from_numpy(a) for a in _train_batch())
            trainer.step(*latents, weights=w, microbatch=3)


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------
def _models(params, lora=False):
    rng = np.random.default_rng(0)
    prompt = rng.standard_normal((1, 4, JCFG.joint_attention_dim)).astype(np.float32)
    pooled = rng.standard_normal((1, JCFG.pooled_projection_dim)).astype(np.float32)
    text_ids = np.zeros((4, 3), np.float32)
    jv, tv = JaxAutoencoderConfig.tiny(), AutoencoderConfig.tiny()
    jv.in_channels = jv.out_channels = tv.in_channels = tv.out_channels = 4
    jv.sample_size = tv.sample_size = 32
    kw = dict(lora_rank=RANK, lora_alpha=ALPHA) if lora else {}
    jmodel = JaxModel(transformer_config=JCFG, vae=JaxRgbaVAE(config=jv), scheduler=JaxScheduler(),
                      prompt_embeds=jnp.asarray(prompt), pooled_prompt_embeds=jnp.asarray(pooled),
                      text_ids=jnp.asarray(text_ids), **kw)
    transformer = _port(params, **kw)
    if lora:
        freeze_base_parameters(transformer)
    torch.manual_seed(0)
    tmodel = FluxTextAlphaModel(transformer, RgbaVAE(tv), FlowMatchEulerScheduler(), torch.from_numpy(prompt),
                                torch.from_numpy(pooled), torch.from_numpy(text_ids), **kw)
    return jmodel, tmodel


def _port_model(params):
    return _models(params, lora=True)[1]


def test_pipelined_sample_latents_equal_monolithic_and_match_jax(params, jax_pipes):
    jmodel, tmodel = _models(params)
    rng = np.random.default_rng(6)
    cond, init = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32) for _ in range(2))
    steps = rng.standard_normal((3, 2, 4, 4, 4)).astype(np.float32)
    with torch.no_grad():
        want = tmodel.sample_latents_from_noise(*(torch.from_numpy(a) for a in (cond, init, steps)))
        got = tpp.pipelined_sample_latents(tmodel, _pipe(tmodel.transformer, 4),
                                           *(torch.from_numpy(a) for a in (cond, init, steps)), microbatch=1)
    per_rows = []
    with torch.no_grad():
        for r in range(2):
            per_rows.append(tmodel.sample_latents_from_noise(
                *(torch.from_numpy(a[r:r + 1]) for a in (cond, init)), torch.from_numpy(steps[:, r:r + 1])))
    assert torch.equal(got, torch.cat(per_rows))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=ROWS_TOL, atol=ROWS_TOL)
    jpipe, stage_params = _jax_pipe(jax_pipes, 4, params)
    jgot = jpp.pipelined_sample_latents(jmodel, jpipe, stage_params, jnp.asarray(cond),
                                        jnp.asarray(init), [jnp.asarray(s) for s in steps], microbatch=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=SAMPLE_JAX_TOL, atol=SAMPLE_JAX_TOL)


def test_pipelined_sample_draws_as_model_sample(params):
    _, tmodel = _models(params)
    gt = torch.from_numpy(np.random.default_rng(7).uniform(size=(2, 32, 32, 4)).astype(np.float32))
    want = tmodel.sample(gt, num_inference_steps=2, generator=torch.Generator().manual_seed(9))
    got = tpp.pipelined_sample(tmodel, _pipe(tmodel.transformer, 3), gt, num_inference_steps=2,
                               generator=torch.Generator().manual_seed(9), microbatch=2)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _train_batch(bsz=2, weights=(1.0, 0.25)):
    rng = np.random.default_rng(8)
    cond, target, noise = (rng.standard_normal((bsz, 4, 4, 4)).astype(np.float32) for _ in range(3))
    return cond, target, noise, np.asarray([0.3, 0.8], np.float32)[:bsz], np.asarray(weights, np.float32)[:bsz]


def _monolithic(tmodel, batch):
    cond, target, noise, u, w = (torch.from_numpy(a) for a in batch)
    for p in tmodel.transformer.parameters():
        p.grad = None
    loss, _ = tmodel.compute_loss_from_latents(cond, target, noise, u, weights=w)
    loss.backward()
    return loss.detach(), {k: p.grad.clone() for k, p in tfw.lora_parameters(tmodel.transformer).items()}


def _pipelined(tmodel, batch, n, microbatch):
    cond, target, noise, u, w = (torch.from_numpy(a) for a in batch)
    trainer = tpp.PipelineLoraTrainer(tmodel, _pipe(tmodel.transformer, n), lambda ps: torch.optim.SGD(ps, lr=0.0))
    loss, grads, _ = trainer.loss_and_grads(cond, target, noise, u, weights=w, microbatch=microbatch)
    return loss, {k: g for stage in grads for k, g in stage.items()}


def _grads_close(got, want, rtol, atol_scale=1e-6, atol=None):
    assert set(got) == set(want)
    scale = max(float(g.abs().max()) for g in want.values())
    assert scale > 0
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=rtol,
                                   atol=atol if atol is not None else atol_scale * scale, err_msg=k)


@pytest.mark.parametrize("n,microbatch", [(2, 2), (4, 1)])
def test_pipelined_lora_loss_and_grads_match_monolithic_and_jax(lora_params, n, microbatch):
    """Against JAX's own GPipe step at (2, 2) only: compiling its per-stage
    backward programs takes most of this file's time."""
    params = lora_params
    jmodel, tmodel = _models(params, lora=True)
    batch = _train_batch()
    want_loss, want = _monolithic(tmodel, batch)
    loss, got = _pipelined(tmodel, batch, n, microbatch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    _grads_close(got, want, GRAD_RTOL)
    if (n, microbatch) != (2, 2):
        return

    cond, target, noise, u, w = (jnp.asarray(a) for a in batch)
    jpipe = jpp.PipelinedFluxTransformer(JCFG, devices=jax.devices()[:n], lora_rank=RANK, lora_alpha=ALPHA)
    jtrainer = jpp.PipelineLoraTrainer(jmodel, jpipe, optax.sgd(0.0))
    stage_base, stage_lora = jtrainer.place_params(params)
    inp = tmodel.loss_inputs(*(torch.from_numpy(a) for a in batch[:4]))
    bsz = 2
    jloss, jgrads = jpp.pipelined_lora_loss_and_grads(
        jpipe, stage_base, stage_lora, hidden_states=jnp.asarray(inp["packed"].numpy()),
        encoder_hidden_states=jnp.broadcast_to(jmodel.prompt_embeds, (bsz,) + jmodel.prompt_embeds.shape[1:]),
        pooled_projections=jnp.broadcast_to(jmodel.pooled_prompt_embeds,
                                            (bsz,) + jmodel.pooled_prompt_embeds.shape[1:]),
        timestep=jnp.asarray(inp["timesteps"].numpy()) / 1000.0, img_ids=jnp.asarray(inp["img_ids"].numpy()),
        txt_ids=jmodel.text_ids, guidance=jmodel._guidance(bsz), loss_target=noise - target,
        weighting=jnp.asarray(inp["weighting"].numpy()), weights=w, seq_cond=inp["seq_cond"],
        latent_h=4, latent_w=4, microbatch=microbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=JAX_LOSS_TOL)
    jflat = {}
    for sub in jgrads:
        for k, v in tfw.params_from_flax(jax.device_get(sub)).items():
            jflat[k] = v
    assert set(jflat) == set(got)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), jflat[k].numpy(), rtol=JAX_GRAD_RTOL, atol=JAX_GRAD_ATOL,
                                   err_msg=k)


def test_trainer_step_matches_a_monolithic_adamw_step(lora_params):
    """AdamW with optax.adamw's defaults (betas 0.9 / 0.999, eps 1e-8, weight
    decay 1e-4; torch's own default decay is 1e-2)."""
    params = lora_params
    batch = _train_batch()
    make = lambda ps: torch.optim.AdamW(ps, lr=1e-3, weight_decay=1e-4)  # noqa: E731
    mono = _port_model(params)
    adapters = tfw.lora_parameters(mono.transformer)
    opt = make(list(adapters.values()))
    _monolithic(mono, batch)
    opt.step()
    want = {k: p.detach().clone() for k, p in adapters.items()}

    tmodel = _port_model(params)
    trainer = tpp.PipelineLoraTrainer(tmodel, _pipe(tmodel.transformer, 4), make)
    assert len(trainer.optimizers) == 4
    cond, target, noise, u, w = (torch.from_numpy(a) for a in batch)
    loss, stats = trainer.step(cond, target, noise, u, weights=w, microbatch=1)
    got = {k: p.detach() for k, p in tfw.lora_parameters(tmodel.transformer).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=STEP_RTOL, atol=1e-7, err_msg=k)
    assert np.isfinite(float(loss)) and np.isfinite(float(stats["sigmas_mean"]))
    loss2, _ = trainer.step(cond, target, noise, u, weights=w, microbatch=2)
    assert np.isfinite(float(loss2)) and float(loss2) != float(loss)


# ---------------------------------------------------------------------------
# planted faults
# ---------------------------------------------------------------------------
def _drop_a_block(monkeypatch):
    real = tpp.stage_ranges

    def dropped(config, n):
        ranges = real(config, n)
        dr, sr = ranges[1]
        ranges[1] = (dr, range(sr.start, sr.stop - 1)) if len(sr) else (range(dr.start, dr.stop - 1), sr)
        return ranges

    monkeypatch.setattr(tpp, "stage_ranges", dropped)


def _swap_txt_img(monkeypatch):
    monkeypatch.setattr(tpp.PipelineStage, "join", staticmethod(lambda txt, img: torch.cat([img, txt], dim=1)))
    monkeypatch.setattr(tpp.PipelineStage, "split",
                        staticmethod(lambda x, n_txt: (x[:, x.shape[1] - n_txt:], x[:, :x.shape[1] - n_txt])))


def _temb_not_carried(monkeypatch):
    real = tpp.PipelinedFluxTransformer.carry
    monkeypatch.setattr(tpp.PipelinedFluxTransformer, "carry", staticmethod(
        lambda carrier, device: real((*carrier[:2], None if carrier[2] is None else torch.zeros_like(carrier[2])),
                                     device)))


def _own_weight_sum(monkeypatch):
    real = tpp.loss_numerator
    monkeypatch.setattr(tpp, "loss_numerator", lambda pred, lt, wt, w, *a: real(pred, lt, wt, w, *a) / w.sum())


@pytest.mark.parametrize("fault", [_drop_a_block, _swap_txt_img, _temb_not_carried])
def test_planted_forward_fault_fails_the_bound(params, inputs, monkeypatch, fault):
    port = _port(params)
    with torch.no_grad():
        want = port(**_t(inputs))
        fault(monkeypatch)
        got = _pipe(port, 4)(**_t(inputs), microbatch=2)
    assert got.shape == want.shape
    assert not np.allclose(got.numpy(), want.numpy(), rtol=ROWS_TOL, atol=ROWS_TOL)


def test_planted_gradient_fault_fails_the_bound(lora_params, monkeypatch):
    _, tmodel = _models(lora_params, lora=True)
    batch = _train_batch(weights=FAULT_WEIGHTS)
    _, want = _monolithic(tmodel, batch)
    _, sound = _pipelined(tmodel, batch, 2, 1)
    _grads_close(sound, want, GRAD_RTOL)
    _own_weight_sum(monkeypatch)
    _, got = _pipelined(tmodel, batch, 2, 1)
    with pytest.raises(AssertionError):
        _grads_close(got, want, GRAD_RTOL)


# ---------------------------------------------------------------------------
# placement and the entry points' pipeline
# ---------------------------------------------------------------------------
def test_random_placed_by_stage_is_the_same_model():
    vae = AutoencoderConfig.tiny()
    vae.in_channels = vae.out_channels = 4
    cfg = FluxTransformerConfig.tiny()
    kw = dict(seed=3, device="cpu", prompt_len=4, lora_rank=2, lora_alpha=4.0, weight_quant="int8")
    whole = FluxTextAlphaModel.random(cfg, vae, **kw)
    pipe = tpp.PipelinedFluxTransformer(cfg, ["cpu"] * 3)
    placed = FluxTextAlphaModel.random(cfg, vae, pipeline=pipe, **kw)
    want, got = whole.transformer.state_dict(), placed.transformer.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert len(pipe.stages) == 3 and placed.device == torch.device("cpu")


def test_build_pipelined_transformer(tmp_path, monkeypatch):
    import json

    (tmp_path / "transformer").mkdir()
    (tmp_path / "transformer" / "config.json").write_text(json.dumps(dataclasses.asdict(TCFG)))
    assert build_pipelined_transformer(1, "cpu", "no such checkpoint") is None
    pipe = build_pipelined_transformer(3, "cpu", tmp_path)
    assert pipe.config == TCFG and pipe.devices == [torch.device("cpu")] * 3
    assert pipe.ranges == tpp.stage_ranges(TCFG, 3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert build_pipelined_transformer(4, "cuda:0", tmp_path).devices == [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--pp 2 needs 2 devices, found 1"):
        build_pipelined_transformer(2, "cuda", "no such checkpoint")


def test_place_refuses_a_sharded_or_foreign_transformer(params):
    port = _port(params)
    with pytest.raises(ValueError, match="config"):
        tpp.PipelinedFluxTransformer(dataclasses.replace(TCFG, num_layers=2), ["cpu"] * 2).place_(port)
    with pytest.raises(RuntimeError, match="place_"):
        tpp.PipelinedFluxTransformer(TCFG, ["cpu"] * 2)(**_t(_inputs(JCFG, img_seq=8, txt_seq=4)))
