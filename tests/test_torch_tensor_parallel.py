"""Tensor parallelism of the port (`parallel/tensor_parallel.py`, the
transformer's column and row shards, the LoRA step over a data x model world)
against the port's one-process run and the JAX package's GSPMD run on
`jax.devices()[:2]`.

The JAX TP tests' config (8 heads x 32, 2 + 2 blocks, `tp_config()`), the tiny
RGBA `ae`, 32^2 images, fp32. One set of random numpy weights with non-zero
rank-4 adapters crosses into the port through `params_from_flax`.

- (a) The plan: every leaf's kind equals JAX's `transformer_param_specs` on
  the same tree (bf16 and int8 trees), and the single-stream `proj_out`'s row
  set is the permuted one. No process is spawned.
- (b) One world-2 gloo spawn (model axis 2), the cases parametrised over what
  it returns: the sample with injected noise (trajectory and image) against
  one process and against JAX's sharded sample, the same over int8 (every
  shard's weight_q and weight_scale equal bit for bit to slices of JAX's
  quantised tree), the LoRA loss and adapter-gradient tree (with per-block
  recompute) against one process and JAX, and each column and row shard's
  bytes at half the whole tensor's.
- (c) One world-4 spawn at (data 2, model 2): two `make_lora_train_step` steps
  with `ZeroAdamW` on the data group against one process on the whole batch;
  the four ranks' adapters bit-identical.

Tolerances. T = 2 against one process: the same code with two of its sums
split in two and added: the trajectory and image to 1e-5, the loss to 1e-6
relative, the gradients to 1e-5 relative with a 1e-7 floor (leaves of 1e-4..1e-2). Against JAX:
as `tests/test_torch_sampler.py` (trajectory and image 1e-3: each step's
transformer error feeds the next) and `tests/test_torch_lora_loss.py` (loss
1e-4, gradients 2e-3 relative with a 2e-6 floor); JAX's own TP sample is held
to 2e-4 of its one-device one and its TP gradients to 5e-4. The (2, 2) steps
by `assert_close_after_adamw` at lr 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as P

from ragb_vae_tpu.models.flux_kontext_textalpha import FluxTextAlphaModel as JaxModel
from ragb_vae_tpu.models.flux_weights import merge_params, split_lora_params
from ragb_vae_tpu.models.quantize import quantize_transformer_params as jquantize
from ragb_vae_tpu.models.rgba_vae import RgbaVAE as JaxRgbaVAE
from ragb_vae_tpu.models.scheduler import FlowMatchEulerScheduler as JaxScheduler
from ragb_vae_tpu.models.vae_config import AutoencoderConfig as JaxAutoencoderConfig
from ragb_vae_tpu.parallel.tensor_parallel import shard_transformer_params, transformer_param_specs
from ragb_vae_tpu_torch.models import flux_weights as tfw
from ragb_vae_tpu_torch.models import weights as tw
from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
from ragb_vae_tpu_torch.parallel import tensor_parallel as ttp
from ragb_vae_tpu_torch.parallel.mesh import Mesh
from ragb_vae_tpu_torch.parallel.tensor_parallel import leaf_kind, shard_ranges
from test_tensor_parallel import tp_config
from test_torch_lora_loss import ALPHA, RANK, random_lora_flux_params
from test_torch_vae import _random_params as random_vae_params
from torch_dist_worker import (
    TP_ALPHA,
    TP_RANK,
    assert_close_after_adamw,
    spawn,
    tp_case,
    tp_loads,
    tp_model,
    tp_served,
    tp_stage,
    tp_train_steps,
)

ONE_TOL = 1e-5                 # sample and image, T = 2 vs one process
ONE_LOSS_RTOL = 1e-6
ONE_GRAD_RTOL, ONE_GRAD_ATOL = 1e-5, 1e-7
JAX_TRAJ_TOL = JAX_IMAGE_TOL = 1e-3
JAX_LOSS_TOL = 1e-4
JAX_GRAD_RTOL, JAX_GRAD_ATOL = 2e-3, 2e-6
LR = 1e-3
STEPS = 2
assert (TP_RANK, TP_ALPHA) == (RANK, ALPHA)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _vae_configs():
    jv, tv = JaxAutoencoderConfig.tiny(), AutoencoderConfig.tiny()
    jv.in_channels = jv.out_channels = tv.in_channels = tv.out_channels = 4
    jv.sample_size = tv.sample_size = 32
    return jv, tv


def _port_config(jcfg) -> FluxTransformerConfig:
    return FluxTransformerConfig(**{k: getattr(jcfg, k) for k in (
        "in_channels", "num_layers", "num_single_layers", "attention_head_dim", "num_attention_heads",
        "joint_attention_dim", "pooled_projection_dim", "guidance_embeds", "axes_dims_rope")})


@pytest.fixture(scope="module")
def setup():
    jcfg = tp_config()
    jv, tv = _vae_configs()
    params = random_lora_flux_params(jcfg, seed=1)
    v_params = random_vae_params(jv, seed=2)
    rng = np.random.default_rng(0)
    steps = 2
    payload = {
        "config": _port_config(jcfg), "vae_config": tv,
        "state": tfw.params_from_flax(params), "vae_state": tw.params_from_flax(v_params),
        "prompt": rng.standard_normal((1, 4, jcfg.joint_attention_dim)).astype(np.float32),
        "pooled": rng.standard_normal((1, jcfg.pooled_projection_dim)).astype(np.float32),
        "text_ids": np.zeros((4, 3), np.float32),
        "gt": rng.uniform(size=(1, 32, 32, 4)).astype(np.float32),
        "eps": rng.standard_normal((1, 16, 16, 4)).astype(np.float32),
        "init": rng.standard_normal((1, 16, 16, 4)).astype(np.float32),
        "noises": rng.standard_normal((steps, 1, 16, 16, 4)).astype(np.float32),
        "latents": [rng.standard_normal((2, 16, 16, 4)).astype(np.float32) for _ in range(3)],
        "u": np.array([0.3, 0.7], np.float32),
        "serve_image": rng.uniform(size=(64, 64, 4)).astype(np.float32),
        "lr": LR, "seed": 5,
        "batches": [tuple(rng.uniform(size=(4, 32, 32, 4)).astype(np.float32) for _ in range(2))
                    for _ in range(STEPS)],
    }
    return {"jcfg": jcfg, "jv": jv, "params": params, "v_params": v_params, "payload": payload}


def _write_checkpoints(setup, root) -> None:
    """A diffusers tree and a quantised one (both packages' format) of the
    payload's base, beside the RGBA `ae` and the empty-prompt embeddings:
    what `from_pretrained(tp=)` reads."""
    from ragb_vae_tpu.models.flux_weights import split_lora_params as jsplit
    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import EMPTY_PROMPT_FILE
    from ragb_vae_tpu_torch.models.quantize import save_quantized_transformer

    p = setup["payload"]
    base = {k: v for k, v in p["state"].items() if not tfw.is_lora_key(k)}
    tfw.save_flux_transformer_params(p["config"], base, root / "model" / "transformer")
    save_quantized_transformer(p["config"], jquantize(jax.device_get(jsplit(setup["params"])[0])),
                               root / "model_q" / "transformer")
    tw.save_autoencoder_params(p["vae_config"], p["vae_state"], root / "vae" / "ae")
    for d in ("model", "model_q"):
        np.savez(root / d / EMPTY_PROMPT_FILE, prompt_embeds=p["prompt"], pooled_prompt_embeds=p["pooled"],
                 text_ids=p["text_ids"])
    p["vae_dir"] = str(root / "vae")
    p["checkpoints"] = [("diffusers", str(root / "model"), "none"),
                        ("int8 at load", str(root / "model"), "int8"),
                        ("quantised", str(root / "model_q"), "int8")]


# ---------------------------------------------------------------------------
# (a) the plan against JAX's specs
# ---------------------------------------------------------------------------
def _jax_kind(spec) -> str:
    return {P(None, "model"): "column", P("model"): "column", P("model", None): "row", P(): "replicated"}[spec]


@pytest.mark.parametrize("tree", ["bf16", "int8"])
def test_plan_matches_jax_specs(setup, tree):
    params = setup["params"]
    if tree == "int8":
        params = jquantize(jax.device_get(params))
    specs = transformer_param_specs(params)
    flat_specs = dict(jax.tree_util.tree_leaves_with_path(specs, is_leaf=lambda x: isinstance(x, P)))
    seen = 0
    for path, _ in jax.tree_util.tree_leaves_with_path(params):
        key, _ = tfw.flux_path_to_torch_key(tuple(p.key for p in path))
        assert key is not None, path
        assert leaf_kind(key) == _jax_kind(flat_specs[path]), (key, flat_specs[path])
        seen += 1
    assert seen == len(tfw.params_from_flax(params)) > 0


@pytest.mark.parametrize("rank", [0, 1])
def test_single_block_proj_out_rows_are_the_permuted_set(setup, rank):
    dim = setup["jcfg"].num_attention_heads * setup["jcfg"].attention_head_dim
    name = "single_transformer_blocks.1.proj_out"
    assert ttp.dense_kind(name) == "row" and ttp.dense_kind("proj_out") == "replicated"
    # rank r's attention columns, then its MLP columns: not JAX's contiguous 5 dim / 2
    assert shard_ranges(name, "row", 5 * dim, dim, 2, rank) == ((rank * dim // 2, dim // 2),
                                                                (dim + rank * 2 * dim, 2 * dim))
    assert shard_ranges("transformer_blocks.0.attn.to_out.0", "row", dim, dim, 2, rank) == ((rank * dim // 2, dim // 2),)


# ---------------------------------------------------------------------------
# (b) the world-2 spawn
# ---------------------------------------------------------------------------
def _jax_model(setup, weight_quant="none"):
    p = setup["payload"]
    return JaxModel(
        transformer_config=setup["jcfg"], vae=JaxRgbaVAE(config=setup["jv"]), scheduler=JaxScheduler(),
        prompt_embeds=jnp.asarray(p["prompt"]), pooled_prompt_embeds=jnp.asarray(p["pooled"]),
        text_ids=jnp.asarray(p["text_ids"]), lora_rank=RANK, lora_alpha=ALPHA, remat=False,
        weight_quant=weight_quant)


def _jax_runs(setup) -> dict:
    """JAX's sample (plain and int8) and LoRA loss and gradients with the
    transformer sharded over jax.devices()[:2] by its own specs."""
    p, v_params = setup["payload"], setup["v_params"]
    mesh = JaxMesh(np.array(jax.devices()[:2]), ("model",))
    rep = NamedSharding(mesh, P())
    out = {}
    for quant in ("none", "int8"):
        jm = _jax_model(setup, quant)
        tree = setup["params"] if quant == "none" else jquantize(jax.device_get(setup["params"]))
        sharded, shardings = shard_transformer_params(tree, mesh)

        def sample(tp_, vp, gt, eps, init, noises, jm=jm):
            post = jm.vae.encode(vp, gt * 2.0 - 1.0)
            cond = (post.mean + post.std * eps - jm.shift_factor) * jm.scaling_factor
            final, traj = jm.sample_latents_from_noise(tp_, cond, init, noises, return_trajectory=True)
            dec = jm.vae.decode(vp, final / jm.scaling_factor + jm.shift_factor)
            return traj, jnp.clip((dec + 1.0) / 2.0, 0.0, 1.0)

        fn = jax.jit(sample, in_shardings=(shardings,) + (rep,) * 5, out_shardings=rep)
        traj, img = fn(sharded, v_params, *(jnp.asarray(p[k]) for k in ("gt", "eps", "init", "noises")))
        out[quant] = {"traj": np.asarray(traj), "image": np.asarray(img)}
    jm = _jax_model(setup)
    base, lora = split_lora_params(setup["params"])
    base_sh, _ = shard_transformer_params(base, mesh)

    def loss_fn(lora_tree):
        return jm.compute_loss_from_latents(merge_params(base_sh, lora_tree),
                                            *(jnp.asarray(a) for a in p["latents"]), jnp.asarray(p["u"]))[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jax.device_put(lora, rep))
    out["lora"] = {"loss": float(loss), "grads": jax.device_get(grads)}
    return out


@pytest.fixture(scope="module")
def world2(setup, tmp_path_factory):
    payload = setup["payload"]
    _write_checkpoints(setup, tmp_path_factory.mktemp("tp_checkpoints"))
    ranks, local = spawn(
        "tp_runs", 2, tmp_path_factory.mktemp("tp2"), payload,
        meanwhile=lambda: (tp_case(tp_model(payload), payload, Mesh()), _jax_runs(setup),
                           tp_loads(payload, Mesh()), tp_served(tp_model(payload), Mesh(), payload)))
    one, jax_out, loads, served = local
    return {"ranks": ranks, "one": one, "jax": jax_out, "loads": loads, "served": served}


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("against", ["one process", "jax"])
def test_tp2_sample_matches(world2, quant, against):
    for rank in world2["ranks"]:
        got = rank["sample"] if quant == "none" else rank["int8"]["sample"]
        if against == "one process":
            one = world2["one"]["sample"] if quant == "none" else world2["one"]["int8"]["sample"]
            _close(got["traj"], one["traj"], ONE_TOL, "trajectory")
            _close(got["image"], one["image"], ONE_TOL, "image")
        else:
            want = world2["jax"][quant]
            _close(got["traj"], want["traj"], JAX_TRAJ_TOL, "trajectory")
            _close(got["image"], want["image"], JAX_IMAGE_TOL, "image")
    # the two ranks' answers are the same bits: the residual stream is replicated
    a, b = (r["sample"] if quant == "none" else r["int8"]["sample"] for r in world2["ranks"])
    assert torch.equal(a["traj"], b["traj"]) and torch.equal(a["image"], b["image"])


def test_tp2_server_answers_after_idling_past_the_group_timeout(world2):
    """A TP server's workers wait for the next batch inside a broadcast,
    which the backend fails after the group's timeout (NCCL's watchdog
    aborts the process). Idle for 2.5 of its group's timeouts, the server
    still answers its next request as one process does, and the stop
    message still releases the worker."""
    from torch_dist_worker import IDLE_S, IDLE_TIMEOUT_S

    assert IDLE_S > 2 * IDLE_TIMEOUT_S
    rank0, worker = (r["idle"] for r in world2["ranks"])
    assert worker == {"batches": 1}
    want = world2["served"]["answer"]
    assert rank0["answer"].shape == want.shape == (64, 64, 4)
    _close(rank0["answer"], want, ONE_TOL, "served answer")


def test_int8_shards_are_slices_of_jax_quantised_tree(world2, setup):
    want = tfw.params_from_flax(jquantize(jax.device_get(setup["params"])))
    model = tp_model(setup["payload"])
    from ragb_vae_tpu_torch.models.quantize import quantize_module_

    quantize_module_(model.transformer)                    # the whole model's entry names
    n = 0
    for rank, got in enumerate(world2["ranks"]):
        shard = tp_model(setup["payload"])
        ttp.shard_transformer_(shard.transformer, Mesh(2, rank))
        for key, value in got["int8"]["entries"].items():
            part = ttp.shard_state_entry(shard.transformer, key, want[key])
            assert value.dtype == part.dtype and torch.equal(value, part), key
            n += 1
    assert n == 2 * sum(1 for k in model.transformer.state_dict() if k.endswith(("weight_q", "weight_scale")))


@pytest.mark.parametrize("against", ["one process", "jax"])
def test_tp2_lora_loss_and_gradients_match(world2, against):
    for rank in world2["ranks"]:
        got = rank["lora"]
        if against == "one process":
            want = world2["one"]["lora"]
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=ONE_LOSS_RTOL)
            rtol, atol = ONE_GRAD_RTOL, ONE_GRAD_ATOL
        else:
            want = world2["jax"]["lora"]
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=JAX_LOSS_TOL)
            rtol, atol = JAX_GRAD_RTOL, JAX_GRAD_ATOL
        flat_got = dict(jax.tree_util.tree_leaves_with_path(got["grads"]))
        flat_want = jax.tree_util.tree_leaves_with_path(want["grads"])
        assert len(flat_got) == len(flat_want)
        for path, leaf in flat_want:
            np.testing.assert_allclose(flat_got[path], np.asarray(leaf), rtol=rtol, atol=atol,
                                       err_msg=jax.tree_util.keystr(path))
    # the summed partials are the same bits on both ranks
    for path, leaf in jax.tree_util.tree_leaves_with_path(world2["ranks"][0]["lora"]["grads"]):
        other = dict(jax.tree_util.tree_leaves_with_path(world2["ranks"][1]["lora"]["grads"]))[path]
        np.testing.assert_array_equal(leaf, other)


def test_tp2_collectives_per_forward_and_backward(world2, setup):
    """By the plan, one forward of 2 + 2 blocks makes 4 all-reduces a double
    block, 1 a single block and 3 in the embedders, and 2 all-gathers a
    double block, 1 a single block and 1 for norm_out; the backward adds one
    all-reduce per column region input (the forward's again under recompute)."""
    cfg = setup["jcfg"]
    fwd_reduce = 4 * cfg.num_layers + cfg.num_single_layers + 3
    fwd_gather = 2 * cfg.num_layers + cfg.num_single_layers + 1
    counts = world2["ranks"][0]["lora"]["counts"]
    assert counts == world2["ranks"][1]["lora"]["counts"]
    assert counts["all_gather"] == fwd_gather + 2 * cfg.num_layers + cfg.num_single_layers  # recompute
    assert counts["all_reduce"] > fwd_reduce
    assert world2["one"]["lora"]["counts"] == {"all_reduce": 0, "all_gather": 0}


@pytest.mark.parametrize("label", ["diffusers", "int8 at load", "quantised"])
def test_from_pretrained_keeps_each_rank_s_slice(world2, setup, label):
    """`from_pretrained(tp=)` holds exactly the rank's slices of what the
    one-process `from_pretrained` holds, bit for bit: a diffusers checkpoint
    cut as it is read, a plain one quantised at load (a row shard with the
    whole layer's scale) and a quantised one."""
    want = world2["loads"][label]
    for rank, got in enumerate(world2["ranks"]):
        shard = tp_model(setup["payload"])
        ttp.shard_transformer_(shard.transformer, Mesh(2, rank))
        got = got["loads"][label]
        assert set(got) == set(want)
        for key, value in got.items():
            part = ttp.shard_state_entry(shard.transformer, key, want[key])
            assert value.dtype == part.dtype and torch.equal(value, part), (label, key)


@pytest.mark.parametrize("kind", ["column", "row"])
def test_tp2_shard_bytes_are_half(world2, kind):
    one = world2["one"]["bytes"]
    keys = [k for k in one if leaf_kind(k) == kind]
    assert keys
    for rank in world2["ranks"]:
        for k in keys:
            assert 2 * rank["bytes"][k] == one[k], k


# ---------------------------------------------------------------------------
# (c) the world-4 spawn: data 2 x model 2
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world4(setup, tmp_path_factory):
    from data_fixtures import make_text_alpha_tree
    from test_torch_lora_stage import _cfg as lora_cfg

    root = tmp_path_factory.mktemp("tp4_stage")
    make_text_alpha_tree(root / "data", n=4)
    one_cfg = lora_cfg(root, max_train_steps=1, grad_accum_steps=1, ckpt_every_steps=1000,
                       ckpt_dir=str(root / "one"))
    one_cfg["data"].update(batch_size=2, num_workers=0)     # four ranks: no loader processes of their own
    payload = {**setup["payload"], "stage": {**one_cfg, "training": {
        **one_cfg["training"], "tensor_parallel": 2, "ckpt_dir": str(root / "tp")}}}
    ranks, one = spawn("tp_world4", 4, tmp_path_factory.mktemp("tp4"), payload,
                       meanwhile=lambda: {**tp_train_steps(0, 1, payload, None, tp=1), "stage": tp_stage(one_cfg)})
    return {"ranks": ranks, "one": one, "root": root}


@pytest.mark.parametrize("step", range(STEPS))
def test_dp2_tp2_steps_match_one_process(world4, step):
    got, want = world4["ranks"][0]["steps"][step], world4["one"]["steps"][step]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
    assert_close_after_adamw(got["adapters"], want["adapters"], f"adapters after step {step}", lr=LR)


def test_lora_stage_at_dp2_tp2_equals_one_process(world4):
    """`train_from_config` with `tensor_parallel: 2` over a world of 4: the
    input rows and the noise go by data rank, the adapters' partial
    gradients are summed over the model group, global rank 0 saves once."""
    want = world4["one"]["stage"]
    for rank in world4["ranks"]:
        got = rank["stage"]
        np.testing.assert_allclose(got["result"]["train/loss"], want["result"]["train/loss"], rtol=1e-5)
        assert got["result"]["global_step"] == want["result"]["global_step"] == 1.0
        assert_close_after_adamw(got["adapters"], want["adapters"], "stage adapters", lr=1e-3)
        for k, v in got["adapters"].items():
            assert torch.equal(v, world4["ranks"][0]["stage"]["adapters"][k]), k
    assert sorted(p.name for p in (world4["root"] / "tp").iterdir()) == ["final", "metrics.jsonl"]


def test_dp2_tp2_replicas_are_bit_identical(world4):
    """The model group's replicas (ranks 0 and 1, 2 and 3) and the data
    group's all hold the same adapters after every step."""
    for step in range(STEPS):
        first = world4["ranks"][0]["steps"][step]
        for other in world4["ranks"][1:]:
            for k, v in first["adapters"].items():
                assert torch.equal(v, other["steps"][step]["adapters"][k]), (step, k)


# ---------------------------------------------------------------------------
# The entry points' checks (no process is spawned)
# ---------------------------------------------------------------------------
ENTRY_ARGS = ["--pretrained_model_name_or_path", "m", "--rgba_vae_path", "v"]


@pytest.mark.parametrize("entry", ["inference", "daemon"])
def test_tp_without_a_process_group_names_torchrun(entry):
    from ragb_vae_tpu_torch import inference, serving_daemon

    if entry == "inference":
        args = inference.parse_args(ENTRY_ARGS + ["--input_image", "i", "--output_path", "o",
                                                  "--tp", "2", "--device", "cpu"])
        run = lambda: inference.run(args)      # noqa: E731
    else:
        args = serving_daemon.parse_args(ENTRY_ARGS + ["--tp", "2", "--device", "cpu"])
        run = lambda: serving_daemon.build_server(args)      # noqa: E731
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        run()


@pytest.mark.parametrize("entry", ["inference", "daemon"])
def test_tp_and_pp_together_are_refused(entry):
    from ragb_vae_tpu.parallel.bootstrap import validate_tp_pp as jvalidate
    from ragb_vae_tpu_torch import inference, serving_daemon

    with pytest.raises(SystemExit) as want:
        jvalidate(2, 2)
    extra = ["--tp", "2", "--pp", "2", "--device", "cpu"]
    if entry == "inference":
        args = inference.parse_args(ENTRY_ARGS + ["--input_image", "i", "--output_path", "o"] + extra)
        run = lambda: inference.run(args)      # noqa: E731
    else:
        args = serving_daemon.parse_args(ENTRY_ARGS + extra)
        run = lambda: serving_daemon.build_server(args)      # noqa: E731
    with pytest.raises(SystemExit) as got:
        run()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("tp", [5, 7])
def test_a_degree_that_misses_the_heads_raises_before_any_model_is_built(tmp_path, monkeypatch, tp):
    """The LoRA stage reads the checkpoint's config.json and refuses the
    degree before it builds or reads anything else (24 heads: 5 and 7)."""
    from ragb_vae_tpu_torch.models import flux_kontext_textalpha as fkt
    from ragb_vae_tpu_torch.training import flux_kontext_textalpha_lora as tstage

    (tmp_path / "transformer").mkdir()
    FluxTransformerConfig()  # FLUX.1: 24 heads
    import json

    (tmp_path / "transformer" / "config.json").write_text(json.dumps({"num_attention_heads": 24}))
    monkeypatch.setattr(fkt.FluxTextAlphaModel, "from_pretrained",
                        lambda *a, **k: pytest.fail("a model was built"))
    cfg = {"model": {"pretrained_model_name_or_path": str(tmp_path), "rgba_vae_path": "v"},
           "data": {"root": "d"}, "training": {"tensor_parallel": tp}}
    with pytest.raises(ValueError, match=f"tensor_parallel={tp} must divide the 24 attention heads"):
        tstage.train_from_config(cfg, device="cpu")


def test_tp_with_shard_base_params_is_refused_as_in_jax():
    from ragb_vae_tpu_torch.training import flux_kontext_textalpha_lora as tstage

    cfg = {"model": {"pretrained_model_name_or_path": "m", "rgba_vae_path": "v"}, "data": {"root": "d"},
           "training": {"tensor_parallel": 2, "shard_base_params": True}}
    with pytest.raises(ValueError, match="mutually exclusive"):
        tstage.train_from_config(cfg, device="cpu")


@pytest.mark.parametrize("tp", [1, 2, 3, 4, 6, 8, 12, 24])
def test_flux_degrees_pass_the_kernels_checks(tp):
    ttp.validate_tp(FluxTransformerConfig(), tp, cuda=True, weight_quant="int8")


def test_sequence_parallel_is_not_ported():
    """A sequence axis is ported (`tests/test_torch_parallel_axes.py`); without
    a process group it raises the ValueError that names torchrun, at JAX's
    axis checks."""
    from ragb_vae_tpu_torch.parallel.mesh import create_training_mesh

    with pytest.raises(ValueError, match=r"sequence_parallel=2 needs a process group .*torchrun"):
        create_training_mesh(tp=1, sp=2)
    assert [m.size for m in create_training_mesh()] == [1, 1, 1]
