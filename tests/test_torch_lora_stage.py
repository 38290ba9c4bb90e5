"""The LoRA training stage of the port: optimizer and schedule against optax,
the config overlay and batch helpers against the JAX stage's, and the stage's
own loop (`train_from_config`) on the CPU at tiny size, with validation, a
save, a resume, and the saved adapters served through `inference.py`.

AdamW divides by sqrt(v), so where a gradient is near zero its noise decides
the update's sign and that element lands up to two updates away: after two
steps each adapter leaf is held to a mean error below 0.5% of one update's
size (lr 1e-3), with at most 1% of its elements off by more than 5% of it
(one element of a 64 x 4 adapter is 0.4%); every leaf must have moved by more
than 10% of lr.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from ragb_vae_tpu.models import flux_weights as jfw
from ragb_vae_tpu.parallel import accumulated_grads as jax_accumulated_grads
from ragb_vae_tpu.training import flux_kontext_textalpha_lora as jstage
from ragb_vae_tpu.training import rgba_vae_stage as jvae_stage
from ragb_vae_tpu_torch import inference
from ragb_vae_tpu_torch.data.image_io import load_rgba, save_rgba
from ragb_vae_tpu_torch.models import flux_weights as tfw
from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel, read_lora_metadata
from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
from ragb_vae_tpu_torch.training import flux_kontext_textalpha_lora as tstage
from tests.data_fixtures import make_text_alpha_tree
from tests.test_torch_lora_loss import pair  # noqa: F401
from tests.test_torch_serving import _write_jax_checkpoint
from tests.torch_dist_worker import assert_close_after_adamw

LR, T = 1e-3, 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The models here are tiny: one thread computes them as fast as many, and
    a test run with several worker processes does not oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("step", [0, 1, 2, 4, 9])
def test_cosine_schedule_matches_optax(step):
    want = optax.cosine_decay_schedule(3e-5, 4)(step)
    np.testing.assert_allclose(tstage.cosine_decay_schedule(3e-5, 4)(step), float(want), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("n_micro,weights", [(1, None), (2, [1.0, 1.0, 1.0, 0.0])], ids=["accum1", "accum2-padded"])
def test_adapters_after_two_clipped_adamw_steps_match_optax(pair, monkeypatch, n_micro, weights):  # noqa: F811
    """Two optimizer steps of the stage's step function (accumulation weighted
    by the real-sample count, optax-style clip, AdamW(0.9, 0.95), cosine
    schedule) against the JAX stage's chain over the JAX loss, with the
    latents, noise and density injected on both sides."""
    jmodel, params, tmodel = pair
    rng = np.random.default_rng(11)
    f = lambda: rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    steps = [dict(cond=f(), target=f(), noise=f(), u=rng.uniform(0.05, 0.95, 4).astype(np.float32))
             for _ in range(2)]
    base, lora0 = jfw.split_lora_params(params)

    # the JAX side: the stage's optax chain and accumulation
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(optax.cosine_decay_schedule(LR, T), b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01))

    def jax_loss(lora, mb, key):
        return jmodel.compute_loss_from_latents(jfw.merge_params(base, lora), mb["cond"], mb["target"],
                                                mb["noise"], mb["u"], weights=mb.get("weights"))

    @jax.jit
    def jax_step(lora, opt_state, batch):
        loss, _, grads = jax_accumulated_grads(
            jax_loss, lora, batch, jax.random.PRNGKey(0), n_micro,
            micro_weight_fn=(lambda mb: jnp.sum(mb["weights"])) if "weights" in batch else None)
        updates, opt_state = tx.update(grads, opt_state, lora)
        return optax.apply_updates(lora, updates), opt_state, loss, optax.global_norm(grads)

    # the port side: compute_loss takes its draws from the injected tensors
    start = tfw.lora_state(tmodel.transformer)
    pending = []
    monkeypatch.setattr(tmodel, "compute_loss", lambda gt, ta, gen, weights=None: tmodel.compute_loss_from_latents(
        gt, ta, *pending.pop(0), weights=weights))
    optimizer = tstage.make_lora_optimizer(list(tfw.lora_parameters(tmodel.transformer).values()), LR)
    train_step = tstage.make_lora_train_step(tmodel, optimizer, n_micro, tstage.cosine_decay_schedule(LR, T))
    try:
        lora, opt_state = lora0, tx.init(lora0)
        for i, s in enumerate(steps):
            jb = {k: jnp.asarray(v) for k, v in s.items()}
            tb = {"gt": torch.from_numpy(s["cond"]), "text_alpha": torch.from_numpy(s["target"])}
            if weights is not None:
                jb["weights"] = jnp.asarray(weights, jnp.float32)
                tb["weights"] = torch.tensor(weights)
            pending.extend(zip(torch.from_numpy(s["noise"]).chunk(n_micro), torch.from_numpy(s["u"]).chunk(n_micro)))
            lora, opt_state, want_loss, want_norm = jax_step(lora, opt_state, jb)
            loss, _, grad_norm = train_step(tb, None, i)
            np.testing.assert_allclose(loss.item(), float(want_loss), rtol=5e-4, err_msg=f"step {i}")
            np.testing.assert_allclose(grad_norm.item(), float(want_norm), rtol=2e-3, err_msg=f"step {i}")
            assert grad_norm.item() > 1.0  # the clip is active
            assert optimizer.param_groups[0]["lr"] == pytest.approx(float(optax.cosine_decay_schedule(LR, T)(i)))
        got = dict(jax.tree_util.tree_leaves_with_path(tfw.params_to_flax(tfw.lora_state(tmodel.transformer))))
        first = dict(jax.tree_util.tree_leaves_with_path(lora0))
        for path, leaf in jax.tree_util.tree_leaves_with_path(lora):
            name = jax.tree_util.keystr(path)
            err = np.abs(got[path] - np.asarray(leaf))
            assert np.abs(np.asarray(leaf) - first[path]).max() > 0.1 * LR, f"{name} did not move"
            assert err.mean() <= 0.005 * LR and np.mean(err > 0.05 * LR) <= 0.01, (name, err.max(), err.mean())
    finally:
        tfw.load_lora_state(tmodel.transformer, start)


# ---------------------------------------------------------------------------
# config overlay and helpers
# ---------------------------------------------------------------------------
def test_build_args_from_the_repo_config_matches_the_jax_stage():
    cfg = yaml.safe_load(open("configs/flux_kontext_textalpha_lora.yaml"))
    want, got = vars(jstage.build_args_from_cfg(cfg)), vars(tstage.build_args_from_cfg(cfg))
    assert got.pop("device") == "cuda"                                     # the port's own flag
    assert set(got) == set(want)
    assert got == want
    assert got["save_every"] == 1000 and got["val_every"] == 1000          # the synonyms
    assert got["val_max_samples"] == 16 and got["rank"] == 128 and got["lora_alpha"] == 192


def test_build_args_synonyms_and_env_token(monkeypatch):
    monkeypatch.setenv("LORA_TEST_TOKEN", "secret")
    cfg = {"model": {"pretrained_model_name_or_path": "m", "rgba_vae_path": "v", "hf_token": "${env:LORA_TEST_TOKEN}",
                     "vae_subfolder": ""},
           "data": {"root": "d", "val_batch_size": 3, "drop_last": True},
           "training": {"save_every": 5, "ckpt_every_steps": 7, "val_every_steps": 9, "val_max_batches": 2,
                        "resume_from": "auto", "grad_accum_steps": 2}}
    args = tstage.build_args_from_cfg(cfg)
    assert (args.save_every, args.val_every, args.val_max_samples) == (7, 9, 6)
    assert args.hf_token == "secret" and args.vae_subfolder == "" and args.drop_last is True
    assert args.resume_from == "auto" and args.grad_accum_steps == 2
    assert {k: v for k, v in vars(args).items() if k != "device"} == vars(jstage.build_args_from_cfg(cfg))
    assert tstage._resolve_env_token("plain") == "plain" and tstage._resolve_env_token(None) is None


def test_build_args_names_the_missing_fields():
    with pytest.raises(ValueError, match="model.pretrained_model_name_or_path, model.rgba_vae_path, data.root"):
        tstage.build_args_from_cfg({"training": {"rank": 4}})
    with pytest.raises(ValueError, match="Missing required config fields: data.root"):
        tstage.build_args_from_cfg({"model": {"pretrained_model_name_or_path": "m", "rgba_vae_path": "v"}})


@pytest.fixture(scope="module")
def world1_runs(tmp_path_factory):
    """One step of the stage on the tiny model at world 1, plain and over an
    int8 base -> (result, adapters) of each."""
    from ragb_vae_tpu_torch.models.flux_weights import lora_state

    root = tmp_path_factory.mktemp("world1")
    make_text_alpha_tree(root / "data", n=2)
    runs = {}
    for quant in ("none", "int8"):
        cfg = _cfg(root, max_train_steps=1, grad_accum_steps=1, ckpt_every_steps=1000, weight_quant=quant,
                   ckpt_dir=str(root / f"plain_{quant}"))
        cfg["data"].update(batch_size=2, num_workers=0)
        model = _tiny_model()
        if quant == "int8":
            from ragb_vae_tpu_torch.models.quantize import quantize_module_

            quantize_module_(model.transformer)
        runs[quant] = (cfg, tstage.train_from_config(cfg, model=model, device="cpu"),
                       lora_state(model.transformer))
    return runs


@pytest.mark.parametrize("flag", [{"weight_quant": "int8", "shard_base_params": True}, {"shard_base_params": True},
                                  {"tensor_parallel": 2, "sequence_parallel": 2}, {"sequence_parallel": 2}])
def test_unported_options_raise(flag, world1_runs, tmp_path):
    """Each option that raised before the port had it now takes its working
    path at world 1: `shard_base_params` (over a bf16 or an int8 base) runs
    and equals the plain run (the adapters as AdamW moves them, where a
    near-zero gradient's rounding decides an update's sign), as FSDP over a
    data axis of 1 splits nothing;
    `sequence_parallel` above 1 without a process group raises the
    ValueError that names torchrun."""
    from ragb_vae_tpu_torch.models.flux_weights import lora_state
    from ragb_vae_tpu_torch.models.quantize import quantize_module_

    if "sequence_parallel" in flag:
        cfg = {"model": {"pretrained_model_name_or_path": "m", "rgba_vae_path": "v"}, "data": {"root": "d"},
               "training": flag}
        with pytest.raises(ValueError, match="needs a process group .*run under torchrun"):
            tstage.train_from_config(cfg, model=_tiny_model(), device="cpu")
        return
    quant = flag.get("weight_quant", "none")
    base_cfg, want, want_adapters = world1_runs[quant]
    cfg = {**base_cfg, "training": {**base_cfg["training"], **flag, "ckpt_dir": str(tmp_path / "fsdp")}}
    model = _tiny_model()
    if quant == "int8":
        quantize_module_(model.transformer)
    got = tstage.train_from_config(cfg, model=model, device="cpu")
    assert model.transformer.fsdp is None
    assert got["global_step"] == want["global_step"] == 1.0
    np.testing.assert_allclose(got["train/loss"], want["train/loss"], rtol=1e-6)
    assert_close_after_adamw(lora_state(model.transformer), want_adapters, "adapters", lr=1e-3)


@pytest.mark.parametrize("n,multiple", [(3, 2), (4, 2), (1, 4), (5, 1)])
def test_padding_helpers_match_the_jax_stage(n, multiple):
    arr = np.random.default_rng(n).uniform(size=(n, 2, 2, 4)).astype(np.float32)
    want = jvae_stage.pad_to_multiple(arr, multiple)
    got = tstage.pad_to_multiple(arr, multiple)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tstage.padding_weights(n, got.shape[0]), jvae_stage.padding_weights(n, want.shape[0]))
    np.testing.assert_array_equal(tstage._to_uint8(arr * 1.2 - 0.1), jvae_stage._to_uint8(arr * 1.2 - 0.1))


def test_latest_complete_checkpoint_skips_a_dir_without_the_commit_marker(tmp_path):
    assert tstage.latest_complete_lora_checkpoint(tmp_path / "none") is None
    for step, complete in ((2, True), (10, True), (12, False)):
        d = tmp_path / f"checkpoint-{step}"
        d.mkdir()
        (d / "pytorch_lora_weights.safetensors").write_bytes(b"")
        if complete:
            (d / tstage.TRAIN_STATE_FILE).write_bytes(b"")
    (tmp_path / "final").mkdir()
    assert tstage.latest_complete_lora_checkpoint(tmp_path).name == "checkpoint-10"  # numeric, not lexical


# ---------------------------------------------------------------------------
# the stage's own loop
# ---------------------------------------------------------------------------
def _tiny_model():
    vcfg = AutoencoderConfig.tiny()
    vcfg.in_channels = vcfg.out_channels = 4
    return FluxTextAlphaModel.random(FluxTransformerConfig.tiny(), vcfg, seed=0, device="cpu", prompt_len=4)


def _cfg(root, **training):
    return {
        "model": {"pretrained_model_name_or_path": str(root / "flux"), "rgba_vae_path": str(root / "vae")},
        "data": {"root": str(root / "data"), "batch_size": 3, "num_workers": 2},
        "training": {"mixed_precision": "fp32", "max_train_steps": 2, "rank": 4, "lora_alpha": 8, "log_every": 1,
                     "ckpt_every_steps": 1, "ckpt_dir": str(root / "ckpt"), "grad_accum_steps": 2,
                     "learning_rate": 1e-3, "val_every_steps": 1000, "seed": 3,
                     "val_output_dir": str(root / "val"), **training},
    }


def test_train_from_config_takes_two_steps_saves_and_serves_the_adapters(tmp_path, capsys):
    """From a checkpoint tree on disk (written by the JAX package's savers):
    `from_pretrained` with adapters, 2 steps of 3 pairs in 2 micro-batches (one
    padding row), checkpoints in peft format, then `inference.py --lora_path`,
    which takes the adapters' rank and alpha from their `metadata.json` over
    `--rank` / `--lora_alpha`, as JAX's does."""
    _write_jax_checkpoint(tmp_path)
    make_text_alpha_tree(tmp_path / "data", n=6)
    logged = []
    out = tstage.train_from_config(_cfg(tmp_path), device="cpu", log_fn=lambda s, m: logged.append((s, m)))
    assert out["global_step"] == 2.0 and np.isfinite(out["train/loss"])
    assert [s for s, _ in logged] == [1, 2]
    assert all(np.isfinite(m["train/loss"]) and m["train/grad_norm"] > 0 for _, m in logged)
    assert all(m["data/wait_ms"] > 0 for _, m in logged)          # the feed's `data.next` counter
    assert capsys.readouterr().out.count(" data/wait_ms=") == 2
    assert logged[0][1]["lr"] == pytest.approx(0.5e-3) and logged[1][1]["lr"] == pytest.approx(0.0, abs=1e-12)
    for sub, step in (("checkpoint-1", 1), ("checkpoint-2", 2), ("final", 2)):
        d = tmp_path / "ckpt" / sub
        assert {p.name for p in d.iterdir()} == {"pytorch_lora_weights.safetensors", "metadata.json", "train_state.pt"}
        meta = read_lora_metadata(d)
        assert meta == {"model_id": str(tmp_path / "flux"), "rank": 4, "lora_alpha": 8.0, "dtype": "float32", "step": step}
    state = torch.load(tmp_path / "ckpt" / "final" / "train_state.pt", weights_only=True)
    assert set(state) == {"optimizer", "generator"} and state["optimizer"]["state"]
    # the adapters moved off their start (B = 0) and a JAX-side reader takes them
    lora = jfw.peft_state_to_lora_params(
        __import__("ragb_vae_tpu.models.weights", fromlist=["x"]).load_torch_state(
            tmp_path / "ckpt" / "final" / "pytorch_lora_weights.safetensors"))
    assert np.abs(lora["transformer_blocks_0"]["attn"]["to_q"]["lora_b"]).max() > 0

    src = tmp_path / "in.png"
    save_rgba(np.random.default_rng(3).uniform(size=(32, 32, 4)), src)
    argv = ["--pretrained_model_name_or_path", str(tmp_path / "flux"), "--rgba_vae_path", str(tmp_path / "vae"),
            "--input_image", str(src), "--steps", "2", "--seed", "0", "--precision", "fp32",
            "--device", "cpu"]
    inference.main(argv + ["--output_path", str(tmp_path / "base.png")])
    inference.main(argv + ["--output_path", str(tmp_path / "lora.png"), "--lora_path", str(tmp_path / "ckpt" / "final"),
                           "--rank", "4", "--lora_alpha", "8"])
    with_lora, without = load_rgba(tmp_path / "lora.png"), load_rgba(tmp_path / "base.png")
    assert with_lora.shape == (32, 32, 4) and not np.array_equal(with_lora, without)
    with pytest.raises(FileNotFoundError, match="No LoRA weights"):
        inference.main(argv + ["--output_path", str(tmp_path / "x.png"), "--lora_path", str(tmp_path / "data")])

    # no flags: rank 4 and alpha 8 come from final/metadata.json
    final = tmp_path / "ckpt" / "final"
    capsys.readouterr()
    inference.main(argv + ["--output_path", str(tmp_path / "meta.png"), "--lora_path", str(final)])
    assert "Loaded LoRA metadata: rank=4 alpha=8" in capsys.readouterr().out
    explicit = (tmp_path / "lora.png").read_bytes()
    assert (tmp_path / "meta.png").read_bytes() == explicit
    # a metadata alpha of 16 wins over --lora_alpha 8: the flags' run without the file at alpha 16
    alpha16, bare = tmp_path / "alpha16", tmp_path / "bare"
    for d in (alpha16, bare):
        d.mkdir()
        shutil.copy(final / "pytorch_lora_weights.safetensors", d)
    (alpha16 / "metadata.json").write_text(json.dumps({**read_lora_metadata(final), "lora_alpha": 16.0}))
    inference.main(argv + ["--output_path", str(tmp_path / "a16.png"), "--lora_path", str(alpha16),
                           "--lora_alpha", "8"])
    inference.main(argv + ["--output_path", str(tmp_path / "bare16.png"), "--lora_path", str(bare),
                           "--rank", "4", "--lora_alpha", "16"])
    assert (tmp_path / "a16.png").read_bytes() == (tmp_path / "bare16.png").read_bytes() != explicit


def test_train_from_config_validates_on_start_and_on_schedule(tmp_path):
    make_text_alpha_tree(tmp_path / "data", n=3)
    shutil.copytree(tmp_path / "data" / "train", tmp_path / "data" / "val")
    cfg = _cfg(tmp_path, run_validation_on_start=True, val_every_steps=2, val_max_batches=2,
               val_num_inference_steps=2, ckpt_every_steps=1000)
    cfg["data"]["val_split"] = "val"
    model = _tiny_model()
    before = {k: v.clone() for k, v in model.transformer.state_dict().items()}
    tstage.train_from_config(cfg, model=model, device="cpu")
    for label in ("start", "2"):
        pairs = sorted((tmp_path / "val" / f"step-{label}").glob("*_pair.png"))
        assert len(pairs) == 2                     # val_max_batches x val_batch_size
        assert load_rgba(pairs[0]).shape == (64, 128, 4)   # GT | prediction side by side
    after = model.transformer.state_dict()
    moved = {k for k in after if k in before and not torch.equal(after[k], before[k])}
    assert not moved                               # the base is frozen
    assert all(float(p.detach().abs().max()) > 0 for k, p in tfw.lora_parameters(model.transformer).items()
               if k.endswith("lora_B"))


def test_resume_auto_skips_an_uncommitted_checkpoint_and_continues(tmp_path):
    make_text_alpha_tree(tmp_path / "data", n=6)
    model = _tiny_model()
    tstage.train_from_config(_cfg(tmp_path), model=model, device="cpu")
    at_two = tfw.lora_state(model.transformer)
    # a crash in mid-save: a newer dir with adapters but no train state
    torn = tmp_path / "ckpt" / "checkpoint-5"
    shutil.copytree(tmp_path / "ckpt" / "checkpoint-2", torn)
    (torn / tstage.TRAIN_STATE_FILE).unlink()
    assert tstage.latest_complete_lora_checkpoint(tmp_path / "ckpt").name == "checkpoint-2"

    fresh = _tiny_model()
    logged = []
    out = tstage.train_from_config(_cfg(tmp_path, resume_from="auto", max_train_steps=3), model=fresh,
                                   device="cpu", log_fn=lambda s, m: logged.append(s))
    assert logged == [3] and out["global_step"] == 3.0       # one more step, from step 2
    assert json.loads((tmp_path / "ckpt" / "checkpoint-3" / "metadata.json").read_text())["step"] == 3
    resumed = tfw.lora_state(fresh.transformer)
    assert any(not torch.equal(resumed[k], at_two[k]) for k in at_two)
    # the optimizer's moments came back with the adapters: AdamW's step count is 3, not 1
    state = torch.load(tmp_path / "ckpt" / "checkpoint-3" / "train_state.pt", weights_only=True)
    assert {float(s["step"]) for s in state["optimizer"]["state"].values()} == {3.0}
    # a path to a JAX-written checkpoint (no train_state.pt): adapters and step only
    (tmp_path / "ckpt" / "checkpoint-3" / tstage.TRAIN_STATE_FILE).unlink()
    again = _tiny_model()
    out = tstage.train_from_config(
        _cfg(tmp_path, resume_from=str(tmp_path / "ckpt" / "checkpoint-3"), max_train_steps=3),
        model=again, device="cpu")
    assert out["global_step"] == 3.0
    assert all(torch.equal(v, resumed[k]) for k, v in tfw.lora_state(again.transformer).items())


def test_an_empty_loader_and_a_non_finite_loss_raise(tmp_path, monkeypatch):
    make_text_alpha_tree(tmp_path / "data", n=2)
    cfg = _cfg(tmp_path)
    cfg["data"].update(batch_size=4, drop_last=True)
    with pytest.raises(ValueError, match="yields no batches"):
        tstage.train_from_config(cfg, model=_tiny_model(), device="cpu")
    model = _tiny_model()
    real = model.compute_loss_from_latents
    monkeypatch.setattr(model, "compute_loss_from_latents",
                        lambda *a, **k: tuple(x * float("nan") if i == 0 else x for i, x in enumerate(real(*a, **k))))
    with pytest.raises(FloatingPointError, match="Non-finite loss at step 1"):
        tstage.train_from_config(_cfg(tmp_path), model=model, device="cpu")
