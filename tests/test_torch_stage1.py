"""The port's stage-1 loop (`train_rgba_vae`, `run_stage`,
`scripts/train_torch.py`) on the CPU, with a tiny RGBA VAE and PNG trees of
32 x 32 and 48 x 32 images.

- The loop for real: steps logged, validation through the tiled path (the
  48 x 32 images exceed the 32-pixel tile), periodic and final saves,
  `resume_from: auto` at the right step with the saved optimizer state.
- The batch stream against the JAX loop's on the same tree and config: both
  loops run with their train step replaced by one that records its batch, so
  the comparison is of what reaches the step, in order, across an epoch
  boundary and across a resume (pixels to 1e-6 relative: the two packages
  scale the PNG bytes by another route; the random background blend draws
  one numpy stream in both).
- Dispatch, the script, and the refused options raise.
"""
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ragb_vae_tpu.training import checkpoint as jckpt
from ragb_vae_tpu.training import rgba_vae_stage as jstage
from ragb_vae_tpu_torch import training as ttraining
from ragb_vae_tpu_torch.models.lpips import random_lpips
from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
from ragb_vae_tpu_torch.models.vae import AutoencoderKL
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
from ragb_vae_tpu_torch.models.weights import save_autoencoder_params
from ragb_vae_tpu_torch.training import checkpoint as tckpt
from ragb_vae_tpu_torch.training import rgba_vae_stage as tstage
from tests.data_fixtures import _write_png

PIXEL_RTOL = 1e-6
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: tiny tensors gain
    nothing from intra-op threads, and the workers stop fighting for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """A tiny RGB checkpoint (seeded torch init), seeded LPIPS weights as a
    .pt in the lpips state-dict layout, and a components tree: per split,
    buckets w32-h32 and w48-h32 (train: 3 samples each, val: 1 each)."""
    root = tmp_path_factory.mktemp("stage1")
    cfg = AutoencoderConfig.tiny()
    cfg.in_channels = cfg.out_channels = 3
    torch.manual_seed(0)
    save_autoencoder_params(cfg, AutoencoderKL(cfg).state_dict(), root / "vae_init")
    lp = random_lpips(0)
    state = {}
    for name, value in lp.state_dict().items():
        if name.startswith("conv"):
            idx, kind = name[4:].split("_")
            state[f"net.slice0.{idx}.{kind}"] = value
        elif name.startswith("lin"):
            state[f"{name}.model.1.weight"] = value.reshape(1, -1, 1, 1)
    torch.save(state, root / "lpips.pt")
    manifest = []
    for split, count in (("train", 3), ("val", 1)):
        for bucket, (w, h) in (("w32-h32", (32, 32)), ("w48-h32", (48, 32))):
            for i in range(count):
                name = f"{split}_{bucket}_{i}"
                rels = {kind: f"{split}/{bucket}/{name}_{kind}.png" for kind in ("component", "composite")}
                for j, rel in enumerate(rels.values()):
                    _write_png(root / "data" / rel, w, h, seed=len(manifest) * 2 + j)
                manifest.append({"split": split, "bucket": bucket, "bucket_dims": [w, h],
                                 "component_path": rels["component"], "composite_path": rels["composite"],
                                 "source_sample": name, "component_index": 0, "original_size": [w, h]})
    (root / "data" / "metadata").mkdir(parents=True)
    (root / "data" / "metadata" / "manifest.json").write_text(json.dumps(manifest))
    return root


def _cfg(assets, out, **training):
    data = assets / "data"
    train = {"stage": "rgba_vae", "learning_rate": 1e-4, "epochs": 2, "ckpt_dir": str(out / "ckpts"),
             "mixed_precision": "no", "log_every": 1, "run_validation": False, "val_every_steps": 0,
             "val_max_batches": 1, "val_visual_rows": 2, "val_output_dir": str(out / "val"),
             "ckpt_every_steps": 0, "max_grad_norm": 1.0, "kl_scale": 1e-6, "ref_kl_scale": 0.0,
             "lpips_scale": 0.0, "loss_reduce_mean": True, "sample_vis_count": 0,
             "sample_vis_dir": str(out / "vis"), "seed": 0, "vae_tile_sample_size": 32,
             "vae_gradient_checkpointing": True, "handle_preemption": False}
    train.update(training)
    return {
        "data": {"source": "bucket", "bucket_root": str(data), "batch_size": 2, "num_workers": 0,
                 "shuffle": True, "interleave_buckets": True, "seed": 0, "background_blend_prob": 0.5,
                 "background_blend_targets": ["composite"], "val_shuffle": False,
                 "bucket_datasets": [{"type": "components", "root": str(data),
                                      "manifest": str(data / "metadata" / "manifest.json")}]},
        "training": train,
        "model": {"base_arch": "flux", "rgb_checkpoint": str(assets / "vae_init"), "rgb_subfolder": ""},
    }


def test_the_loop_logs_validates_saves_and_resumes(assets, tmp_path):
    cfg = _cfg(assets, tmp_path, max_steps=2, run_validation=True, val_every_steps=2, ckpt_every_steps=1,
               ref_kl_scale=1e-16, lpips_scale=0.5, lpips_weights=str(assets / "lpips.pt"), sample_vis_count=2,
               vae_gradient_checkpointing=False)
    metrics = ttraining.run_stage(cfg, device="cpu")
    assert metrics["global_step"] == 2.0
    for key in ("train/loss", "train/lpips", "train/ref_kl", "train/grad_norm", "val/psnr_white",
                "val/psnr_black", "val/alpha_mae"):
        assert np.isfinite(metrics[key]), key
    logged = [json.loads(line) for line in (tmp_path / "ckpts" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in logged] == [1, 2] and all(np.isfinite(r["train/loss"]) for r in logged)
    assert len(list((tmp_path / "val").glob("val_recon_epoch_0_step_2.png"))) == 1
    assert len(list((tmp_path / "vis").glob("sample_*.png"))) == 2
    for step in (1, 2):
        d = tckpt.checkpoint_dir(tmp_path / "ckpts", step)
        assert tckpt.is_complete_checkpoint(d) and json.loads((d / tckpt.META_FILE).read_text())["step"] == step
        saved = json.loads((d / tckpt.HF_SUBDIR / "config.json").read_text())
        assert saved["in_channels"] == saved["out_channels"] == 4

    cfg["training"].update(resume_from="auto", max_steps=1)
    metrics = ttraining.run_stage(cfg, device="cpu")
    assert metrics["global_step"] == 3.0 and np.isfinite(metrics["train/loss"])
    _, _, train_state, meta = tckpt.load_train_checkpoint(tckpt.checkpoint_dir(tmp_path / "ckpts", 3))
    assert meta["step"] == train_state["step"] == 3
    # the optimizer went on from the saved state: three updates, not one
    assert {float(s["step"]) for s in train_state["optimizer"]["state"].values()} == {3.0}


def _record_port(monkeypatch, seen, models=None):
    """Replace the port loop's train step with one that records the real rows
    of each batch (and, when asked, the model's weights at that step)."""
    def make(model, optimizer, *args, **kwargs):
        def step(batch, generator=None, eps=None):
            seen.append(batch["images"].numpy()[batch["weights"].numpy() > 0])
            if models is not None:
                models.append(({k: v.clone() for k, v in model.module.state_dict().items()},
                               [float(s.get("step", 0)) for s in optimizer.state.values()]))
            return {"train/loss": torch.tensor(1.0)}
        return step
    monkeypatch.setattr(tstage, "make_train_step", make)


def _record_jax(monkeypatch, seen):
    def make(model, tx, *args, **kwargs):
        def step(params, opt_state, batch, key):
            seen.append(np.asarray(batch["images"])[np.asarray(batch["weights"]) > 0])
            return params, opt_state, {"train/loss": jnp.asarray(1.0)}
        return step
    monkeypatch.setattr(jstage, "make_train_step", make)


def _same_stream(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=PIXEL_RTOL, atol=PIXEL_RTOL)


def test_batch_stream_and_resume_position_match_the_jax_loop(assets, tmp_path, monkeypatch, capsys):
    """Six steps over two epochs of four batches, straight through and as
    three steps plus `resume_from: auto` for three more, in both packages."""
    streams = {}
    for name, record, stage in (("port", _record_port, tstage), ("jax", _record_jax, jstage)):
        runs = []
        for label, parts in (("straight", [dict(max_steps=6)]),
                             ("resumed", [dict(max_steps=3), dict(max_steps=3, resume_from="auto")])):
            seen = []
            record(monkeypatch, seen)
            for part in parts:
                cfg = _cfg(assets, tmp_path / name / label, **part)
                if stage is tstage:
                    stage.train_rgba_vae(cfg, device="cpu")
                else:
                    stage.train_rgba_vae(cfg)
            runs.append(seen)
        streams[name] = runs
        assert "resume position: epoch 0, skipping 3 batches" in capsys.readouterr().out
    _same_stream(streams["port"][0], streams["jax"][0])
    _same_stream(streams["port"][1], streams["port"][0])
    _same_stream(streams["jax"][1], streams["jax"][0])
    assert len(streams["port"][0]) == 6


def test_a_jax_checkpoint_resumes_with_its_weights_step_and_a_fresh_optimizer(assets, tmp_path, monkeypatch):
    seen = []
    _record_jax(monkeypatch, seen)
    jstage.train_rgba_vae(_cfg(assets, tmp_path / "jax", max_steps=5))
    jax_dir = jckpt.checkpoint_dir(tmp_path / "jax" / "ckpts", 5)
    port_seen, models = [], []
    _record_port(monkeypatch, port_seen, models)
    metrics = tstage.train_rgba_vae(_cfg(assets, tmp_path / "port", max_steps=1, resume_from=str(jax_dir)),
                                    device="cpu")
    assert metrics["global_step"] == 6.0 and len(port_seen) == 1
    _, state, _, _ = tckpt.load_train_checkpoint(jax_dir)
    weights, optimizer_steps = models[0]
    for key, value in state.items():
        torch.testing.assert_close(weights[key], value, rtol=0, atol=0)
    assert set(optimizer_steps) == {0.0}


@pytest.mark.parametrize("stage", ["rgba_vae", "kontext_textalpha_lora", "decompose", "refine", "sdxl"])
def test_run_stage_dispatches_as_jax_does(monkeypatch, stage):
    from ragb_vae_tpu_torch.training import flux_kontext_textalpha_lora as lora

    calls = []
    monkeypatch.setattr(tstage, "train_rgba_vae", lambda cfg, **kw: calls.append(("rgba_vae", kw)) or "vae")
    monkeypatch.setattr(lora, "train_from_config", lambda cfg, **kw: calls.append(("lora", kw)) or "lora")
    cfg = {"training": {"stage": stage}}
    if stage in ("decompose", "refine"):
        with pytest.raises(NotImplementedError):
            ttraining.run_stage(cfg)
    elif stage == "sdxl":
        with pytest.raises(ValueError, match="Unknown training stage"):
            ttraining.run_stage(cfg)
    else:
        assert ttraining.run_stage(cfg, device="cpu") == ("vae" if stage == "rgba_vae" else "lora")
        assert calls == [("rgba_vae" if stage == "rgba_vae" else "lora", {"device": "cpu"})]


def test_the_script_trains_on_the_cpu_and_refuses_a_missing_card(assets, tmp_path, monkeypatch):
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import train_torch
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    cfg = _cfg(assets, tmp_path, max_steps=1, stage="kontext_textalpha_lora")
    path = tmp_path / "stage1.yaml"
    path.write_text(yaml.safe_dump(cfg))
    metrics = train_torch.main(["--config", str(path), "--stage", "rgba_vae", "--device", "cpu"])
    assert metrics["global_step"] == 1.0
    assert tckpt.is_complete_checkpoint(tckpt.checkpoint_dir(tmp_path / "ckpts", 1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        train_torch.main(["--config", str(path)])


@pytest.mark.parametrize("option,match", [
    ({"zero_impl": "shard_map", "gradient_accumulation_steps": 2}, "shard_map"),
    ({"zero_impl": "shard_map", "optimizer_offload": True}, "optimizer_offload"),
    ("WORLD_SIZE", "more than one process"),
    ({"vae_gradient_checkpointing": "every_other"}, "vae_gradient_checkpointing"),
])
def test_what_is_not_ported_raises(assets, tmp_path, monkeypatch, option, match):
    """What the loop refuses: JAX's two refusals of `zero_impl: shard_map`
    (accumulation, offload), a WORLD_SIZE above 1 with no rendezvous to join,
    an unknown remat string. `shard_map` and `optimizer_offload` alone train
    (`tests/test_torch_zero_step.py`, `tests/test_torch_parallel_loop.py`)."""
    training = {}
    if option == "WORLD_SIZE":
        monkeypatch.setenv("WORLD_SIZE", "2")
    else:
        training = option
    with pytest.raises((NotImplementedError, ValueError), match=match):
        tstage.train_rgba_vae(_cfg(assets, tmp_path, max_steps=1, **training), device="cpu")


def test_the_loader_defaults_to_the_card(assets, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        RgbaVAE.from_pretrained_rgb(assets / "vae_init", "")
    with pytest.raises(RuntimeError, match="is_available"):
        tstage.train_rgba_vae(_cfg(assets, assets / "unused", max_steps=1))
    model = RgbaVAE.from_pretrained_rgb(assets / "vae_init", "", device="cpu")
    assert next(model.module.parameters()).device.type == "cpu" and model.config.in_channels == 4
