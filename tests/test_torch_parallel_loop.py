"""The port's training loops over two gloo processes on the CPU: the
sharded loader, the synced preemption flag, the stage-1 loop with its
checkpoints across world sizes, and the LoRA stage on the data axis.

- `DataLoader(process_shard=)` hands each process the slice that the JAX
  loader hands it, with `global_batch_size`, and refuses a batch the
  processes do not divide (no processes needed).
- One spawn of two ranks (`tests/torch_dist_worker.py::loop_runs`) polls a
  guard that rank 1 flags, runs the stage-1 loop for two steps with
  validation (checkpoint `w2`), resumes the one-process run's checkpoint for
  a third step at world 2 (`w1_at_w2`), and takes one LoRA step. This
  process runs the same at world 1: two steps (`w1`), a third from the
  world-2 checkpoint (`w2_at_w1`), one LoRA step.

Every process draws the whole batch's noise and keeps its rows, so world 2
and world 1 compute the same steps on the same global batches, to another
summation order: the metrics to 1e-5 relative, the parameters and moments by
`assert_close_after_adamw` (mean error within 1e-5 of a tensor's largest
entry plus 1e-3 of one update, no entry beyond one update: AdamW amplifies
the rounding noise of near-zero gradients).
"""
import json

import numpy as np
import pytest
import torch

from ragb_vae_tpu.data.loader import DataLoader as JaxDataLoader
from ragb_vae_tpu_torch.data.loader import DataLoader
from ragb_vae_tpu_torch.models.flux_weights import lora_state
from ragb_vae_tpu_torch.parallel.mesh import Mesh
from ragb_vae_tpu_torch.parallel.zero_step import ZeroAdamW
from ragb_vae_tpu_torch.training import checkpoint as tckpt
from ragb_vae_tpu_torch.training import flux_kontext_textalpha_lora as tlora
from ragb_vae_tpu_torch.training import vae_step as tvs
from ragb_vae_tpu_torch.training.rgba_vae_stage import train_rgba_vae
from test_torch_stage1 import _cfg, assets  # noqa: F401
from tests.data_fixtures import make_text_alpha_tree
from tests.test_torch_lora_stage import _cfg as _lora_cfg
from torch_dist_worker import assert_close_after_adamw, noise_decides, spawn, tiny_lora_model

RTOL = 1e-5
STAGE_LR = 1e-4
LORA_LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _stage_cfg(assets, out, **training):
    cfg = _cfg(assets, out, **training)
    cfg["data"].update(drop_last=True, background_blend_prob=0.0)   # the blend's stream is per process
    return cfg


@pytest.fixture(scope="module")
def runs(assets, tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel")
    two = dict(max_steps=2, run_validation=True, val_every_steps=2, learning_rate=STAGE_LR)
    w1 = train_rgba_vae(_stage_cfg(assets, root / "w1", **two), device="cpu")
    make_text_alpha_tree(root / "data", n=4)
    lora_cfg = _lora_cfg(root, max_train_steps=1, grad_accum_steps=1, ckpt_every_steps=1000)
    lora_cfg["data"]["batch_size"] = 2
    payload = {
        "stages": [_stage_cfg(assets, root / "w2", **two),
                   _stage_cfg(assets, root / "w1_at_w2", max_steps=1, learning_rate=STAGE_LR,
                              resume_from=str(tckpt.checkpoint_dir(root / "w1" / "ckpts", 2)))],
        "lora": {**lora_cfg, "training": {**lora_cfg["training"], "ckpt_dir": str(root / "lora_w2")}},
    }
    model = tiny_lora_model()
    ranks, lora_w1 = spawn("loop_runs", 2, root / "spawn", payload,
                           meanwhile=lambda: tlora.train_from_config(lora_cfg, model=model, device="cpu"))
    w2_at_w1 = train_rgba_vae(_stage_cfg(assets, root / "w2_at_w1", max_steps=1, learning_rate=STAGE_LR,
                                         resume_from=str(tckpt.checkpoint_dir(root / "w2" / "ckpts", 2))),
                              device="cpu")
    return {"root": root, "ranks": ranks, "w1": w1, "w2_at_w1": w2_at_w1, "lora_w1": lora_w1,
            "adapters_w1": lora_state(model.transformer)}


def _checkpoint(root, run, step):
    _, state, train_state, _ = tckpt.load_train_checkpoint(tckpt.checkpoint_dir(root / run / "ckpts", step))
    return state, train_state


def _assert_same_checkpoint(got, want, lr):
    """Weights, step and optimizer state (indexed like the trainable
    parameters, which are the state dict's entries in order)."""
    (gstate, gtrain), (wstate, wtrain) = got, want
    assert_close_after_adamw(gstate, wstate, "weights", lr=lr, rtol=RTOL)
    assert gtrain["step"] == wtrain["step"]
    assert gtrain["optimizer"]["param_groups"] == wtrain["optimizer"]["param_groups"]
    names = list(wstate)
    for i, s in wtrain["optimizer"]["state"].items():
        assert float(gtrain["optimizer"]["state"][i]["step"]) == float(s["step"]) == wtrain["step"]
        moments = {k for k in s if k != "step"}
        assert_close_after_adamw({f"{names[i]}.{k}": gtrain["optimizer"]["state"][i][k] for k in moments},
                                 {f"{names[i]}.{k}": s[k] for k in moments}, "moments", lr=lr, rtol=RTOL)


@pytest.mark.parametrize("index", [(0, 2), (1, 2)], ids=["rank0", "rank1"])
def test_process_shard_slices_equal_the_jax_loaders(index):
    data = [{"x": np.full((2, 2, 4), float(i), np.float32)} for i in range(8)]
    got = list(DataLoader(data, batch_size=4, shuffle=True, seed=5, process_shard=index))
    want = list(JaxDataLoader(data, batch_size=4, shuffle=True, seed=5, process_shard=index))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["global_batch_size"] == w["global_batch_size"] == 4
        np.testing.assert_array_equal(g["x"], w["x"])
    with pytest.raises(ValueError, match="not divisible"):
        list(DataLoader(data, batch_size=3, process_shard=index))


def test_rank1_flag_stops_both_ranks_at_the_same_poll(runs):
    assert [r["polls"] for r in runs["ranks"]] == [[False, True, True]] * 2


def test_world2_loop_writes_one_checkpoint_equal_to_world1(runs):
    root = runs["root"]
    _assert_same_checkpoint(_checkpoint(root, "w2", 2), _checkpoint(root, "w1", 2), STAGE_LR)
    w2 = runs["ranks"][0]["stages"][0]
    for k in ("train/loss", "val/psnr_white", "val/psnr_black", "val/alpha_mae"):
        np.testing.assert_allclose(w2[k], runs["w1"][k], rtol=RTOL, err_msg=k)
        assert runs["ranks"][1]["stages"][0][k] == w2[k]
    # one writer: rank 0's log has one record a step, and one validation grid
    records = (root / "w2" / "ckpts" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(r)["step"] for r in records] == [1, 2]
    assert len(list((root / "w2" / "val").glob("*.png"))) == 1


@pytest.mark.parametrize("direction", ["world2_checkpoint_at_world1", "world1_checkpoint_at_world2"])
def test_checkpoints_resume_across_world_sizes(runs, direction):
    root = runs["root"]
    if direction == "world2_checkpoint_at_world1":
        # loaded at world 1, the moments are exactly the saved ones
        state, train_state = _checkpoint(root, "w2", 2)
        from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
        from ragb_vae_tpu_torch.training.checkpoint import load_train_checkpoint

        config, _, _, _ = load_train_checkpoint(tckpt.checkpoint_dir(root / "w2" / "ckpts", 2))
        model = RgbaVAE(config)
        model.module.load_state_dict(state)
        zero = ZeroAdamW(tvs.make_optimizer(tvs.trainable_parameters(model), STAGE_LR, max_grad_norm=1.0), Mesh())
        zero.load_state_dict(train_state["optimizer"])
        reloaded = zero.state_dict()
        for i, s in train_state["optimizer"]["state"].items():
            for k, v in s.items():
                torch.testing.assert_close(reloaded["state"][i][k], v, rtol=0, atol=0)
        got, other = "w2_at_w1", "w1_at_w2"
    else:
        assert runs["ranks"][0]["stages"][1]["global_step"] == 3.0
        got, other = "w1_at_w2", "w2_at_w1"
    # both resumed runs took the same third step
    _assert_same_checkpoint(_checkpoint(root, got, 3), _checkpoint(root, other, 3), STAGE_LR)


def test_lora_stage_takes_one_step_at_world2_equal_to_world1(runs):
    w2 = runs["ranks"][0]
    np.testing.assert_allclose(w2["lora"]["train/loss"], runs["lora_w1"]["train/loss"], rtol=RTOL)
    assert_close_after_adamw(w2["adapters"], runs["adapters_w1"], "adapters", lr=LORA_LR, rtol=RTOL)
    for k, v in w2["adapters"].items():
        torch.testing.assert_close(runs["ranks"][1]["adapters"][k], v, rtol=0, atol=0)
    saved = sorted(p.name for p in (runs["root"] / "lora_w2").iterdir())
    assert "final" in saved
    assert not [k for k in w2["adapters"] if noise_decides(k)]
