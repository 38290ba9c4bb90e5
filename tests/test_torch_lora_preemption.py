"""The port's LoRA stage under preemption, on the CPU at tiny size: a run
stopped by the guard after step 2 leaves a resumable `checkpoint-2` and no
`final`, `resume_from: auto` continues it to step 3, and `metrics.jsonl`
carries the records the JAX stage's logger writes. Also the guard itself: a
real SIGTERM on the main thread, and off the main thread (where
`signal.signal` raises) no handler and a stop by `request_stop` only.
"""
import json
import signal
import threading

import pytest
import torch

from ragb_vae_tpu.utils.metrics_logger import MetricsLogger as JaxMetricsLogger
from ragb_vae_tpu_torch.models.flux_kontext_textalpha import read_lora_metadata
from ragb_vae_tpu_torch.training import flux_kontext_textalpha_lora as tstage
from ragb_vae_tpu_torch.utils.preemption import PreemptionGuard
from tests.data_fixtures import make_text_alpha_tree
from tests.test_torch_lora_stage import _cfg, _tiny_model


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _stop_after(monkeypatch, n: int) -> None:
    """`should_stop` fires from its n-th poll on: the loop polls once a step,
    so this stands in for a SIGTERM landing during step n."""
    real = PreemptionGuard.should_stop
    calls = {"n": 0}

    def should_stop(self, sync=False):
        calls["n"] += 1
        if calls["n"] >= n:
            self.request_stop()
        return real(self, sync)

    monkeypatch.setattr(PreemptionGuard, "should_stop", should_stop)


def _one_pair_steps(root, **training):
    """The LoRA stage tests' config at one pair a step, in one micro-batch."""
    cfg = _cfg(root, grad_accum_steps=1, **training)
    cfg["data"]["batch_size"] = 1
    return cfg


def test_preempted_run_checkpoints_then_resumes(tmp_path, monkeypatch):
    make_text_alpha_tree(tmp_path / "data", n=3)
    ckpt = tmp_path / "ckpt"
    model = _tiny_model()
    _stop_after(monkeypatch, 2)
    logged = []
    out = tstage.train_from_config(_one_pair_steps(tmp_path, max_train_steps=10, ckpt_every_steps=1000),
                                   model=model, device="cpu", log_fn=lambda s, m: logged.append(s))
    assert out["preempted"] == 1.0 and out["global_step"] == 2.0
    assert logged == [1, 2]                                   # log_fn keeps working beside the logger
    assert (ckpt / "checkpoint-2" / tstage.TRAIN_STATE_FILE).exists()
    assert read_lora_metadata(ckpt / "checkpoint-2")["step"] == 2
    assert not (ckpt / "final").exists()
    assert sorted(p.name for p in ckpt.iterdir()) == ["checkpoint-2", "metrics.jsonl"]

    # the records the JAX stage's logger writes for the same step
    records = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    jax_logger = JaxMetricsLogger(tmp_path / "jax")
    jax_logger.log({"train/loss": records[0]["train/loss"], "lr": records[0]["lr"]}, step=1)
    want = json.loads((tmp_path / "jax" / "metrics.jsonl").read_text())
    assert [r["step"] for r in records] == [1, 2]
    assert all(r.keys() == want.keys() for r in records)
    assert [r["lr"] for r in records] == pytest.approx([tstage.cosine_decay_schedule(1e-3, 10)(s) for s in (1, 2)])

    monkeypatch.undo()
    # the same base; the adapters and the optimizer's state come from checkpoint-2
    out = tstage.train_from_config(_one_pair_steps(tmp_path, max_train_steps=3, resume_from="auto"),
                                   model=model, device="cpu")
    assert "preempted" not in out and out["global_step"] == 3.0
    assert read_lora_metadata(ckpt / "final")["step"] == 3
    state = torch.load(ckpt / "final" / tstage.TRAIN_STATE_FILE, weights_only=True)
    assert {float(s["step"]) for s in state["optimizer"]["state"].values()} == {3.0}


def test_handle_preemption_flag_and_key():
    base = {"model": {"pretrained_model_name_or_path": "m", "rgba_vae_path": "v"}, "data": {"root": "d"}}
    assert not hasattr(tstage.build_args_from_cfg(base), "handle_preemption")   # absent: on, as in JAX
    off = tstage.build_args_from_cfg({**base, "training": {"handle_preemption": False}})
    assert off.handle_preemption is False
    required = ["--pretrained_model_name_or_path", "m", "--rgba_vae_path", "v", "--data_root", "d"]
    assert tstage.parse_args(required + ["--no-handle_preemption"]).handle_preemption is False
    assert tstage.parse_args(required + ["--handle_preemption"]).handle_preemption is True


def test_guard_takes_a_real_sigterm_on_the_main_thread():
    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.should_stop()
        signal.raise_signal(signal.SIGTERM)
        assert guard.should_stop() and "SIGTERM" in guard.describe()
    assert signal.getsignal(signal.SIGTERM) is prev


def test_guard_off_the_main_thread_installs_nothing():
    prev = signal.getsignal(signal.SIGTERM)
    seen = {}

    def run():
        with PreemptionGuard() as guard:
            seen["handler"] = signal.getsignal(signal.SIGTERM)
            seen["before"] = guard.should_stop()
            guard.request_stop()
            seen["after"] = guard.should_stop()

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=30)
    assert not thread.is_alive()
    assert seen == {"handler": prev, "before": False, "after": True}
    assert signal.getsignal(signal.SIGTERM) is prev


def test_stop_requested_reads_the_local_flag():
    guard = PreemptionGuard(enabled=False)
    assert guard.stop_requested is False
    guard.request_stop()
    assert guard.stop_requested is True
