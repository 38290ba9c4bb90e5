"""A run with the timed path broken underneath comes out not correct: once
for each fault the cell can have (an answer altered where it is produced;
a step that leaves the state unchanged; half of the batch left out, the
mean taken over the rest). The exchange between chips: no cell here has one."""
import pytest
import torch

from perfbench.tests import tiny


def _altered_answer(monkeypatch):
    from ragb_vae_tpu_torch.models import flux_kontext_textalpha as m

    decode = m.FluxTextAlphaModel.decode_latents
    monkeypatch.setattr(m.FluxTextAlphaModel, "decode_latents",
                        lambda self, lat: torch.clamp(decode(self, lat) + 0.08, 0.0, 1.0))


def _unchanged_state(monkeypatch):
    from ragb_vae_tpu_torch.parallel import zero_step

    def step(self, w_local=None):
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        for p in self.params:
            p.grad = None
        return norm

    monkeypatch.setattr(zero_step.ZeroAdamW, "step", step)


def _half_batch_vae(monkeypatch):
    from ragb_vae_tpu_torch.training import vae_step

    loss_fn = vae_step.vae_loss_fn

    def half(model, batch, **kw):
        n = batch["images"].shape[0] // 2
        return loss_fn(model, {k: v[:n] for k, v in batch.items()}, **kw)

    monkeypatch.setattr(vae_step, "vae_loss_fn", half)


def _half_batch_lora(monkeypatch):
    from ragb_vae_tpu_torch.models import flux_kontext_textalpha as m

    loss = m.FluxTextAlphaModel.compute_loss

    def half(self, gt, text_alpha, generator, weights=None, mesh=None):
        n = gt.shape[0] // 2
        return loss(self, gt[:n], text_alpha[:n], generator, None if weights is None else weights[:n], mesh)

    monkeypatch.setattr(m.FluxTextAlphaModel, "compute_loss", half)


@pytest.mark.parametrize("name, plant", [
    ("serve-512-bf16", _altered_answer),
    ("vae-stage1-512", _unchanged_state),
    ("vae-stage1-512", _half_batch_vae),
    ("lora-512-b8", _unchanged_state),
    ("lora-512-b8", _half_batch_lora),
], ids=["serve-altered-answer", "vae-unchanged-state", "vae-half-batch", "lora-unchanged-state",
        "lora-half-batch"])
def test_fault_is_not_correct(monkeypatch, name, plant):
    plant(monkeypatch)
    record = tiny.run(name)
    assert not record.correct, [(c.name, c.value, c.limit) for c in record.checks]
