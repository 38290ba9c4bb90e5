"""The loss priors Eb / Eb^2 (`models/losses.py`), the three-value composite
background (`ops/rgba.py`) and K8's G are small constant tensors kept per
(values, dtype, device) by `device.constant`: on CUDA, building one from a
Python sequence on every call is a host-to-device copy that makes the host
wait for the queued forward. The values stay the same bit for bit, and a
second call builds no tensor from the host.
"""
import numpy as np
import pytest
import torch

from ragb_vae_tpu_torch import device as tdev
from ragb_vae_tpu_torch.models import losses as tl
from ragb_vae_tpu_torch.ops import rgba as tr
from ragb_vae_tpu_torch.ops.kernels import resnet_block as rb


def _inputs(seed, shape=(2, 8, 8, 4)):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)) for _ in range(2)]


def _loss_with_fresh_priors(pred, target, eb, eb2):
    """The loss as written before the priors were kept: new tensors per call."""
    target_alpha = (target[..., 3:] + 1.0) * 0.5
    pred_alpha = (pred[..., 3:] + 1.0) * 0.5
    rgba_diff = target[..., :3] * target_alpha - pred[..., :3] * pred_alpha
    alpha_diff = target_alpha - pred_alpha
    eb_t = torch.tensor(eb, dtype=torch.float32)
    eb2_t = torch.tensor(eb2, dtype=torch.float32)
    loss = rgba_diff**2 - 2.0 * eb_t * rgba_diff * alpha_diff + eb2_t * alpha_diff**2
    return tl.reduce_loss(loss, reduce_mean=False)


class _CountTensor:
    """Counts `torch.tensor` calls (each one a host copy on CUDA)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = torch.tensor

        def counting(*args, **kwargs):
            self.calls += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(torch, "tensor", counting)


@pytest.mark.parametrize("eb,eb2", [(tl.DEFAULT_EB, tl.DEFAULT_EB2), ((0.1, -0.2, 0.3), [0.5, 0.25, 1.0])])
def test_reconstruction_loss_is_unchanged_and_builds_its_priors_once(monkeypatch, eb, eb2):
    pred, target = _inputs(0)
    want = _loss_with_fresh_priors(pred, target, eb, eb2)
    tl.alphavae_reconstruction_loss(pred, target, eb=eb, eb2=eb2)   # may build the priors
    counter = _CountTensor(monkeypatch)
    for _ in range(2):
        got = tl.alphavae_reconstruction_loss(pred, target, eb=eb, eb2=eb2)
        assert torch.equal(got, want)
    assert counter.calls == 0


def test_composite_background_is_unchanged_and_built_once(monkeypatch):
    rgba = _inputs(1)[0] * 0.5 + 0.5
    bg = (0.2, 0.4, 0.9)
    rgb, alpha = rgba[..., :3], rgba[..., 3:4]
    want = rgb * alpha + torch.tensor(bg).reshape(1, 1, 1, 3).expand_as(rgb) * (1.0 - alpha)
    tr.composite_over_background(rgba, bg)
    counter = _CountTensor(monkeypatch)
    for _ in range(2):
        assert torch.equal(tr.composite_over_background(rgba, list(bg)), want)
    assert counter.calls == 0


def test_wino_weights_keep_g_per_device(monkeypatch):
    w = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 3, 8, 16)).astype(np.float32))
    g = torch.tensor(rb._WINO_G, dtype=torch.float32)
    want = torch.einsum("xu,yv,uvcn->xycn", g, g, w)
    rb.wino_weights(w)
    counter = _CountTensor(monkeypatch)
    assert torch.equal(rb.wino_tiles(w), want)
    folded = rb.wino_weights(w)                        # JAX's row fold of the same tiles
    assert torch.equal(folded[1, :, :8], want[1]) and torch.equal(folded[1, :, 8:16], -want[2])
    assert counter.calls == 0


def test_constant_is_kept_per_values_dtype_and_device_and_safe_for_autograd():
    a = tdev.constant((1, 2.5, 3), torch.float32, "cpu")
    assert tdev.constant([1.0, 2.5, 3.0], torch.float32, torch.device("cpu")) is a
    assert tdev.constant((1, 2.5, 3), torch.bfloat16, "cpu") is not a
    assert tdev.constant((1, 2.5, 4), torch.float32, "cpu") is not a
    with torch.inference_mode():
        made_there = tdev.constant((7.0, 8.0), torch.float32, "cpu")
    assert not made_there.is_inference()
    x = torch.ones(2, requires_grad=True)
    (made_there * x).sum().backward()   # saved for backward: not an inference tensor
    assert torch.equal(x.grad, made_there)
