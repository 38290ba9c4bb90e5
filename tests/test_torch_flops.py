"""`ragb_vae_tpu_torch/ops/flops.py` against the JAX package's counts and
against `torch.utils.flop_counter.FlopCounterMode` on the port's modules.

Each analytic count must equal `ragb_vae_tpu.ops.flops`'s exactly (the same
walk, copied), on the tiny configs and on the published ones: the FLUX `ae`
(RGBA, 4 channels) and FLUX.1-Kontext-dev at the 512^2 and 1024^2 sequence
lengths (2048 and 8192 packed image tokens beside the 512 prompt tokens).

`FlopCounterMode` counts what the port's plain CPU route dispatches: every
conv at its full k^2 taps (no border discount, unlike XLA's cost model in
`tests/test_flops.py`) and every mm / bmm / addmm, and nothing elementwise.
That is what the walk counts, so the two must agree to COUNTER_RTOL; the
walk leaves out only what it states it leaves out.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from ragb_vae_tpu.models.flux_transformer import FluxTransformerConfig as JaxFluxConfig
from ragb_vae_tpu.models.vae_config import AutoencoderConfig as JaxAutoencoderConfig
from ragb_vae_tpu.ops import flops as jflops
from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformer2D, FluxTransformerConfig
from ragb_vae_tpu_torch.models.vae import AutoencoderKL
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
from ragb_vae_tpu_torch.ops import flops

# The walk against FlopCounterMode on the same module and shapes. Both count
# 2 FLOPs a multiply-add over the same products, so they differ only by what
# the walk leaves out on purpose: nothing, for these modules on the plain
# route (measured: exactly equal). The bound keeps room for a float sum's
# rounding only; one resnet conv missed would move the tiny VAE's count by
# more than 5%.
COUNTER_RTOL = 1e-9

H100 = "NVIDIA H100 80GB HBM3"
PROMPT = 512                  # FLUX.1-Kontext's T5 prompt tokens
IMG_SEQ = {512: 2 * (512 // 16) ** 2, 1024: 2 * (1024 // 16) ** 2}


def _vae_pair(name: str):
    port, jax_cfg = getattr(AutoencoderConfig, name)(), getattr(JaxAutoencoderConfig, name)()
    for cfg in (port, jax_cfg):
        cfg.in_channels = cfg.out_channels = 4
    return port, jax_cfg


def _flux_pair(name: str):
    port = FluxTransformerConfig() if name == "kontext" else FluxTransformerConfig.tiny()
    jax_cfg = JaxFluxConfig(**{f.name: getattr(port, f.name) for f in dataclasses.fields(JaxFluxConfig)
                               if hasattr(port, f.name)})
    assert port.inner_dim == jax_cfg.inner_dim
    return port, jax_cfg


VAE_CASES = [("tiny", 32), ("tiny", 64), ("tiny", (48, 32)), ("flux", 512), ("flux", 1024), ("flux", (768, 512))]


@pytest.mark.parametrize("name,size", VAE_CASES)
def test_vae_counts_equal_jax(name, size):
    port, jax_cfg = _vae_pair(name)
    for fn in ("vae_encode_flops", "vae_decode_flops", "vae_forward_flops"):
        assert getattr(flops, fn)(port, size) == getattr(jflops, fn)(jax_cfg, size), fn
    for lpips in (False, True):
        assert flops.vae_train_step_flops(port, size, lpips=lpips) == \
            jflops.vae_train_step_flops(jax_cfg, size, lpips=lpips)
    assert flops.vgg16_feature_flops(size) == jflops.vgg16_feature_flops(size)
    assert flops.vgg16_feature_flops(size, in_channels=4) == jflops.vgg16_feature_flops(size, in_channels=4)


def test_flux_ae_roofline_magnitude():
    """The FLUX `ae` at 1024^2: 8-16 TFLOP an image, decode above encode (as
    the JAX package's test holds it)."""
    port, _ = _vae_pair("flux")
    assert 8e12 < flops.vae_forward_flops(port, 1024) < 16e12
    assert flops.vae_decode_flops(port, 1024) > flops.vae_encode_flops(port, 1024)


@pytest.mark.parametrize("name,size", [("tiny", 64), ("kontext", 512), ("kontext", 1024)])
def test_transformer_counts_equal_jax(name, size):
    port, jax_cfg = _flux_pair(name)
    img_seq, txt_seq = (IMG_SEQ[size], PROMPT) if name == "kontext" else (2 * (size // 16) ** 2, 4)
    assert flops.flux_transformer_flops(port, img_seq, txt_seq) == \
        jflops.flux_transformer_flops(jax_cfg, img_seq, txt_seq)
    assert flops.lora_train_step_flops(port, img_seq, txt_seq) == \
        jflops.lora_train_step_flops(jax_cfg, img_seq, txt_seq)
    vae, jax_vae = _vae_pair("flux" if name == "kontext" else "tiny")
    for steps in (4, 28):
        assert flops.textalpha_sample_flops(port, vae, size, steps, txt_seq) == \
            jflops.textalpha_sample_flops(jax_cfg, jax_vae, size, steps, txt_seq)


def test_kontext_magnitudes():
    """FLUX.1-Kontext-dev: 11.9 B parameters, of which 3.25 B are the AdaLN
    modulation that runs once a sample, not once a token: about 2 x 8.6e9
    FLOPs a token in the dense layers, so a 512^2 forward (2560 tokens) is
    30-50 TFLOP and a 1024^2 one (8704 tokens, attention growing as S^2)
    more than 3.4 times that; a LoRA step 2-3.5 forwards."""
    port, _ = _flux_pair("kontext")
    f512 = flops.flux_transformer_flops(port, IMG_SEQ[512], PROMPT)
    f1024 = flops.flux_transformer_flops(port, IMG_SEQ[1024], PROMPT)
    assert 30e12 < f512 < 50e12 and f1024 > 3.4 * f512
    lora = flops.lora_train_step_flops(port, IMG_SEQ[512], PROMPT)
    assert 2.0 * f512 < lora < 3.5 * f512


def _counted(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            fn()
    return float(counter.get_total_flops())


@pytest.mark.parametrize("size", [(32, 32), (64, 48)])
def test_vae_walk_matches_flop_counter(size):
    """The tiny `ae`'s encoder and decoder, unfused (F.conv2d and the plain
    mid-block attention), one image."""
    cfg, _ = _vae_pair("tiny")
    torch.manual_seed(0)
    vae = AutoencoderKL(cfg).eval()
    h, w = size
    x = torch.zeros((1, h, w, 4))
    z = torch.zeros((1, h // cfg.spatial_scale_factor, w // cfg.spatial_scale_factor, cfg.latent_channels))
    enc, dec = _counted(lambda: vae.encode(x)), _counted(lambda: vae.decode(z))
    np.testing.assert_allclose(enc, flops.vae_encode_flops(cfg, size), rtol=COUNTER_RTOL)
    np.testing.assert_allclose(dec, flops.vae_decode_flops(cfg, size), rtol=COUNTER_RTOL)


@pytest.mark.parametrize("img_seq,txt_seq", [(32, 4), (128, 8)])
def test_transformer_walk_matches_flop_counter(img_seq, txt_seq):
    """The tiny transformer's forward on the plain route, batch 1."""
    cfg = FluxTransformerConfig.tiny()
    torch.manual_seed(0)
    model = FluxTransformer2D(cfg).eval()
    g = torch.Generator().manual_seed(1)
    inputs = dict(
        hidden_states=torch.randn((1, img_seq, cfg.in_channels), generator=g),
        encoder_hidden_states=torch.randn((1, txt_seq, cfg.joint_attention_dim), generator=g),
        pooled_projections=torch.randn((1, cfg.pooled_projection_dim), generator=g),
        timestep=torch.tensor([0.5]),
        img_ids=torch.zeros((img_seq, 3)),
        txt_ids=torch.zeros((txt_seq, 3)),
        guidance=torch.tensor([3.5]) if cfg.guidance_embeds else None,
    )
    counted = _counted(lambda: model(**inputs))
    np.testing.assert_allclose(counted, flops.flux_transformer_flops(cfg, img_seq, txt_seq), rtol=COUNTER_RTOL)


def test_peak_table_and_mfu():
    assert flops.peak_flops_for(H100) == 989e12
    # a TPU's JAX device kind answers as the JAX package's table does
    for kind in ("TPU v5 lite", "TPU v6e", "TPU v4"):
        assert flops.peak_flops_for(kind) == jflops.peak_flops_for(kind)
    # a name the table does not hold: no guess
    for kind in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "cpu", ""):
        assert flops.peak_flops_for(kind) is None and flops.mfu(1.0, 1e12, kind) is None
    # 2 images/s of 98.9 TFLOP each on an H100 is 20% of its peak
    assert flops.mfu(2.0, 98.9e12, H100) == pytest.approx(0.2, rel=1e-12)
    assert flops.mfu(2.0, 98.9e12, "TPU v6e") == jflops.mfu(2.0, 98.9e12, "TPU v6e")
