"""The frozen FLOP walks equal the program's `ops/flops.py` today."""
import dataclasses

import pytest

from perfbench import harness
from perfbench.yardstick import flops as FL

M = harness.load_manifest()
CONFIGS = {c["name"]: harness.config_of(M, {"config": c["name"]}) for c in M["configs"]}


def _port():
    from ragb_vae_tpu_torch.ops import flops as port
    from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig
    from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
    return port, FluxTransformerConfig, AutoencoderConfig


def _vae(d):
    _, _, AutoencoderConfig = _port()
    known = {f.name for f in dataclasses.fields(AutoencoderConfig)}
    return AutoencoderConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in known})


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("size", [256, 512, 1024])
def test_vae_counts(name, size):
    port, _, _ = _port()
    v = CONFIGS[name]["vae"]
    for fn in ("vae_encode_flops", "vae_decode_flops", "vae_forward_flops", "vae_train_step_flops"):
        assert getattr(FL, fn)(FL.as_config(v), size) == getattr(port, fn)(_vae(v), size)
    assert FL.vgg16_feature_flops(size) == port.vgg16_feature_flops(size)


@pytest.mark.parametrize("img_seq, txt_seq", [(2048, 512), (8192, 512), (64, 4)])
def test_transformer_counts(img_seq, txt_seq):
    port, FluxTransformerConfig, _ = _port()
    cfg = CONFIGS["flux-kontext-dev-textalpha"]
    t = FluxTransformerConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg["transformer"].items()})
    mine = FL.as_config(cfg["transformer"])
    assert FL.flux_transformer_flops(mine, img_seq, txt_seq) == port.flux_transformer_flops(t, img_seq, txt_seq)
    assert FL.lora_train_step_flops(mine, img_seq, txt_seq) == port.lora_train_step_flops(t, img_seq, txt_seq)
    assert FL.textalpha_sample_flops(mine, FL.as_config(cfg["vae"]), 512, 20, txt_seq) == \
        port.textalpha_sample_flops(t, _vae(cfg["vae"]), 512, 20, txt_seq)


def test_peak_matches_the_program():
    port, _, _ = _port()
    from perfbench.yardstick import work
    assert work.peak_flops("NVIDIA H100 80GB HBM3") == port.peak_flops_for("NVIDIA H100 80GB HBM3")
