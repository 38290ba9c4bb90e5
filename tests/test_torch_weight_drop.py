"""The port's weight-drop rehearsals and chip_smoke's `weights` phase on the CPU.

- `scripts/rehearse_real_geometry_torch.py --small --device cpu` and
  `scripts/rehearse_aux_assets_torch.py --small --device cpu`, in process:
  every step's pass line; a square tensor written transposed
  (`single_transformer_blocks.0.attn.to_q.weight`: the shapes pass) fails
  the geometry rehearsal on its fingerprint.
- The aux rehearsal's synthetic LPIPS weights carry the inventory of
  `lpips.LPIPS(net="vgg").state_dict()` (the restatement in
  `tests/torch_lpips_ref.py`, plus the ScalingLayer buffers), and the
  port's distances from them are the JAX package's.
- Each new script raises without a card unless it is asked for the CPU.
- chip_smoke's `weights` phase at a narrow width on the CPU: the loads, the
  sample held against the model in memory, int8 at load, the VAE and LPIPS
  holds and both planted faults.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_weight_drop.py -q
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ragb_vae_tpu.models.lpips import load_lpips_params as jax_load_lpips_params
from ragb_vae_tpu.models.lpips import lpips_distance as jax_lpips_distance
from tests.torch_lpips_ref import make_lpips_state

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import rehearse_aux_assets_torch as aux  # noqa: E402
import rehearse_real_geometry_torch as rehearse  # noqa: E402
import record_goldens_torch  # noqa: E402


def test_geometry_rehearsal_small_on_the_cpu(tmp_path, capsys):
    assert rehearse.main(["--small", "--device", "cpu", "--workdir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for line in ("RGB -> RGBA widened", "VAE quant-conv variant: loaded and forward finite",
                 "record_goldens_torch (vae) ran clean", "140 value fingerprints verified",
                 "torch round trip keys, shapes and fingerprints exact (140)",
                 "140 fingerprints each in its own parameter", "LoRA: 36 target modules at rank 16",
                 "reloaded bit-equal to quantising at load", "ALL REHEARSALS PASSED at small geometry"):
        assert line in out, line
    for step in ("vae", "goldens", "transformer write", "transformer load", "from_pretrained bf16", "lora",
                 "int8 at load", "int8 script + reload"):
        assert f"[rehearse] step {step}: " in out, step
    assert (tmp_path / "transformer" / "diffusion_pytorch_model.safetensors.index.json").exists()
    assert len(list((tmp_path / "transformer").glob("*.safetensors"))) == 3


def test_geometry_rehearsal_catches_a_square_tensor_written_transposed(tmp_path, monkeypatch):
    key = "single_transformer_blocks.0.attn.to_q.weight"
    plain = rehearse.fingerprinted

    def planted(name, shape):
        t = plain(name, shape)
        return t.t().contiguous() if name == key else t

    monkeypatch.setattr(rehearse, "fingerprinted", planted)
    monkeypatch.setattr(rehearse, "rehearse_vae", lambda *args: None)
    with pytest.raises(SystemExit, match=r"1 fingerprints not in their own tensor.*" + key.replace(".", r"\.")):
        rehearse.main(["--small", "--device", "cpu", "--workdir", str(tmp_path), "--skip-goldens"])


def test_aux_rehearsal_small_on_the_cpu(tmp_path, capsys):
    assert aux.main(["--small", "--device", "cpu", "--workdir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for line in ("13 convs + 5 lins imported from safetensors/pt/features formats on cpu, identical distances",
                 "export_empty_prompt_torch (export) done", "export_empty_prompt_torch (cache) done",
                 "empty-prompt npz: shapes/branch/cache all OK", "ALL AUX-ASSET REHEARSALS PASSED at small geometry"):
        assert line in out, line


def test_synthetic_lpips_weights_carry_lpips_inventory_and_give_jax_distances(tmp_path):
    state = aux.lpips_state()
    want = {k: v.shape for k, v in make_lpips_state().items()}
    want.update({"scaling_layer.shift": (1, 3, 1, 1), "scaling_layer.scale": (1, 3, 1, 1)})
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    paths = aux.write_lpips_files(tmp_path)
    got = aux.lpips_distances(paths, torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)     # the pair `lpips_distances` draws
    pred = (torch.rand((2, 32, 32, 3), generator=gen) * 2 - 1).numpy()
    target = (torch.rand((2, 32, 32, 3), generator=gen) * 2 - 1).numpy()
    for tag in ("safetensors", "features"):
        ref = np.asarray(jax_lpips_distance(pred, target, jax_load_lpips_params(paths[tag])))
        np.testing.assert_allclose(got[tag].numpy(), ref, rtol=1e-4, atol=1e-6, err_msg=tag)


@pytest.mark.parametrize("script", ["rehearse_real_geometry_torch", "rehearse_aux_assets_torch"])
def test_each_rehearsal_raises_without_a_card_unless_asked_for_the_cpu(script, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    module = rehearse if script == "rehearse_real_geometry_torch" else aux
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main(["--small", "--workdir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_chip_smoke_weights_phase_runs_on_the_cpu_at_narrow_width(tmp_path, monkeypatch, capsys):
    """chip_smoke's `weights` phase, rehearsed on the CPU with the published
    width narrowed to the tiny configs (64 latent channels in, 16 out)."""
    import chip_smoke
    from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig
    from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig

    def tiny():
        t_cfg = FluxTransformerConfig.tiny()
        t_cfg.in_channels = 64
        return t_cfg, AutoencoderConfig.tiny(latent_channels=16)

    monkeypatch.setattr(chip_smoke, "_weights_configs", tiny)
    monkeypatch.setattr(chip_smoke, "WEIGHTS_SAMPLE_PX", 64)
    monkeypatch.setattr(chip_smoke, "WEIGHTS_VAE_PX", 32)
    counts = chip_smoke.phase_weights(tmp_path, device="cpu")
    assert set(counts) == {"resnet_conv3x3_stats", "subpixel_upsample_conv3x3_stats", "flash_attention_fwd",
                           "int8_matmul"}
    out = capsys.readouterr().out
    for line in ("weights bit-equal to the model in memory, prompt equal", "latents max |diff| 0.000e+00",
                 "the value check caught it", "the load raised naming the key", "identical"):
        assert line in out, line
    assert "vae on cpu against the goldens" in out
    assert record_goldens_torch.HOLD_REL_TOL == chip_smoke.WEIGHTS_VAE_REL_TOL
