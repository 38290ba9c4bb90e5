"""The port's copies of the reference's CLI scripts, run in-process on the CPU
over a tiny seeded RGB checkpoint that the test writes.

`convert_qwen_vae_to_rgba_torch.py` and `prepare_rgba_vae_init_torch.py`
write the same RGBA weights and config as the JAX package's scripts, bit for
bit; both sanity checks write their PNG grids with `--device cpu`, and raise
on the default `--device cuda` without a card.
"""
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from ragb_vae_tpu_torch.models.vae import AutoencoderKL
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
from ragb_vae_tpu_torch.models.weights import load_torch_state, save_autoencoder_params
from tests.data_fixtures import make_multilayer_tree

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: tiny tensors gain
    nothing from intra-op threads, and the workers stop fighting for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _script(name):
    """Import `scripts/<name>.py` as a module; sys.path as it was after."""
    saved = list(sys.path)
    sys.path.insert(0, str(SCRIPTS))
    try:
        return importlib.import_module(name)
    finally:
        sys.path[:] = saved


@pytest.fixture(scope="module")
def rgb_source(tmp_path_factory):
    """--source dir holding a seeded tiny RGB VAE in its 'vae' subfolder."""
    cfg = AutoencoderConfig.tiny()
    cfg.in_channels = cfg.out_channels = 3
    with torch.random.fork_rng():
        torch.manual_seed(0)
        state = AutoencoderKL(cfg).state_dict()
    source = tmp_path_factory.mktemp("rgb") / "src"
    save_autoencoder_params(cfg, state, source / "vae")
    return source


@pytest.mark.parametrize("where", ["subfolder", "fallback"])
def test_load_rgba_vae_from_path_matches_jax(rgb_source, where):
    """JAX's loader and the port's widen the same RGB checkpoint to the same
    RGBA weights, from `<path>/<subfolder>` or, when that subfolder does not
    exist, from the path itself."""
    from ragb_vae_tpu.models.flux_kontext_textalpha import load_rgba_vae_from_path as jax_load
    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import load_rgba_vae_from_path
    from ragb_vae_tpu_torch.models.weights import params_from_flax

    path, subfolder = (rgb_source, "vae") if where == "subfolder" else (rgb_source / "vae", "ae")
    jmodel, jparams = jax_load(path, subfolder=subfolder)
    vae = load_rgba_vae_from_path(path, subfolder=subfolder, device="cpu")
    assert jmodel.config.in_channels == vae.config.in_channels == 4
    want = params_from_flax(jparams)
    got = vae.module.state_dict()
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].dtype == torch.float32 and torch.equal(got[key], value), key


def _weights(directory):
    return json.loads((directory / "config.json").read_text()), load_torch_state(
        directory / "diffusion_pytorch_model.safetensors")


@pytest.mark.parametrize("script,flags", [
    ("convert_qwen_vae_to_rgba", ["--arch", "qwen"]),
    ("convert_qwen_vae_to_rgba", ["--arch", "flux", "--subfolder", "vae", "--alpha-bias-init", "-0.25"]),
    ("prepare_rgba_vae_init", ["--arch", "qwen", "--alpha-bias-init", "0.5"]),
], ids=["convert-qwen", "convert-flux-subfolder", "prepare"])
def test_port_script_writes_the_jax_scripts_weights(rgb_source, tmp_path, monkeypatch, script, flags):
    args = ["--source", str(rgb_source), *flags]
    _script(f"{script}_torch").main(args + ["--output-dir", str(tmp_path / "torch")])
    monkeypatch.setattr(sys, "argv", [script, *args, "--output-dir", str(tmp_path / "jax")])
    _script(script).main()
    (got_cfg, got), (want_cfg, want) = _weights(tmp_path / "torch"), _weights(tmp_path / "jax")
    assert got_cfg == want_cfg and got_cfg["in_channels"] == got_cfg["out_channels"] == 4
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key], value), key
    np.testing.assert_array_equal(got["encoder.conv_in.weight"][:, 3].numpy(), 0.0)   # alpha input path
    bias = float(dict(zip(flags[::2], flags[1::2])).get("--alpha-bias-init", 0.0))
    assert float(got["decoder.conv_out.bias"][3]) == pytest.approx(bias)


def test_sanity_checks_write_their_grids(rgb_source, tmp_path):
    rng = np.random.default_rng(0)
    image = tmp_path / "in.png"
    Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8), "RGB").save(image)
    rgb_check = _script("rgb_vae_sanity_check_torch")
    grids = []
    for run in range(2):
        out = tmp_path / f"rgb_grid{run}.png"
        rgb_check.main(["--rgb-vae", str(rgb_source), "--vae-subfolder", "vae", "--image", str(image),
                        "--output", str(out), "--seed", "3", "--device", "cpu"])
        grids.append(np.asarray(Image.open(out)))
    assert grids[0].shape == (32, 64, 3)                # input | reconstruction
    np.testing.assert_array_equal(grids[0], grids[1])   # the posterior noise comes from --seed

    # the multilayer dump, then its reconstruction through the converted RGBA VAE
    rendered, json_root = tmp_path / "rendered", tmp_path / "json"
    make_multilayer_tree(rendered, json_root, n=2)
    _script("convert_qwen_vae_to_rgba_torch").main(
        ["--source", str(rgb_source), "--output-dir", str(tmp_path / "rgba")])
    out = tmp_path / "dataset_grid.png"
    _script("dataset_sanity_check_torch").main(
        ["--rendered-root", str(rendered), "--json-root", str(json_root), "--vae-checkpoint",
         str(tmp_path / "rgba"), "--output", str(out), "--device", "cpu"])
    assert np.asarray(Image.open(out)).shape == (32, 64, 3)   # sample_0's one layer: GT | recon
    # and from a multilayer sample instead of an image
    rgb_check.main(["--rgb-vae", str(rgb_source), "--vae-subfolder", "vae", "--rendered-root", str(rendered),
                    "--json-root", str(json_root), "--sample-index", "1", "--overlay-background",
                    "--output", str(tmp_path / "layers.png"), "--device", "cpu"])
    assert np.asarray(Image.open(tmp_path / "layers.png")).shape == (64, 64, 3)   # sample_1's two layers


@pytest.mark.parametrize("script", ["rgb_vae_sanity_check_torch", "dataset_sanity_check_torch"])
def test_sanity_checks_refuse_a_missing_card(rgb_source, monkeypatch, script):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        _script(script).main(["--rgb-vae", str(rgb_source)] if script.startswith("rgb") else [])
