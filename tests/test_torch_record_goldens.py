"""`scripts/record_goldens_torch.py` against `scripts/record_goldens.py`, and
the loader it reads checkpoints through.

- On one tiny synthetic VAE checkpoint and one tiny sharded transformer
  checkpoint, in temp directories: the port's manifests are byte-equal to
  the JAX script's; the port's goldens are within 2e-4 of JAX's for the VAE
  moments (JAX's own tolerance in `tests/test_record_goldens.py`), 2e-3 for
  the decoded images and the transformer's output; JAX's AutoencoderKL
  reproduces the port-written npz and the port's model the JAX-written one.
- `--assert-fixtures` fails on a planted wrong shape and on a bogus key.
- The port's modules on the meta device give exactly the fixture manifests:
  1160 transformer keys (11.90 B parameters) and 244 `ae` keys (83.8 M).
- `load_flux_transformer_params` casting each entry as it is read gives the
  bits the whole-fp32 read and a cast afterwards gave, and a sharded index
  that names a key's shard wrongly, or a key no shard holds, raises naming it.
- A real checkpoint's goldens, once recorded into `tests/fixtures/`, are
  consumed by the port (skipped until then).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_record_goldens.py -q
"""
import json
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragb_vae_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from ragb_vae_tpu.models.vae_config import AutoencoderConfig as JaxAutoencoderConfig
from ragb_vae_tpu.models.weights import save_autoencoder_params as jax_save_autoencoder_params
from ragb_vae_tpu.models.weights import torch_state_to_flax_params
from ragb_vae_tpu_torch.models.flux_kontext_textalpha import init_random_
from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformer2D, FluxTransformerConfig
from ragb_vae_tpu_torch.models.flux_weights import load_flux_transformer_params
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
from tests.torch_vae_ref import make_state

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
sys.path.insert(0, str(REPO / "scripts"))

import record_goldens  # noqa: E402  (the JAX script)
import record_goldens_torch  # noqa: E402
import rehearse_real_geometry_torch as rehearse  # noqa: E402


@pytest.fixture(scope="module")
def vae_ckpt(tmp_path_factory):
    """A tiny RGB VAE checkpoint in diffusers' format, written by the JAX package."""
    root = tmp_path_factory.mktemp("vae")
    config = JaxAutoencoderConfig.tiny()
    jax_save_autoencoder_params(config, torch_state_to_flax_params(make_state(config, seed=3)), root / "ckpt")
    return root / "ckpt"


@pytest.fixture(scope="module")
def transformer_ckpt(tmp_path_factory):
    """A tiny FLUX transformer in bf16, 3 shards + index (the published layout), from a seed."""
    root = tmp_path_factory.mktemp("flux")
    cfg = FluxTransformerConfig.tiny()
    module = FluxTransformer2D(cfg, device="meta").to_empty(device="cpu")
    init_random_(module, torch.Generator().manual_seed(5))
    state = module.state_dict()
    rehearse.write_transformer_config(cfg, root / "transformer")
    rehearse.write_sharded_transformer([(k, tuple(v.shape)) for k, v in state.items()], root / "transformer",
                                       make=lambda k, s: state[k])
    return root


@pytest.fixture(scope="module")
def recorded(vae_ckpt, transformer_ckpt, tmp_path_factory):
    """Each package's script on both checkpoints, each into its own directory."""
    out = {name: tmp_path_factory.mktemp(name) for name in ("jax", "port")}
    for kind, ckpt in (("vae", vae_ckpt), ("transformer", transformer_ckpt)):
        args = ["--checkpoint", str(ckpt), "--kind", kind]
        record_goldens.main(args + ["--output", str(out["jax"])])
        record_goldens_torch.main(args + ["--output", str(out["port"]), "--device", "cpu"])
    return out


@pytest.mark.parametrize("name", ["vae_keys_recorded.txt", "transformer_keys_recorded.txt"])
def test_manifests_are_byte_equal_to_jax(recorded, name):
    assert (recorded["port"] / name).read_bytes() == (recorded["jax"] / name).read_bytes()
    assert len((recorded["port"] / name).read_text().splitlines()) > 100


def test_vae_goldens_agree_with_jax(recorded):
    port, jax_ = np.load(recorded["port"] / "vae_goldens.npz"), np.load(recorded["jax"] / "vae_goldens.npz")
    assert set(port.files) == set(jax_.files)
    np.testing.assert_array_equal(port["probes"], jax_["probes"])
    zc = jax_["moments"].shape[-1] // 2
    np.testing.assert_allclose(port["moments"][..., :zc], jax_["moments"][..., :zc], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(port["moments"][..., zc:], np.clip(jax_["moments"][..., zc:], -30.0, 20.0),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(port["decoded"], jax_["decoded"], rtol=2e-3, atol=2e-3)
    assert "plain route, CPU, fp32" in str(port["source"])


def test_transformer_goldens_agree_with_jax(recorded):
    port = np.load(recorded["port"] / "transformer_goldens.npz")
    jax_ = np.load(recorded["jax"] / "transformer_goldens.npz")
    assert set(port.files) == set(jax_.files)
    for key in ("hidden_states", "encoder_hidden_states", "pooled_projections", "timestep", "img_ids", "guidance"):
        np.testing.assert_array_equal(port[key], jax_[key], err_msg=key)
    np.testing.assert_allclose(port["output"], jax_["output"], rtol=2e-3, atol=2e-3)


def _jax_reproduces(npz: Path, ckpt: Path) -> None:
    """tests/test_record_goldens.py's check: JAX's AutoencoderKL on the checkpoint against the npz."""
    from ragb_vae_tpu.models.weights import load_autoencoder_params

    data = np.load(npz)
    config, params = load_autoencoder_params(ckpt)
    model = JaxAutoencoderKL(config)
    posterior = model.apply({"params": params}, jnp.asarray(data["probes"] * 2.0 - 1.0), method=model.encode)
    zc = data["moments"].shape[-1] // 2
    np.testing.assert_allclose(np.asarray(posterior.mean), data["moments"][..., :zc], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(posterior.logvar), np.clip(data["moments"][..., zc:], -30.0, 20.0),
                               rtol=2e-4, atol=2e-4)
    decoded = model.apply({"params": params}, jnp.asarray(data["moments"][..., :zc]), method=model.decode)
    np.testing.assert_allclose(np.asarray(decoded), data["decoded"], rtol=2e-3, atol=2e-3)


def _port_reproduces(npz: Path, ckpt: Path) -> None:
    data = np.load(npz)
    model = record_goldens_torch.vae_on(ckpt, torch.device("cpu"), torch.float32, fused=False)
    zc = data["moments"].shape[-1] // 2
    moments, decoded = record_goldens_torch.vae_outputs(model, data["probes"] * 2.0 - 1.0,
                                                        z=data["moments"][..., :zc])
    np.testing.assert_allclose(moments[..., :zc], data["moments"][..., :zc], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(moments[..., zc:], np.clip(data["moments"][..., zc:], -30.0, 20.0),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(decoded, data["decoded"], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("consumer, writer", [("jax", "port"), ("port", "jax")])
def test_each_package_reproduces_the_other_s_goldens(recorded, vae_ckpt, consumer, writer):
    check = _jax_reproduces if consumer == "jax" else _port_reproduces
    check(recorded[writer] / "vae_goldens.npz", vae_ckpt)


def _manifest_lines(ckpt: Path):
    from ragb_vae_tpu_torch.models.weights import _locate_weight_file

    shapes = record_goldens_torch.checkpoint_shapes([_locate_weight_file(ckpt)])
    return [f"{k}\t{','.join(str(d) for d in s)}" for k, s in sorted(shapes.items())]


@pytest.mark.parametrize("fault", ["wrong shape", "bogus key", "none"])
def test_assert_fixtures_fails_on_a_planted_difference(vae_ckpt, tmp_path, fault):
    """--assert-fixtures must fail when the manifest in the output directory
    disagrees with the checkpoint, and pass when it agrees."""
    lines = _manifest_lines(vae_ckpt)
    if fault == "wrong shape":
        lines[0] = lines[0].rsplit("\t", 1)[0] + "\t1,2,3"
    elif fault == "bogus key":
        lines.append("not.a.real.key\t7")
    (tmp_path / "flux_ae_keys.txt").write_text("\n".join(lines) + "\n")
    args = ["--checkpoint", str(vae_ckpt), "--kind", "vae", "--output", str(tmp_path), "--assert-fixtures",
            "--device", "cpu"]
    if fault == "none":
        record_goldens_torch.main(args)
        assert (tmp_path / "vae_goldens.npz").exists()
    else:
        with pytest.raises(SystemExit, match="fixture mismatch"):
            record_goldens_torch.main(args)


def test_the_default_device_is_the_card(vae_ckpt, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        record_goldens_torch.main(["--checkpoint", str(vae_ckpt), "--kind", "vae", "--output", str(tmp_path)])
    assert not (tmp_path / "vae_keys_recorded.txt").exists()


@pytest.mark.parametrize("kind, fixture, n_keys, n_params", [
    ("transformer", "flux_transformer_keys.txt", 1160, 11_901_408_320),
    ("vae", "flux_ae_keys.txt", 244, 83_819_683),
])
def test_meta_inventories_equal_the_fixture_manifests(kind, fixture, n_keys, n_params):
    keys = (rehearse.transformer_inventory(rehearse.transformer_config(small=False)) if kind == "transformer"
            else rehearse.vae_inventory(rehearse.vae_config(small=False)))
    want = dict(line.split("\t") for line in (FIXTURES / fixture).read_text().splitlines() if line)
    assert {k: ",".join(str(d) for d in s) for k, s in keys} == want
    assert len(keys) == n_keys and sum(int(np.prod(s)) for _, s in keys) == n_params


# ---------------------------------------------------------------------------
# the loader: cast as read, and the index held to its shards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stored", ["bf16 shards", "fp32 file"])
def test_cast_on_read_is_bit_equal_to_the_whole_fp32_read(transformer_ckpt, tmp_path, stored):
    """What `from_pretrained` now asks for (each entry in its module's dtype
    as it is read) against what it did before this loader cast on read: the
    whole state read in fp32, then each entry cast to its module's dtype."""
    from ragb_vae_tpu_torch.models.flux_weights import save_flux_transformer_params

    root = transformer_ckpt
    if stored == "fp32 file":
        cfg, state = load_flux_transformer_params(transformer_ckpt)
        noise = torch.Generator().manual_seed(1)
        save_flux_transformer_params(cfg, {k: v + 1e-3 * torch.randn(v.shape, generator=noise)
                                           for k, v in state.items()}, tmp_path / "transformer")
        root = tmp_path
    module = FluxTransformer2D(FluxTransformerConfig.tiny(), device="meta", dtype=torch.bfloat16)
    want = {k: p.dtype for k, p in module.state_dict().items()}
    assert torch.float32 in want.values() and torch.bfloat16 in want.values()    # the AdaLN modulation stays fp32
    _, whole = load_flux_transformer_params(root)
    before = {k: v.to(want[k]) for k, v in whole.items()}
    _, now = load_flux_transformer_params(root, dtype=want)
    assert now.keys() == before.keys()
    for key in before:
        assert now[key].dtype == before[key].dtype == want[key], key
        assert torch.equal(now[key], before[key]), key
    _, stored_state = load_flux_transformer_params(root, dtype=None)
    assert {v.dtype for v in stored_state.values()} == ({torch.bfloat16} if stored == "bf16 shards"
                                                        else {torch.float32})


def test_from_pretrained_loads_what_it_loaded_before(transformer_ckpt, tmp_path):
    """The model `from_pretrained` builds holds the bits the fp32 read and a cast afterwards gave."""
    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel
    from ragb_vae_tpu_torch.models.weights import save_autoencoder_params

    root = tmp_path / "flux"
    shutil.copytree(transformer_ckpt / "transformer", root / "transformer")
    cfg = FluxTransformerConfig.tiny()
    rehearse.write_model_dir(root, *rehearse.random_prompt(cfg, seed=0, prompt_len=4))
    v_cfg = AutoencoderConfig.tiny()
    v_cfg.in_channels = v_cfg.out_channels = 4
    from ragb_vae_tpu_torch.models.vae import AutoencoderKL

    save_autoencoder_params(v_cfg, AutoencoderKL(v_cfg).state_dict(), tmp_path / "vae" / "ae")
    model = FluxTextAlphaModel.from_pretrained(root, vae_path=tmp_path / "vae", dtype=torch.bfloat16, device="cpu")
    got = model.transformer.state_dict()
    _, whole = load_flux_transformer_params(root)
    assert got.keys() == whole.keys()
    for key, value in whole.items():
        assert torch.equal(got[key], value.to(got[key].dtype)), key


def _misindexed(src: Path, dst: Path, edit) -> Path:
    shutil.copytree(src / "transformer", dst / "transformer")
    index = dst / "transformer" / "diffusion_pytorch_model.safetensors.index.json"
    data = json.loads(index.read_text())
    edit(data["weight_map"])
    index.write_text(json.dumps(data))
    return dst


def test_an_index_naming_the_wrong_shard_raises_naming_the_key(transformer_ckpt, tmp_path):
    key = "transformer_blocks.0.attn.to_k.weight"

    def move(weight_map):
        weight_map[key] = next(s for s in sorted(set(weight_map.values())) if s != weight_map[key])

    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        load_flux_transformer_params(_misindexed(transformer_ckpt, tmp_path, move))


def test_an_index_naming_a_key_no_shard_holds_raises_naming_it(transformer_ckpt, tmp_path):
    def add(weight_map):
        weight_map["transformer_blocks.9.attn.to_q.weight"] = next(iter(weight_map.values()))

    with pytest.raises(ValueError, match=r"transformer_blocks\.9\.attn\.to_q\.weight"):
        load_flux_transformer_params(_misindexed(transformer_ckpt, tmp_path, add))


# ---------------------------------------------------------------------------
# real goldens, once recorded from a published checkpoint
# ---------------------------------------------------------------------------
@pytest.mark.skipif(not (FIXTURES / "vae_goldens.npz").exists(),
                    reason="real-checkpoint vae goldens not recorded (needs published weights)")
def test_real_vae_goldens():
    """Runs once scripts/record_goldens(_torch).py has been pointed at a
    published checkpoint and its npz checked in."""
    data = np.load(FIXTURES / "vae_goldens.npz")
    model = record_goldens_torch.vae_on(Path(str(data["checkpoint"])), torch.device("cpu"), torch.float32,
                                        fused=False)
    moments, _ = record_goldens_torch.vae_outputs(model, data["probes"] * 2.0 - 1.0)
    zc = data["moments"].shape[-1] // 2
    np.testing.assert_allclose(moments[..., :zc], data["moments"][..., :zc], rtol=2e-2, atol=2e-2)
