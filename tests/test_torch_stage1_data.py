"""The stage-1 loop's modules against the JAX package's: config loading,
the random background blend, the bucket manifests, the mixed-bucket,
component and multilayer datasets with their collates, VAE tiling, and the
checkpoint directory in both directions.

Index orders, keys and shapes are exact and so is the blend (one numpy
stream, the same inputs); decoded pixels agree to 1e-6 relative (the two
packages scale the bytes to [0, 1] by another route). Tiling runs both VAEs
in fp32 on one set of weights: the blends and crops are exact, the convs sum
in another order (1e-5 on moments and pixels of the tiny VAE).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragb_vae_tpu import config as jconfig
from ragb_vae_tpu.data import component_dataset as jcomp
from ragb_vae_tpu.data import loader as jloader
from ragb_vae_tpu.data import manifest as jmanifest
from ragb_vae_tpu.data import multilayer_dataset as jmulti
from ragb_vae_tpu.data.bucket_dataset import MixedBucketDataset as JaxMixed
from ragb_vae_tpu.data.transforms import RandomBackgroundBlend as JaxBlend
from ragb_vae_tpu.models import vae_tiling as jtiling
from ragb_vae_tpu.models.rgba_vae import RgbaVAE as JaxRgbaVAE
from ragb_vae_tpu.models.vae_config import AutoencoderConfig as JaxAutoencoderConfig
from ragb_vae_tpu.training import checkpoint as jckpt
from ragb_vae_tpu.training import rgba_vae_stage as jstage
from ragb_vae_tpu_torch import config as tconfig
from ragb_vae_tpu_torch.data import component_dataset as tcomp
from ragb_vae_tpu_torch.data import loader as tloader
from ragb_vae_tpu_torch.data import manifest as tmanifest
from ragb_vae_tpu_torch.data import multilayer_dataset as tmulti
from ragb_vae_tpu_torch.data.bucket_dataset import MixedBucketDataset
from ragb_vae_tpu_torch.data.transforms import RandomBackgroundBlend
from ragb_vae_tpu_torch.models import vae_tiling as ttiling
from ragb_vae_tpu_torch.models import weights as tw
from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
from ragb_vae_tpu_torch.training import checkpoint as tckpt
from ragb_vae_tpu_torch.training import rgba_vae_stage as tstage
from tests.data_fixtures import (
    _write_png,
    make_components_tree,
    make_laion_tree,
    make_multilayer_tree,
    make_prism_pro_tree,
    make_prism_real_tree,
)

PIXEL_RTOL = 1e-6
TILE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: tiny tensors gain
    nothing from intra-op threads, and the workers stop fighting for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _same_arrays(got, want, rtol=PIXEL_RTOL):
    assert sorted(got) == sorted(want)
    for key in want:
        if isinstance(want[key], np.ndarray):
            assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype, key
            np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=rtol, err_msg=key)
        else:
            assert got[key] == want[key], key


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
def test_load_config_expands_env_as_jax_does(tmp_path, monkeypatch):
    monkeypatch.setenv("RAGB_TEST_ROOT", "/data/x")
    path = tmp_path / "c.yaml"
    path.write_text("model:\n  rgb_checkpoint: ${env:RAGB_TEST_ROOT}/vae\n"
                    "data:\n  roots: [a, '${env:RAGB_TEST_ROOT}']\n  batch_size: 4\n")
    got = tconfig.load_config(path)
    assert got == jconfig.load_config(path)
    assert got["model"]["rgb_checkpoint"] == "/data/x/vae" and got["data"]["roots"][1] == "/data/x"
    monkeypatch.delenv("RAGB_TEST_ROOT")
    with pytest.raises(ValueError, match="RAGB_TEST_ROOT"):
        tconfig.load_config(path)
    (tmp_path / "list.yaml").write_text("- 1\n")
    with pytest.raises(ValueError, match="mapping"):
        tconfig.load_config(tmp_path / "list.yaml")


@pytest.mark.parametrize("name", [None, "float32", "fp32", "bfloat16", "bf16", "float16", "fp16"])
def test_dtype_from_str_maps_as_jax_does(name):
    assert str(tconfig.dtype_from_str(name)).replace("torch.", "") == jnp.dtype(jconfig.dtype_from_str(name)).name


def test_dtype_from_str_refuses_unknown_names():
    with pytest.raises(ValueError):
        tconfig.dtype_from_str("int3")


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("prob,keys,seed", [(0.5, ("composite",), 0), (1.0, ("component", "composite"), 3),
                                            (0.0, ("component",), 7)])
def test_random_background_blend_is_bit_equal(prob, keys, seed):
    rng = np.random.default_rng(11)
    port, jax_blend = RandomBackgroundBlend(prob, keys, (0.3, 0.9), seed), JaxBlend(prob, keys, (0.3, 0.9), seed)
    for _ in range(6):
        sample = {"component": rng.uniform(size=(5, 7, 4)).astype(np.float32),
                  "composite": rng.uniform(size=(5, 7, 4)).astype(np.float32), "name": "s"}
        got, want = port(dict(sample)), jax_blend(dict(sample))
        assert got.keys() == want.keys() and got["background_augmented"] == want["background_augmented"]
        for key in ("component", "composite"):
            np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(ValueError):
        RandomBackgroundBlend(color_range=(0.9, 0.2))


# ---------------------------------------------------------------------------
# manifests and datasets
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    return {
        "components": make_components_tree(root / "components", n_train=4, n_val=2),
        "prism_real": make_prism_real_tree(root / "prism_real", n=2),
        "prism_pro": make_prism_pro_tree(root / "prism_pro", n=2),
        "laion_rgb": make_laion_tree(root / "laion", n=3),
    }


DATASET_CFGS = {
    "components": lambda t: {"type": "components", "root": str(t["components"])},
    "prism_real": lambda t: {"type": "prism_real", "root": str(t["prism_real"]), "split": "train",
                             "splits": ["train"]},
    "prism_pro": lambda t: {"type": "prism_pro", "root": str(t["prism_pro"]), "split": "train",
                            "respect_manifest_split": False, "use_fg_non_overlap": True, "use_rep": False},
    "laion_rgb": lambda t: {"type": "laion_rgb", "root": str(t["laion_rgb"]), "split": "train", "max_count": 2},
}


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("kind", list(DATASET_CFGS) + ["all"])
def test_build_bucket_entries_match_jax(trees, kind, split):
    cfgs = [make(trees) for make in DATASET_CFGS.values()] if kind == "all" else [DATASET_CFGS[kind](trees)]
    got = tmanifest.build_bucket_entries(cfgs, split=split)
    assert got == jmanifest.build_bucket_entries(cfgs, split=split)
    assert got or split == "val"


def test_unknown_dataset_type_raises(trees):
    cfg = [{"type": "parquet", "root": str(trees["components"])}]
    with pytest.raises(ValueError, match="Unknown dataset type"):
        tmanifest.build_bucket_entries(cfg, split="train")


def test_mixed_bucket_dataset_matches_jax(trees):
    cfgs = [make(trees) for make in DATASET_CFGS.values()]
    entries = tmanifest.build_bucket_entries(cfgs, split="train")
    port = MixedBucketDataset(trees["components"], entries, include_metadata=True)
    want = JaxMixed(trees["components"], entries, include_metadata=True)
    assert port.bucket_to_indices == want.bucket_to_indices and len(port) == len(want)
    for i in range(len(port)):
        _same_arrays(port[i], want[i])


def test_component_dataset_and_pad_collate_loader_match_jax(trees):
    root = trees["components"]
    port_ds = tcomp.RgbaComponentDataset(root, split="train", blend_component_to_white=True)
    jax_ds = jcomp.RgbaComponentDataset(root, split="train", blend_component_to_white=True)
    assert len(port_ds) == len(jax_ds) == 4
    for i in range(len(port_ds)):
        _same_arrays(port_ds[i], jax_ds[i])
    # buckets of two sizes in one batch: pad_collate zero-pads to the largest
    kw = dict(split="train", batch_size=3, shuffle=True, seed=5, dataset_kwargs={"include_metadata": False})
    port_batches = list(tcomp.create_component_dataloader(root, **kw))
    jax_batches = list(jcomp.create_component_dataloader(root, **kw))
    assert len(port_batches) == len(jax_batches) == 2
    for got, want in zip(port_batches, jax_batches):
        _same_arrays(got, want)


def test_pad_collate_matches_jax():
    rng = np.random.default_rng(2)
    items = [{"a": rng.uniform(size=(h, w, 4)).astype(np.float32), "name": f"s{h}"}
             for h, w in ((3, 5), (4, 2), (2, 2))]
    _same_arrays(tloader.pad_collate(items), jloader.pad_collate(items), rtol=0)


def test_multilayer_dataset_and_collate_match_jax(tmp_path):
    rendered, json_root = tmp_path / "rendered", tmp_path / "json"
    make_multilayer_tree(rendered, json_root, n=3)
    _write_png(rendered / "sample_1" / "component_thumbnail.png", 32, 32, seed=9)
    port = tmulti.MultiLayerDataset(rendered, json_root, alpha_threshold=90)
    want = jmulti.MultiLayerDataset(rendered, json_root, alpha_threshold=90)
    assert port.sample_dirs == want.sample_dirs
    samples_t, samples_j = [port[i] for i in range(len(port))], [want[i] for i in range(len(want))]
    for a, b in zip(samples_t, samples_j):
        assert len(a.components) == len(b.components) and a.layout == b.layout
        _same_arrays({"bg": a.background, "comp": a.composite}, {"bg": b.background, "comp": b.composite})
        for x, y, vx, vy in zip(a.components, b.components, a.visible_masks, b.visible_masks):
            np.testing.assert_allclose(x, y, rtol=PIXEL_RTOL)
            np.testing.assert_array_equal(vx, vy)
    _same_arrays(tmulti.multilayer_collate(samples_t), jmulti.multilayer_collate(samples_j))


def test_build_dataloader_matches_jax_on_mixed_buckets(trees):
    """The stage's train loader over two schemas, shuffled and interleaved,
    with the random background blend: the same batches in the same order."""
    cfg = {"data": {"source": "bucket", "bucket_root": str(trees["components"]), "batch_size": 2,
                    "num_workers": 0, "interleave_buckets": True, "seed": 4, "background_blend_prob": 0.5,
                    "background_blend_targets": ["composite"],
                    "bucket_datasets": [DATASET_CFGS["components"](trees), DATASET_CFGS["prism_real"](trees)]}}
    port, want = tstage.build_dataloader(cfg, split="train"), jstage.build_dataloader(cfg, split="train")
    for epoch in (0, 1):
        port.set_epoch(epoch)
        want.set_epoch(epoch)
        got_b, want_b = list(port), list(want)
        assert len(got_b) == len(want_b) == len(port)
        for got, ref in zip(got_b, want_b):
            _same_arrays(got, ref)


# ---------------------------------------------------------------------------
# tiling
# ---------------------------------------------------------------------------
def test_blends_match_jax():
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((2, 6, 7, 3)).astype(np.float32), rng.standard_normal((2, 5, 4, 3)).astype(np.float32)
    for extent in (0, 3):
        want_v = jax.jit(jtiling.blend_v, static_argnums=2)(a[:, :, :4], b, extent)
        want_h = jax.jit(jtiling.blend_h, static_argnums=2)(a[:, :5], b, extent)
        np.testing.assert_allclose(ttiling.blend_v(torch.from_numpy(a[:, :, :4]), torch.from_numpy(b), extent),
                                   want_v, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ttiling.blend_h(torch.from_numpy(a[:, :5]), torch.from_numpy(b), extent),
                                   want_h, rtol=1e-6, atol=1e-6)
    assert ttiling.needs_tiling(48, 32, 32) and not ttiling.needs_tiling(32, 32, 32)


@pytest.fixture(scope="module")
def vae_pair():
    """The tiny RGBA VAE (seeded torch init) in the port, its weights carried
    to the JAX package's tree, both with 32-pixel tiles."""
    jcfg = JaxAutoencoderConfig.tiny()
    tcfg = AutoencoderConfig.tiny()
    jcfg.in_channels = jcfg.out_channels = tcfg.in_channels = tcfg.out_channels = 4
    torch.manual_seed(3)
    port = RgbaVAE(tcfg)
    params = tw.params_to_flax({k: v.clone() for k, v in port.module.state_dict().items()})
    port.enable_tiling(32)
    jvae = JaxRgbaVAE(config=jcfg)
    jvae.enable_tiling(32)
    return jcfg, tcfg, params, jvae, port


def test_tiled_encode_matches_jax(vae_pair):
    """A 32 x 48 image (larger than the 32-pixel tile): four encoder tiles of
    four shapes, their moments blended. The JAX side runs under jit (one
    compile instead of one per op)."""
    _, _, params, jvae, port = vae_pair
    x = np.random.default_rng(4).uniform(-1, 1, size=(1, 32, 48, 4)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, v: jvae.encode(p, v).params)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port.encode(torch.from_numpy(x)).params
        port.disable_tiling()
        whole = port.encode(torch.from_numpy(x)).params
        port.enable_tiling(32)
    assert got.shape == (1, 16, 24, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=TILE_TOL, atol=TILE_TOL)
    assert not torch.allclose(whole, got, atol=1e-3)   # the tiles changed the answer


@pytest.mark.parametrize("shape", [(1, 16, 24, 3), (2, 20, 13, 2)])
def test_tiled_decode_matches_jax(shape):
    """`tiled_decode` around one 2x-upsampling map computed alike in both
    packages (a channel mix, then nearest 2x): the tiles, blends and crops
    of a latent larger than the 8-pixel latent tile."""
    rng = np.random.default_rng(7)
    z = rng.standard_normal(shape).astype(np.float32)
    mix = rng.standard_normal((shape[-1], 4)).astype(np.float32)
    t_fn = lambda v: (v @ torch.from_numpy(mix)).repeat_interleave(2, 1).repeat_interleave(2, 2)
    j_fn = lambda v: jnp.repeat(jnp.repeat(v @ mix, 2, axis=1), 2, axis=2)
    kw = dict(tile_latent=8, spatial_scale=2, overlap_factor=0.25)
    got = ttiling.tiled_decode(t_fn, torch.from_numpy(z), **kw)
    want = jax.jit(lambda v: jtiling.tiled_decode(j_fn, v, **kw))(jnp.asarray(z))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    kw = dict(tile_sample=8, spatial_scale=2, overlap_factor=0.25)
    want = jax.jit(lambda v: jtiling.tiled_encode_moments(lambda t: t[:, ::2, ::2] * 2.0, v, **kw))(jnp.asarray(z))
    np.testing.assert_allclose(ttiling.tiled_encode_moments(lambda t: t[:, ::2, ::2] * 2.0, torch.from_numpy(z), **kw),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


def test_gradients_flow_through_the_tiles(vae_pair):
    """The tiled decode's gradient (through every tile, blend and crop)
    against a central difference along a random direction, in fp32: the
    difference carries ~1e-4 of rounding noise; a tile or a blend whose
    gradient were cut would move the directional derivative by a tenth of its
    size or more."""
    port = vae_pair[-1]
    rng = np.random.default_rng(5)
    z, v = (torch.from_numpy(rng.standard_normal((1, 16, 24, 4)).astype(np.float32)) for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((1, 32, 48, 4)).astype(np.float32))
    f = lambda t: torch.sum(port.decode(t).double() * g)
    zt = z.clone().requires_grad_(True)
    f(zt).backward()
    assert torch.count_nonzero(zt.grad) == zt.numel()
    h = 1e-2
    with torch.no_grad():
        numeric = (f(z + h * v) - f(z - h * v)) / (2 * h)
    torch.testing.assert_close(torch.sum(zt.grad.double() * v), numeric, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# checkpoints, both ways
# ---------------------------------------------------------------------------
def test_checkpoint_written_by_the_port_reads_in_jax(vae_pair, tmp_path):
    _, tcfg, params, _, port = vae_pair
    target = tckpt.checkpoint_dir(tmp_path / "ckpts", 7)
    opt = torch.optim.AdamW(port.module.parameters())
    tckpt.save_train_checkpoint(target, config=tcfg, state=port.module.state_dict(),
                                optimizer_state=opt.state_dict(), step=7)
    assert target.name == "step_0000007" and tckpt.is_complete_checkpoint(target)
    cfg, loaded, opt_state, meta = jckpt.load_train_checkpoint(target)
    assert meta["step"] == 7 and opt_state is None and cfg.in_channels == 4
    for (path, leaf), (_, ref) in zip(jax.tree_util.tree_leaves_with_path(loaded),
                                      jax.tree_util.tree_leaves_with_path(params)):
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(ref), err_msg=str(path))
    assert jckpt.latest_checkpoint(tmp_path / "ckpts") == target


def test_checkpoint_written_by_jax_reads_in_the_port(vae_pair, tmp_path):
    jcfg, _, params, _, port = vae_pair
    target = jckpt.checkpoint_dir(tmp_path / "ckpts", 5)
    jckpt.save_train_checkpoint(target, config=jcfg, params=params, step=5)
    cfg, state, train_state, meta = tckpt.load_train_checkpoint(target)
    assert meta == {"step": 5} and train_state is None and cfg.in_channels == 4
    want = port.module.state_dict()
    assert state.keys() == want.keys()
    for key, value in want.items():
        torch.testing.assert_close(state[key], value, rtol=0, atol=0)
    # no train state: complete for the JAX package, not for `resume_from: auto` here
    assert not tckpt.is_complete_checkpoint(target) and tckpt.latest_checkpoint(tmp_path / "ckpts") is None


def test_latest_and_prune_follow_the_numeric_step(tmp_path):
    for step, complete in ((2, True), (10, True), (9, True), (11, False)):
        d = tckpt.checkpoint_dir(tmp_path, step)
        d.mkdir()
        if complete:
            (d / tckpt.STATE_FILE).write_bytes(b"")
    assert tckpt.latest_checkpoint(tmp_path).name == "step_0000010"
    assert tckpt.prune_checkpoints(tmp_path, 2) == 2       # the incomplete dir goes first
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_0000009", "step_0000010"]
    assert tckpt.prune_checkpoints(tmp_path, 0) == 0


def test_async_writer_snapshots_at_submit(tmp_path, vae_pair):
    _, tcfg, _, _, port = vae_pair
    state = {k: v.clone() for k, v in port.module.state_dict().items()}
    done = []
    with tckpt.AsyncCheckpointWriter() as writer:
        writer.submit(tmp_path / "a", on_complete=lambda: done.append(1), config=tcfg, state=state, step=3)
        for v in state.values():
            v.add_(1.0)      # the loop moves on; the save holds the values at submit
    _, saved, train_state, _ = tckpt.load_train_checkpoint(tmp_path / "a")
    assert done == [1] and train_state["step"] == 3
    torch.testing.assert_close(saved["encoder.conv_in.weight"], state["encoder.conv_in.weight"] - 1.0)
