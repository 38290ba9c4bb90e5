"""The port's offline bucket preparation against the JAX package's, on the
synthetic rendered tree of tests/test_data_generation.py (grown by a
sample-prefixed sample, an undersized one and a wide one): equal manifests
and byte-equal PNGs from `run_prepare` at one and two workers, the bucket
rules over sizes, the PrismLayers and LAION helpers, and the four CLIs'
flags. Also the PNG text-chunk limit of the port's `load_rgba`.
"""
import argparse
import importlib
import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, PngImagePlugin

from ragb_vae_tpu.data_generation import hf_bucketers as jax_hf
from ragb_vae_tpu.data_generation import rgba_buckets as jax_prep
from ragb_vae_tpu.ops import buckets as jax_buckets
from ragb_vae_tpu_torch.data import buckets
from ragb_vae_tpu_torch.data_generation import hf_bucketers, rgba_buckets
from tests.test_data_generation import _layer, _prism_sample

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def rendered_tree(tmp_path_factory):
    """tests/test_data_generation.py's two samples, a sample-prefixed one with
    three overlapping coloured layers, an undersized one and a 2:1 one."""
    root = tmp_path_factory.mktemp("rendered")
    size = (448, 448)
    for name, n_layers in (("sample_a", 2), ("sample_b", 1)):
        d = root / name
        d.mkdir(parents=True)
        Image.new("RGBA", size, (10, 20, 30, 255)).save(d / "background.png")
        for j in range(n_layers):
            _layer(size, (j * 100, j * 100, j * 100 + 150, j * 100 + 150)).save(d / f"component_{j}.png")
    d = root / "sample_c"
    d.mkdir()
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (400, 520, 4), dtype=np.uint8)).save(d / "sample_c_background.png")
    for j, (box, colour) in enumerate((((0, 0, 260, 200), (255, 0, 0, 200)), ((200, 150, 500, 390), (0, 255, 0, 255)),
                                       ((40, 300, 120, 380), (0, 0, 255, 128)), ((300, 0, 380, 90), (9, 9, 9, 255)))):
        _layer((520, 400), box, colour).save(d / f"sample_c_component_{j}.png")
    for name, size in (("sample_small", (300, 500)), ("sample_wide", (900, 450))):
        d = root / name
        d.mkdir()
        Image.new("RGBA", size, (1, 2, 3, 255)).save(d / "background.png")
        _layer(size, (10, 10, 200, 200)).save(d / "component_0.png")
    return root


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*.png"))}


def _key(entry: dict):
    return entry["source_sample"], entry["component_index"]


@pytest.mark.parametrize("num_workers", [1, 2])
def test_run_prepare_matches_jax(rendered_tree, tmp_path, num_workers):
    val_list = tmp_path / "val.txt"
    val_list.write_text("sample_b\nsample_c\n")
    kw = dict(validation_list=val_list, seed=3, num_workers=num_workers, fg_erosion_iterations=2)
    got = rgba_buckets.run_prepare(rendered_tree, tmp_path / "port", **kw)
    want = jax_prep.run_prepare(rendered_tree, tmp_path / "jax", **kw)
    assert got and {e["source_sample"] for e in got} == {"sample_a", "sample_b", "sample_c", "sample_wide"}
    assert sorted(got, key=_key) == sorted(want, key=_key)
    manifests = [json.loads((tmp_path / d / "metadata" / "manifest.json").read_text()) for d in ("port", "jax")]
    assert sorted(manifests[0], key=_key) == sorted(manifests[1], key=_key)
    if num_workers == 1:
        assert manifests[0] == manifests[1]          # one worker: the same order too
    port_files, jax_files = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert port_files.keys() == jax_files.keys() and len(port_files) > 8
    assert all(port_files[k] == jax_files[k] for k in port_files)
    # a rerun finds every sample written
    assert rgba_buckets.run_prepare(rendered_tree, tmp_path / "port", **kw) == []


@pytest.mark.parametrize("counts", [(1, 0), (0, 1), (2, None)])
def test_run_prepare_caps_match_jax(rendered_tree, tmp_path, counts):
    kw = dict(train_count=counts[0], val_count=counts[1], seed=1, fg_max_groups=1,
              validation_list=None, max_samples=4)
    (tmp_path / "val.txt").write_text("sample_b\n")
    kw["validation_list"] = tmp_path / "val.txt"
    assert rgba_buckets.run_prepare(rendered_tree, tmp_path / "port", **kw) == \
        jax_prep.run_prepare(rendered_tree, tmp_path / "jax", **kw)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


SIZES = [(448, 448), (383, 1000), (1000, 383), (384, 883), (384, 884), (4000, 3000), (1408, 768), (1920, 1080),
         (512, 1177), (3000, 3000), (64, 64), (0, 5), (-1, 10), (700, 1609), (1409, 769), (2048, 1024)]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_bucket_rules_match_jax(size):
    w, h = size
    assert buckets.bucket_assignment(size) == jax_buckets.bucket_assignment(size)
    if w > 0 and h > 0:
        assert buckets.should_exclude_size(w, h) == jax_buckets.should_exclude_size(w, h)
        assert buckets.bucket_for_size(w, h) == jax_buckets.bucket_for_size(w, h)
        assert buckets.round_to_multiple(w / 3) == jax_buckets.round_to_multiple(w / 3)
    assert hf_bucketers.laion_bucket_assignment(size) == jax_hf.laion_bucket_assignment(size)
    assert hf_bucketers.laion_bucket_assignment(size, min_side=384) == \
        jax_hf.laion_bucket_assignment(size, min_side=384)


def test_bucket_constants_match_jax():
    names = ("MAX_SIDE", "MAX_PIXELS", "MULTIPLE", "MIN_BUCKET_SIDE", "FILTER_MIN_SIDE", "FILTER_MAX_AR",
             "BACKGROUND_VISIBILITY_THRESHOLD")
    assert [getattr(buckets, n) for n in names] == [getattr(jax_buckets, n) for n in names]
    assert (hf_bucketers.LAION_MIN_SIDE, hf_bucketers.LAION_MAX_AR) == (jax_hf.LAION_MIN_SIDE, jax_hf.LAION_MAX_AR)


@pytest.mark.parametrize("n_layers,size", [(2, (448, 448)), (3, (640, 480)), (0, (448, 448)), (2, (200, 448))])
def test_prism_samples_match_jax(tmp_path, n_layers, size):
    sample = _prism_sample(size=size, n_layers=n_layers)
    got = hf_bucketers.process_prism_real_sample(sample, 0, tmp_path / "port", split="val")
    want = jax_hf.process_prism_real_sample(sample, 0, tmp_path / "jax", split="val")
    assert got == want
    got = hf_bucketers.process_prism_pro_sample(sample, 1, tmp_path / "port", "other", np.random.default_rng(5))
    want = jax_hf.process_prism_pro_sample(sample, 1, tmp_path / "jax", "other", np.random.default_rng(5))
    assert got == want
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


@pytest.mark.parametrize("total,world,rank", [(10, 3, 0), (10, 3, 2), (7, 1, 0), (0, 2, 1), (5, 8, 6)])
def test_shard_indices_match_jax(total, world, rank):
    assert hf_bucketers.shard_indices(total, world, rank) == jax_hf.shard_indices(total, world, rank)


@pytest.mark.parametrize("bad", [(10, 3, 3), (10, 0, 0), (10, 2, -1)])
def test_shard_indices_reject_what_jax_rejects(bad):
    for fn in (hf_bucketers.shard_indices, jax_hf.shard_indices):
        with pytest.raises(ValueError):
            fn(*bad)


@pytest.mark.parametrize("url", ["http://x/y.png", "https://example.org/a b?c=1", "ü"])
def test_safe_image_id_matches_jax(url):
    assert hf_bucketers.safe_image_id(url) == jax_hf.safe_image_id(url)


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _flags(module_name: str) -> list:
    """Each action of the script's parser (its flags, dest, default, type,
    requiredness, help), caught as `main` parses."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        module = importlib.import_module(module_name)
    finally:
        sys.path.remove(str(REPO / "scripts"))

    def parse_args(self, *args, **kwargs):
        raise _Parsed(self)

    saved = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = parse_args
    try:
        module.main()
    except _Parsed as caught:
        return [(a.option_strings, a.dest, a.default, a.type, a.required, a.help) for a in caught.parser._actions]
    finally:
        argparse.ArgumentParser.parse_args = saved
    raise AssertionError(f"{module_name}.main parsed no arguments")


@pytest.mark.parametrize("name", ["prepare_rgba_buckets", "prism_layer_real_bucketer", "prism_layer_pro_bucketer",
                                  "laion_bucket_downloader"])
def test_cli_flags_match_jax(name):
    assert _flags(f"{name}_torch") == _flags(name)


def test_export_empty_prompt_cli_adds_only_device():
    port, jax = _flags("export_empty_prompt_torch"), _flags("export_empty_prompt")
    assert port[: len(jax)] == jax
    assert [(a[0], a[2]) for a in port[len(jax):]] == [(["--device"], "cuda")]


def test_prepare_cli_runs_in_process(rendered_tree, tmp_path, capsys):
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        cli = importlib.import_module("prepare_rgba_buckets_torch")
    finally:
        sys.path.remove(str(REPO / "scripts"))
    cli.main(["--rendered-root", str(rendered_tree), "--output-root", str(tmp_path), "--seed", "3",
              "--max-samples", "2"])
    manifest = json.loads((tmp_path / "metadata" / "manifest.json").read_text())
    assert f"Wrote manifest with {len(manifest)} entries" in capsys.readouterr().out
    assert manifest == jax_prep.run_prepare(rendered_tree, tmp_path / "jax", seed=3, max_samples=2)


# ---------------------------------------------------------------------------
# PNG text chunks past PIL's default limit
# ---------------------------------------------------------------------------
def _png_with_text(path: Path, nbytes: int) -> None:
    info = PngImagePlugin.PngInfo()
    info.add_text("profile", "x" * nbytes, zip=True)           # a zTXt chunk
    Image.fromarray(np.arange(256, dtype=np.uint8).reshape(8, 8, 4)).save(path, pnginfo=info)
    assert len(zlib.compress(b"x" * nbytes)) < path.stat().st_size


@pytest.mark.parametrize("env,loads", [(None, True), ("0", False)], ids=["default", "limit_from_env"])
def test_load_rgba_reads_a_2mib_text_chunk_through_pil(tmp_path, env, loads):
    """In a fresh interpreter that imports only the port (an import of the
    JAX package's image_io sets PIL's global for the whole process), with
    the native codec off: a 2 MiB zTXt chunk loads. PNG_MAX_TEXT_CHUNK only
    raises the limit; 0 leaves PIL's own 1 MiB, which refuses it."""
    path = tmp_path / "text.png"
    _png_with_text(path, 2 * 1024 * 1024)
    code = (
        "import sys\n"
        "from ragb_vae_tpu_torch.data.image_io import load_rgba\n"
        f"arr = load_rgba({str(path)!r})\n"
        "assert arr.shape == (8, 8, 4), arr.shape\n"
        "assert 'ragb_vae_tpu' not in sys.modules\n"
        "print(int(round(float(arr[1, 0, 2]) * 255)))\n"
    )
    env_vars = {k: v for k, v in os.environ.items() if k != "PNG_MAX_TEXT_CHUNK"}
    env_vars["RAGB_NO_NATIVE_IO"] = "1"
    if env is not None:
        env_vars["PNG_MAX_TEXT_CHUNK"] = env
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env_vars, capture_output=True, text=True,
                         timeout=120)
    if loads:
        assert out.returncode == 0 and out.stdout.strip() == "34", out.stderr[-2000:]
    else:
        assert out.returncode != 0 and "MAX_TEXT_CHUNK" in out.stderr, out.stderr[-2000:]
