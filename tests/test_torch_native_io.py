"""The port's native PNG codec (`data/native_io.py` over `csrc/rgba_io.cpp`)
against the JAX package's (`ragb_vae_tpu/data/native_io.py`) and the PIL
path, as `tests/test_native_io.py` holds the JAX one.

- Decode of RGBA, RGB, grey, grey + alpha, palette (with a transparent
  entry) and 16-bit RGBA PNGs equals JAX's native decode bit for bit. It
  equals the PIL path's 8-bit pixels exactly; the floats differ from PIL's
  by at most one ulp where they differ (the codec multiplies by 1/255, the
  PIL path divides by 255, as in the JAX package).
- `encode_png` writes the bytes JAX's `encode_png` writes; batches equal
  their images one by one; failures name the path.
- The library builds from the checkout here (g++ and libpng's headers
  present), so the PIL fallback cannot hide a broken build, and it lands
  under `build/host/`, never in the JAX package.
"""
import shutil
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from ragb_vae_tpu.data import native_io as jax_native_io
from ragb_vae_tpu_torch.data import image_io, native_io
from ragb_vae_tpu_torch.data.bucket_dataset import MixedBucketDataset
from ragb_vae_tpu_torch.ops.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
ULP = 6e-8   # one float32 ulp below 1.0


def _png_rgba16(path: Path, arr: np.ndarray) -> None:
    """A 16-bit RGBA PNG written by hand (PIL writes no 16-bit colour)."""
    h, w, _ = arr.shape

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    rows = b"".join(b"\x00" + arr[y].astype(">u2").tobytes() for y in range(h))
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 6, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    paths = {}
    for mode, (w, h), ch in (("RGBA", (32, 48), 4), ("RGB", (64, 32), 3), ("L", (16, 16), 1), ("LA", (24, 8), 2)):
        arr = rng.integers(0, 256, (h, w, ch), dtype=np.uint8)
        paths[mode] = root / f"{mode}.png"
        Image.fromarray(arr.squeeze(-1) if ch == 1 else arr, mode).save(paths[mode])
    palette = Image.fromarray(rng.integers(0, 16, (20, 12), dtype=np.uint8), "P")
    palette.putpalette(rng.integers(0, 256, 48, dtype=np.uint8).tolist())
    paths["P"] = root / "P.png"
    palette.save(paths["P"], transparency=3)
    paths["RGBA16"] = root / "RGBA16.png"
    _png_rgba16(paths["RGBA16"], rng.integers(0, 65536, (10, 14, 4), dtype=np.uint16))
    return paths


MODES = ["RGBA", "RGB", "L", "LA", "P", "RGBA16"]


def test_the_library_builds_here_under_build():
    if not (shutil.which("g++") and Path("/usr/include/png.h").exists()):
        pytest.skip("no g++ or libpng headers: the PIL path serves")
    assert native_io.available(), native_io.load_error
    built = _build.rgba_io_path()
    assert built.exists() and built.parent == ROOT / "build" / "host"
    assert not built.is_relative_to(ROOT / "ragb_vae_tpu")


@pytest.mark.parametrize("mode", MODES)
def test_decode_equals_jax_native_and_the_pil_path(pngs, mode):
    path = pngs[mode]
    got = native_io.decode_png(path)
    np.testing.assert_array_equal(got, jax_native_io.decode_png(path))
    with Image.open(path) as img:
        pil = image_io.pil_to_array(img.convert("RGBA"))
    assert got.shape == pil.shape
    np.testing.assert_array_equal(np.rint(got * 255).astype(np.uint8), np.rint(pil * 255).astype(np.uint8))
    np.testing.assert_allclose(got, pil, rtol=0, atol=ULP)
    np.testing.assert_array_equal(image_io.load_rgba(path), got)   # load_rgba takes the native path
    assert native_io.png_size(path) == jax_native_io.png_size(path) == pil.shape[1::-1]


def test_padding_batches_and_errors_name_the_path(pngs, tmp_path):
    paths = [pngs[m] for m in MODES]
    batch = native_io.decode_batch(paths, 64, 64, num_threads=3)
    np.testing.assert_array_equal(batch, jax_native_io.decode_batch(paths, 64, 64, num_threads=3))
    for i, path in enumerate(paths):
        np.testing.assert_array_equal(batch[i], native_io.decode_png(path, max_h=64, max_w=64))
        h, w = native_io.png_size(path)[::-1]
        assert not batch[i, h:].any() and not batch[i, :, w:].any()
    missing = tmp_path / "missing.png"
    with pytest.raises(IOError, match="missing.png"):
        native_io.decode_batch([paths[0], missing], 64, 64)
    with pytest.raises(IOError, match="missing.png"):
        native_io.decode_png(missing, max_h=8, max_w=8)
    with pytest.raises(IOError, match="RGB.png"):
        native_io.decode_png(pngs["RGB"], max_h=8, max_w=8)   # buffer too small


def test_encode_writes_the_bytes_jax_writes(tmp_path):
    rng = np.random.default_rng(1)
    batch = rng.random((3, 20, 12, 4)).astype(np.float32)
    batch[0, 0, 0] = [0.0, 1.0, 0.5, 2.0]   # clip and endpoints
    for level in (1, 6):
        native_io.encode_png(tmp_path / f"port{level}.png", batch[0], compression=level)
        jax_native_io.encode_png(tmp_path / f"jax{level}.png", batch[0], compression=level)
        assert (tmp_path / f"port{level}.png").read_bytes() == (tmp_path / f"jax{level}.png").read_bytes()
    paths = [tmp_path / f"b{i}.png" for i in range(3)]
    native_io.encode_batch(paths, batch, num_threads=2)
    for i, path in enumerate(paths):
        native_io.encode_png(tmp_path / "one.png", batch[i])
        assert path.read_bytes() == (tmp_path / "one.png").read_bytes()
        with Image.open(path) as img:
            np.testing.assert_array_equal(np.asarray(img), (np.clip(batch[i], 0, 1) * 255).astype(np.uint8))
    image_io.save_rgba(batch[1], tmp_path / "saved.png")
    assert (tmp_path / "saved.png").read_bytes() == paths[1].read_bytes()
    with pytest.raises(ValueError, match="paths"):
        native_io.encode_batch(paths[:2], batch)
    with pytest.raises(ValueError, match="expects"):
        native_io.encode_png(paths[0], batch[0, ..., :3])
    with pytest.raises(IOError, match="no_dir"):
        native_io.encode_png(tmp_path / "no_dir" / "x.png", batch[0])


def test_bucket_batches_take_one_native_decode(pngs, tmp_path, monkeypatch):
    same = [tmp_path / f"s{i}.png" for i in range(3)]
    for i, p in enumerate(same):
        Image.fromarray(np.random.default_rng(i).integers(0, 256, (8, 8, 4), dtype=np.uint8), "RGBA").save(p)
    ds = MixedBucketDataset(tmp_path, [{"bucket": "b", "image_path": p.name} for p in same])
    calls = []
    real = native_io.decode_batch
    monkeypatch.setattr(native_io, "decode_batch", lambda *a, **k: calls.append(a) or real(*a, **k))
    items = ds.getitems([0, 1, 2])
    assert len(calls) == 1
    for i, item in enumerate(items):
        np.testing.assert_array_equal(item["composite"], ds[i]["composite"])
    mixed = MixedBucketDataset(tmp_path.parent, [{"bucket": "b", "image_path": str(pngs[m])} for m in MODES[:3]])
    got = mixed.getitems([0, 1, 2], map_fn=map)   # sizes differ: one decode per item
    assert len(calls) == 1 and [g["composite"].shape for g in got] == [mixed[i]["composite"].shape for i in range(3)]


def test_no_native_io_falls_back_to_pil(pngs, monkeypatch):
    monkeypatch.setenv("RAGB_NO_NATIVE_IO", "1")
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_load_attempted", False)
    assert not native_io.available() and "RAGB_NO_NATIVE_IO" in native_io.load_error
    with pytest.raises(RuntimeError, match="not available"):
        native_io.decode_png(pngs["RGBA"])
    with Image.open(pngs["RGBA"]) as img:
        np.testing.assert_array_equal(image_io.load_rgba(pngs["RGBA"]), image_io.pil_to_array(img.convert("RGBA")))
