"""The port's data path for the LoRA stage against the JAX package's: bucket
keys, the bucket-pure batch sampler (same seed, same index order), the
(gt, text_alpha) dataset, the threaded loader and the prefetch to the device.
Index orders, keys and shapes are exact; decoded pixels agree to one float32
ulp (1e-6 relative: the two packages scale the bytes to [0, 1] by another
route).
"""
import threading

import numpy as np
import pytest
import torch

from ragb_vae_tpu.data import loader as jloader
from ragb_vae_tpu.data.sampler import BucketBatchSampler as JaxSampler
from ragb_vae_tpu.data.text_alpha_dataset import TextAlphaBucketDataset as JaxDataset
from ragb_vae_tpu.ops import buckets as jbuckets
from ragb_vae_tpu_torch.data import buckets as tbuckets
from ragb_vae_tpu_torch.data.loader import DataLoader, cuda_prefetch, default_collate
from ragb_vae_tpu_torch.data.sampler import BucketBatchSampler
from ragb_vae_tpu_torch.data.text_alpha_dataset import TextAlphaBucketDataset
from tests.data_fixtures import _write_png, make_text_alpha_tree

PIXEL_RTOL = 1e-6
BUCKETS = {"w64-h64": list(range(10)), "w128-h64": list(range(10, 17)), "w64-h128": [17]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: tiny tensors gain
    nothing from intra-op threads, and the workers stop fighting for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("key", ["w1024-h768", "w64-h64", "1024x768", "w10-h", "W10-h10"])
def test_bucket_keys_parse_as_in_jax(key):
    assert bool(tbuckets.BUCKET_RE.match(key)) == bool(jbuckets.BUCKET_RE.match(key))
    try:
        want = jbuckets.parse_bucket_dims(key)
    except ValueError:
        with pytest.raises(ValueError, match="Invalid bucket format"):
            tbuckets.parse_bucket_dims(key)
    else:
        assert tbuckets.parse_bucket_dims(key) == want
        assert tbuckets.format_bucket_key(*want) == jbuckets.format_bucket_key(*want) == key


@pytest.mark.parametrize("kw", [
    dict(), dict(interleave=True), dict(drop_last=True), dict(drop_last=True, interleave=True),
    dict(shuffle=False), dict(shuffle=False, interleave=True),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "default")
@pytest.mark.parametrize("seed", [0, 1337])
def test_sampler_order_matches_jax_for_a_seed(kw, seed):
    port = BucketBatchSampler(BUCKETS, batch_size=3, seed=seed, **kw)
    ref = JaxSampler(BUCKETS, batch_size=3, seed=seed, **kw)
    for epoch in (0, 1, 5):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        batches = list(port)
        assert batches == list(ref)
        assert len(batches) == len(port) == len(ref)
        for batch in batches:   # bucket-pure
            assert len({next(k for k, idxs in BUCKETS.items() if i in idxs) for i in batch}) == 1
    port.set_epoch(0)
    first = list(port)
    port.set_epoch(1)
    assert kw.get("shuffle") is False or list(port) != first


def test_sampler_without_a_seed_still_covers_every_index():
    seen = sorted(i for batch in BucketBatchSampler(BUCKETS, batch_size=4) for i in batch)
    assert seen == list(range(18))


@pytest.fixture()
def tree(tmp_path):
    make_text_alpha_tree(tmp_path, n=5)
    # a second bucket, an unpaired gt, and a directory that is no bucket
    for i in range(2):
        _write_png(tmp_path / "train" / "w32-h64" / "gt" / f"t{i}.png", 32, 64, seed=600 + i)
        _write_png(tmp_path / "train" / "w32-h64" / "text_alpha" / f"t{i}.png", 32, 64, seed=650 + i)
    _write_png(tmp_path / "train" / "w32-h64" / "gt" / "alone.png", 32, 64, seed=700)
    _write_png(tmp_path / "train" / "notes" / "gt" / "x.png", 8, 8, seed=701)
    return tmp_path


def test_dataset_matches_jax(tree):
    port, ref = TextAlphaBucketDataset(tree), JaxDataset(tree)
    assert len(port) == len(ref) == 7
    assert port.bucket_to_indices == ref.bucket_to_indices
    for i in range(len(port)):
        a, b = port[i], ref[i]
        assert set(a) == set(b) == {"gt", "text_alpha", "bucket", "bucket_dims", "sample_name"}
        for key in ("gt", "text_alpha"):
            np.testing.assert_allclose(a[key], b[key], rtol=PIXEL_RTOL)
        np.testing.assert_array_equal(a["bucket_dims"], b["bucket_dims"])
        assert (a["bucket"], a["sample_name"]) == (b["bucket"], b["sample_name"])
        w, h = a["bucket_dims"]
        assert a["gt"].shape == (h, w, 4) and a["gt"].dtype == np.float32


def test_dataset_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="Split root not found"):
        TextAlphaBucketDataset(tmp_path, split="train")
    (tmp_path / "train" / "w8-h8" / "gt").mkdir(parents=True)
    with pytest.raises(ValueError, match="No gt/text_alpha pairs"):
        TextAlphaBucketDataset(tmp_path)


def test_default_collate_matches_jax():
    items = [{"a": np.full((2, 3), i, np.float32), "n": i, "s": f"x{i}", "f": 0.5 * i} for i in range(3)]
    got, want = default_collate(items), jloader.default_collate(items)
    assert set(got) == set(want)
    for key in ("a", "n", "f"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["s"] == want["s"] == ["x0", "x1", "x2"] and default_collate([]) == {}


@pytest.mark.parametrize("num_workers,prefetch", [(0, 0), (0, 2), (3, 2)])
def test_loader_batches_match_the_jax_loader(tree, num_workers, prefetch):
    ds = TextAlphaBucketDataset(tree)
    make = lambda cls, sampler: cls(ds, batch_sampler=sampler(ds.bucket_to_indices, batch_size=2, seed=4),
                                    num_workers=num_workers, prefetch_batches=prefetch)
    port, ref = make(DataLoader, BucketBatchSampler), make(jloader.DataLoader, JaxSampler)
    assert len(port) == len(ref) == 4
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        batches = list(port)
        assert len(batches) == 4
        for a, b in zip(batches, ref):
            np.testing.assert_allclose(a["gt"], b["gt"], rtol=PIXEL_RTOL)
            np.testing.assert_allclose(a["text_alpha"], b["text_alpha"], rtol=PIXEL_RTOL)
            assert a["sample_name"] == b["sample_name"] and a["bucket"] == b["bucket"]


def test_loader_with_a_batch_size_and_its_errors(tree):
    ds = TextAlphaBucketDataset(tree)
    one_bucket = [ds[i] for i in ds.bucket_to_indices["w64-h64"]]
    loader = DataLoader(one_bucket, batch_size=2, shuffle=True, seed=1, drop_last=True)
    assert len(loader) == 2 and [b["gt"].shape[0] for b in loader] == [2, 2]
    assert len(DataLoader(one_bucket, batch_size=2)) == 3
    with pytest.raises(ValueError, match="exactly one"):
        DataLoader(ds)
    # process_shard: each of two processes fetches its half of every batch
    halves = [list(DataLoader(one_bucket, batch_size=2, shuffle=True, seed=1, drop_last=True,
                              process_shard=(r, 2))) for r in range(2)]
    for whole, first, second in zip(loader, *halves):
        assert first["global_batch_size"] == second["global_batch_size"] == 2
        np.testing.assert_array_equal(np.concatenate([first["gt"], second["gt"]]), whole["gt"])
    with pytest.raises(ValueError, match="not divisible"):
        list(DataLoader(one_bucket, batch_size=3, process_shard=(0, 2)))


def test_loader_passes_on_a_worker_error_and_stops_its_thread_on_an_early_exit(tree):
    ds = TextAlphaBucketDataset(tree)

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 3:
                raise RuntimeError("bad sample")
            return ds[0]

    with pytest.raises(RuntimeError, match="bad sample"):
        list(DataLoader(Broken(), batch_size=1, prefetch_batches=1))
    before = threading.active_count()
    for _ in DataLoader(ds, batch_sampler=BucketBatchSampler(ds.bucket_to_indices, batch_size=1, seed=0),
                        prefetch_batches=1):
        break
    assert threading.active_count() == before


def test_cuda_prefetch_on_the_cpu_hands_tensors_through_in_order(tree):
    ds = TextAlphaBucketDataset(tree)
    loader = DataLoader(ds, batch_sampler=BucketBatchSampler(ds.bucket_to_indices, batch_size=2, seed=4))
    plain = list(loader)
    moved = list(cuda_prefetch(loader, "cpu", size=2))
    assert len(moved) == len(plain)
    for a, b in zip(moved, plain):
        assert isinstance(a["gt"], torch.Tensor) and a["gt"].dtype == torch.float32
        np.testing.assert_array_equal(a["gt"].numpy(), b["gt"])
        assert a["sample_name"] == b["sample_name"]
    assert list(cuda_prefetch([], "cpu")) == []
