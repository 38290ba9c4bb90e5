"""Host-side data loader and the copy to the card.

Counterpart of `ragb_vae_tpu/data/loader.py`. `DataLoader` decodes the items
of one batch on a thread pool (PIL releases the GIL while it decodes a PNG,
so threads decode in parallel without forked workers) and keeps a bounded
queue of finished batches ahead of the consumer. `cuda_prefetch` takes the
place of the JAX package's `device_prefetch`: it copies each batch into
pinned host buffers and on to the card on a side stream, one batch ahead, so
the copy runs under the previous step's compute. A dataset with a
`getitems(indices, map_fn=)` fetches a batch itself (the native batch PNG
decode of `MixedBucketDataset`). `process_shard=(index, count)` gives each
process its contiguous slice of every batch of one shared index stream.

Spans (`utils/profiling.py`): `data.fetch` on the loader's thread covers one
batch's items; on the consuming thread `data.next` covers the work of
handing over one batch from `cuda_prefetch`: `data.wait` (the loader's
queue), the caller's own stages (the LoRA stage's `data.pad`), `data.pin`
and `data.copy` (enqueueing the copy). `cuda_prefetch` adds the host time
of each `data.next` to its `Counter` (`data.next`).
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ragb_vae_tpu_torch.utils.profiling import Counter, annotate

Item = Dict[str, Any]


def default_collate(items: List[Item]) -> Item:
    """Stack array-valued keys to (B, ...), numbers to a vector, everything
    else to a list. All items share one key set (a batch is bucket-pure, so
    its arrays share a shape)."""
    if not items:
        return {}
    out: Item = {}
    for key, first in items[0].items():
        values = [item[key] for item in items]
        if isinstance(first, np.ndarray):
            out[key] = np.stack(values, axis=0)
        elif isinstance(first, (int, float, bool, np.number)):
            out[key] = np.asarray(values)
        else:
            out[key] = values
    return out


def pad_collate(items: List[Item]) -> Item:
    """Zero-pad every array key at the bottom and right to the batch's largest
    (H, W), then stack; other keys are dropped."""
    out: Item = {}
    for key, first in items[0].items():
        if not isinstance(first, np.ndarray):
            continue
        max_h = max(item[key].shape[0] for item in items)
        max_w = max(item[key].shape[1] for item in items)
        out[key] = np.stack([
            np.pad(item[key], ((0, max_h - item[key].shape[0]), (0, max_w - item[key].shape[1]), (0, 0)))
            for item in items
        ], axis=0)
    return out


class DataLoader:
    """Map-style dataset -> iterator of collated numpy batches.

    Give either `batch_sampler` (an iterable of index lists, re-iterated each
    epoch) or `batch_size` (with `shuffle` / `drop_last` over
    range(len(dataset))).

    `process_shard=(index, count)`: every process walks the same seeded
    global index stream (so all agree on batch boundaries and buckets) and
    fetches only its contiguous `1/count` of each batch, which then carries
    `global_batch_size`. A global batch that `count` does not divide raises
    (sharded train loaders force drop_last)."""

    def __init__(
        self,
        dataset,
        *,
        batch_sampler: Optional[Iterable[Sequence[int]]] = None,
        batch_size: Optional[int] = None,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 0,
        collate_fn: Optional[Callable[[List[Item]], Item]] = None,
        prefetch_batches: int = 2,
        seed: Optional[int] = None,
        process_shard: Optional[Sequence[int]] = None,
    ) -> None:
        if (batch_sampler is None) == (batch_size is None):
            raise ValueError("Provide exactly one of batch_sampler or batch_size.")
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(0, int(num_workers))
        self.collate_fn = collate_fn or default_collate
        self.prefetch_batches = max(0, int(prefetch_batches))
        self.seed = seed
        self.process_shard = None
        if process_shard is not None:
            index, count = int(process_shard[0]), int(process_shard[1])
            if not (count >= 1 and 0 <= index < count):
                raise ValueError(f"invalid process_shard {process_shard!r}")
            self.process_shard = (index, count) if count > 1 else None
        self._epoch = 0
        self._pool = ThreadPoolExecutor(max_workers=self.num_workers) if self.num_workers else None

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)

    def __len__(self) -> int:
        if self.batch_sampler is not None:
            return len(self.batch_sampler)  # type: ignore[arg-type]
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self) -> Iterator[List[int]]:
        if self.batch_sampler is not None:
            for batch in self.batch_sampler:
                yield list(batch)
            return
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            entropy = None if self.seed is None else (self.seed, self._epoch)
            np.random.default_rng(entropy).shuffle(indices)
        stop = len(indices) - len(indices) % self.batch_size if self.drop_last else len(indices)
        for start in range(0, stop, self.batch_size):
            yield indices[start : start + self.batch_size].tolist()

    def _fetch(self, batch_indices: List[int]) -> Item:
        global_n = len(batch_indices)
        if self.process_shard is not None:
            index, count = self.process_shard
            if global_n % count:
                raise ValueError(f"global batch of {global_n} not divisible by {count} processes — "
                                 "use drop_last or a divisible batch_size")
            per = global_n // count
            batch_indices = batch_indices[index * per : (index + 1) * per]
        with annotate("data.fetch"):
            batch = self.collate_fn(self._fetch_items(batch_indices))
        if self.process_shard is not None:
            batch["global_batch_size"] = global_n
        return batch

    def _fetch_items(self, batch_indices: List[int]) -> List[Item]:
        pool_map = self._pool.map if self._pool is not None else None
        if hasattr(self.dataset, "getitems"):
            return list(self.dataset.getitems(batch_indices, map_fn=pool_map))
        if pool_map is not None and len(batch_indices) > 1:
            return list(pool_map(self.dataset.__getitem__, batch_indices))
        return [self.dataset[i] for i in batch_indices]

    def __iter__(self) -> Iterator[Item]:
        if self.prefetch_batches <= 0:
            for batch_indices in self._index_batches():
                yield self._fetch(batch_indices)
            return

        # a producer thread fills a bounded queue; `done` ends the stream and
        # carries the producer's exception, if any, to the consumer
        ready: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        done = object()
        failure: List[BaseException] = []
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    ready.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce() -> None:
            try:
                for batch_indices in self._index_batches():
                    if not put(self._fetch(batch_indices)):
                        return
            except BaseException as exc:
                failure.append(exc)
            finally:
                put(done)  # blocks until taken: a full queue must not drop it

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                with annotate("data.wait"):
                    item = ready.get()
                if item is done:
                    break
                yield item
            if failure:
                raise failure[0]
        finally:
            # a consumer that leaves early must not strand the producer on a
            # full queue: tell it to stop and drain until it has ended
            stop.set()
            while thread.is_alive():
                try:
                    ready.get_nowait()
                except queue.Empty:
                    pass
                thread.join(timeout=0.05)


def cuda_prefetch(batches: Iterable[Item], device, *, size: int = 2,
                  counter: Optional[Counter] = None) -> Iterator[Item]:
    """Move numeric numpy arrays of each batch to `device` ahead of their use.

    On a CUDA device every array is copied into a pinned host buffer and from
    there to the card on a side stream (`non_blocking`), up to `size` batches
    ahead; the consumer's stream waits on the copy before it gets the batch,
    and the tensors are recorded on it so their memory is not reused early.
    On the CPU the arrays become tensors and nothing else happens. Strings
    and lists pass through. Each batch handed over is one `data.next` span,
    and its host seconds go to `counter` (a new `data.next` counter if none
    is given)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    stream = torch.cuda.Stream(device) if on_card else None
    counter = counter or Counter("data.next")

    def move(batch: Item):
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray) and v.dtype != object}
        event = None
        if on_card:
            with annotate("data.pin"):
                arrays = {k: torch.from_numpy(v).pin_memory() for k, v in arrays.items()}
            with annotate("data.copy"), torch.cuda.stream(stream):
                arrays = {k: v.to(device, non_blocking=True) for k, v in arrays.items()}
                event = torch.cuda.Event()
                event.record(stream)
        else:
            arrays = {k: torch.from_numpy(v) for k, v in arrays.items()}
        return {k: arrays.get(k, v) for k, v in batch.items()}, event

    def hand_over(moved):
        batch, event = moved
        if event is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            for value in batch.values():
                if isinstance(value, torch.Tensor):
                    value.record_stream(current)
        return batch

    it = iter(batches)
    ahead: List = []
    exhausted = False
    while True:
        t0 = time.perf_counter()
        with annotate("data.next"):
            while not exhausted and len(ahead) < max(1, size):
                try:
                    ahead.append(move(next(it)))
                except StopIteration:
                    exhausted = True
            batch = hand_over(ahead.pop(0)) if ahead else None
        if batch is None:
            return
        counter.add(time.perf_counter() - t0)
        yield batch
