"""Bucket-pure batch sampler with an explicit seeded RNG.

Counterpart of `ragb_vae_tpu/data/sampler.py`: every batch holds indices of
one resolution bucket, buckets in sequence or interleaved in proportion to
what they still hold. The shuffle stream is Python's `random.Random` seeded
from (seed, epoch) and consumed in the same order as the JAX package's
sampler, so one seed gives the same index order in both packages.
"""
from __future__ import annotations

import math
import random
from typing import Dict, Iterator, List, Optional


class BucketBatchSampler:
    def __init__(
        self,
        bucket_to_indices: Dict[str, List[int]],
        *,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = False,
        interleave: bool = False,
        seed: Optional[int] = None,
    ) -> None:
        self.bucket_to_indices = {key: list(idxs) for key, idxs in bucket_to_indices.items()}
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.interleave = interleave
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Another shuffle stream for another epoch (only with a seed)."""
        self._epoch = epoch

    def _rng(self) -> random.Random:
        if self.seed is None:
            return random.Random()
        return random.Random(hash((self.seed, self._epoch)))

    def _batches_of(self, indices: List[int], rng: random.Random) -> List[List[int]]:
        """One bucket's indices, shuffled, cut into batches; the short last
        batch stays unless `drop_last`."""
        order = list(indices)
        if self.shuffle:
            rng.shuffle(order)
        stop = len(order) - len(order) % self.batch_size if self.drop_last else len(order)
        return [order[i : i + self.batch_size] for i in range(0, stop, self.batch_size)]

    def __iter__(self) -> Iterator[List[int]]:
        rng = self._rng()
        queues = {key: self._batches_of(idxs, rng) for key, idxs in self.bucket_to_indices.items()}

        if not self.interleave:
            keys = list(queues)
            if self.shuffle:
                rng.shuffle(keys)
            for key in keys:
                yield from queues[key]
            return

        # interleaved: the next batch comes from a bucket drawn with weight
        # equal to the samples it still holds
        left = {key: sum(len(b) for b in q) for key, q in queues.items()}
        pos = {key: 0 for key in queues}
        live = [key for key, q in queues.items() if q]
        while live:
            key = live[0]
            if self.shuffle and len(live) > 1:
                key = rng.choices(live, weights=[left[k] for k in live])[0]
            batch = queues[key][pos[key]]
            pos[key] += 1
            left[key] -= len(batch)
            if pos[key] == len(queues[key]):
                live.remove(key)
            yield batch

    def __len__(self) -> int:
        per_bucket = math.floor if self.drop_last else math.ceil
        return sum(per_bucket(len(idxs) / self.batch_size) for idxs in self.bucket_to_indices.values())
