"""The ZeRO flat-shard layout: which rank owns which slice of which parameter.

Counterpart of `zero_sharding` in `ragb_vae_tpu/parallel/sharding.py`. The
JAX package annotates each optimizer-state leaf with a sharding and lets XLA
place it; the port lays every trainable parameter end to end in one fp32
buffer, in parameter order, pads it with zeros to a multiple of the number of
ranks and gives rank r the contiguous slice [r * k, (r + 1) * k) of
k = padded / ranks elements. The layout lives only in memory: checkpoints
gather the slices back into per-parameter tensors (`zero_step.ZeroAdamW.
state_dict`), so they do not depend on the number of ranks.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """`sizes[i]` elements of parameter i start at `offsets[i]` of the flat
    buffer; `shard` elements a rank over `ranks` ranks."""

    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    ranks: int

    @classmethod
    def of(cls, params: Sequence[Tensor], ranks: int) -> "FlatLayout":
        sizes = tuple(int(p.numel()) for p in params)
        offsets, total = [], 0
        for n in sizes:
            offsets.append(total)
            total += n
        return cls(sizes, tuple(offsets), int(ranks))

    @property
    def total(self) -> int:
        return sum(self.sizes)

    @property
    def padded(self) -> int:
        return -(-self.total // self.ranks) * self.ranks

    @property
    def shard(self) -> int:
        return self.padded // self.ranks

    def owned(self, rank: int) -> List[Tuple[int, int, int, int]]:
        """(parameter index, start and stop within the parameter, start within
        the shard) of every piece of the parameters that `rank` owns."""
        lo, hi = rank * self.shard, (rank + 1) * self.shard
        pieces = []
        for i, (off, n) in enumerate(zip(self.offsets, self.sizes)):
            a, b = max(lo, off), min(hi, off + n)
            if a < b:
                pieces.append((i, a - off, b - off, a - lo))
        return pieces

    def flatten(self, tensors: Sequence[Tensor], *, like: Tensor) -> Tensor:
        """The tensors (None reads as zeros) end to end in fp32, zero-padded
        to `padded`, on `like`'s device."""
        flat = torch.zeros(self.padded, dtype=torch.float32, device=like.device)
        for t, off, n in zip(tensors, self.offsets, self.sizes):
            if t is not None:
                flat[off : off + n].copy_(t.reshape(-1))
        return flat

    def unflatten_into(self, flat: Tensor, tensors: Sequence[Tensor]) -> None:
        """Copy the full buffer `flat` back into `tensors` (in place)."""
        for t, off, n in zip(tensors, self.offsets, self.sizes):
            t.view(-1).copy_(flat[off : off + n])

    def slice_of(self, tensors: Sequence[Tensor], rank: int, *, like: Tensor) -> Tensor:
        """`rank`'s slice of the flat buffer of `tensors`, without building
        the whole buffer."""
        out = torch.zeros(self.shard, dtype=torch.float32, device=like.device)
        for i, a, b, s in self.owned(rank):
            out[s : s + b - a].copy_(tensors[i].reshape(-1)[a:b])
        return out
