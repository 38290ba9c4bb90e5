"""The ZeRO flat-shard layout: which rank owns which slice of which parameter.

Counterpart of `zero_sharding` in `ragb_vae_tpu/parallel/sharding.py`. The
JAX package annotates each optimizer-state leaf with a sharding and lets XLA
place it; the port lays every trainable parameter end to end in one fp32
buffer, in parameter order, pads it with zeros to a multiple of the number of
ranks and gives rank r the contiguous slice [r * k, (r + 1) * k) of
k = padded / ranks elements. The layout lives only in memory: checkpoints
gather the slices back into per-parameter tensors (`zero_step.ZeroAdamW.
state_dict`), so they do not depend on the number of ranks.

`spec_dim` / `zero_sharding` / `fsdp_sharding` restate JAX's per-leaf rule
(`_spec_for_leaf`): a leaf of fewer than `DEFAULT_MIN_SHARD_SIZE` elements
stays replicated, any other is split on the first dim that the axis size
divides. The port's FSDP (`parallel/fsdp.py`) splits the frozen base by it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor

# Leaves smaller than this stay replicated (JAX `DEFAULT_MIN_SHARD_SIZE`):
# splitting a bias or a norm scale buys no memory and costs a collective.
DEFAULT_MIN_SHARD_SIZE = 2**16


def spec_dim(shape: Sequence[int], axis_size: int, min_size: int = DEFAULT_MIN_SHARD_SIZE) -> Optional[int]:
    """The dim a leaf of `shape` is split on over an axis of `axis_size`, or
    None for a replicated one (JAX `_spec_for_leaf`)."""
    shape = tuple(int(n) for n in shape)
    if axis_size <= 1 or not shape or math.prod(shape) < min_size:
        return None
    for dim, n in enumerate(shape):
        if n % axis_size == 0 and n >= axis_size:
            return dim
    return None


def zero_sharding(shapes: Dict[str, Sequence[int]], axis_size: int,
                  min_size: int = DEFAULT_MIN_SHARD_SIZE) -> Dict[str, Optional[int]]:
    """{name: split dim or None} of every leaf of `shapes` (JAX
    `zero_sharding`, as dims instead of `NamedSharding`s)."""
    return {k: spec_dim(shape, axis_size, min_size) for k, shape in shapes.items()}


def fsdp_sharding(shapes: Dict[str, Sequence[int]], axis_size: int,
                  min_size: int = DEFAULT_MIN_SHARD_SIZE) -> Dict[str, Optional[int]]:
    """The same rule over a parameter tree (JAX `fsdp_sharding`)."""
    return zero_sharding(shapes, axis_size, min_size)


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
