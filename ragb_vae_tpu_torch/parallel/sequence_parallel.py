"""Sequence parallelism of the FLUX token streams over a sequence group.

Counterpart of the "sp" axis of the JAX package: `_constrain_seq` in
`ragb_vae_tpu/models/flux_kontext_textalpha.py` pins the packed image stream
(B, S_img, C) and the prompt stream (B, S_txt, C) sequence-sharded, and
`attention(mesh=, seq_axis="sp")` in `ragb_vae_tpu/ops/pallas/
flash_attention.py` keeps q local and all-gathers k and v over the axis. The
port runs one process per device, so the slicing and the collectives are
made here, over a `parallel/mesh.py::Mesh`:

- `local_part` keeps this rank's contiguous 1/sp of a stream and of its
  RoPE ids (JAX's `P(data, "sp", None)`): every per-token op of a block
  (linears, AdaLN, RMSNorm, RoPE) then runs on S / sp tokens. A single
  block's local stream is cat(txt_local, img_local).
- `gather_seq` all-gathers k and v (after RoPE) before the attention kernel;
  its backward reduce-scatters (sums) dK and dV, since every rank's queries
  attend to every key. With `segments` (the local lengths of the streams
  that make up the local tokens, txt first) the gathered keys come back in
  the unsharded order [txt_0, txt_1, img_0, img_1], not rank by rank, so the
  attention sums its keys in the order one process does.
- `gather_out` all-gathers the prediction for a loss that every rank takes
  over the whole stream; its backward hands each rank its own slice of the
  gradient (a sum would scale every adapter gradient by sp once they are
  summed over the group).
- `applies` is JAX's fallback: where a stream's length does not divide by
  sp, the whole forward runs unsharded on every rank.

Each adapter gradient is then a partial over the rank's tokens: the training
step sums it over the sequence group (`tensor_parallel.sum_grads_over`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ragb_vae_tpu_torch.parallel.mesh import Mesh

Tensor = torch.Tensor

# collectives made by the operators below since the last reset
COUNTS = {"all_gather": 0, "reduce_scatter": 0}


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def applies(mesh: Optional[Mesh], *lengths: int) -> bool:
    """Whether the streams of `lengths` are sharded over `mesh`: an axis of
    size above 1 that divides every one of them (JAX `_constrain_seq` and
    `attention`'s `axis_name`)."""
    return mesh is not None and mesh.size > 1 and all(n % mesh.size == 0 for n in lengths)


def local_part(t: Tensor, mesh: Mesh, dim: int = 1) -> Tensor:
    """This rank's contiguous 1/size of `t` along `dim`."""
    per = t.shape[dim] // mesh.size
    return t.narrow(dim, mesh.rank * per, per)


def _all_gather(t: Tensor, mesh: Mesh) -> Tensor:
    """(size, *t.shape): every rank's `t`, in rank order."""
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.stack(parts)


def _reduce_scatter(stacked: Tensor, mesh: Mesh) -> Tensor:
    """The sum over the axis of `stacked` (size, ...), of which this rank
    keeps entry `rank`: a reduce-scatter on NCCL; an all-reduce and a slice
    on gloo, which has no reduce-scatter for CUDA tensors."""
    stacked = stacked.contiguous()
    if dist.get_backend(mesh.group) == "nccl":
        out = stacked.new_empty(stacked.shape[1:])
        dist.reduce_scatter_tensor(out, stacked, op=dist.ReduceOp.SUM, group=mesh.group)
        return out
    dist.all_reduce(stacked, group=mesh.group)
    return stacked[mesh.rank].clone()


def _unshard(stacked: Tensor, dim: int, segments: Sequence[int]) -> Tensor:
    """(size, ..., L, ...) with L = sum(segments) along `dim` (of the
    unstacked tensor) -> (..., size * L, ...) in the unsharded order: each
    segment's ranks end to end, segment after segment."""
    parts, start = [], 0
    for n in segments:
        seg = stacked.narrow(dim + 1, start, n)
        parts.append(seg.movedim(0, dim).flatten(dim, dim + 1))
        start += n
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def _reshard(full: Tensor, dim: int, segments: Sequence[int], size: int) -> Tensor:
    """Inverse of `_unshard`: (..., size * L, ...) -> (size, ..., L, ...)."""
    parts, start = [], 0
    for n in segments:
        seg = full.narrow(dim, start, size * n)
        shape = seg.shape[:dim] + (size, n) + seg.shape[dim + 1:]
        parts.append(seg.reshape(shape).movedim(dim, 0))
        start += size * n
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim + 1)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dim, segments):
        ctx.mesh, ctx.dim, ctx.segments = mesh, dim, segments
        COUNTS["all_gather"] += 1
        return _unshard(_all_gather(t, mesh), dim, segments)

    @staticmethod
    def backward(ctx, g):
        COUNTS["reduce_scatter"] += 1
        stacked = _reshard(g, ctx.dim, ctx.segments, ctx.mesh.size)
        return _reduce_scatter(stacked, ctx.mesh), None, None, None


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.mesh, ctx.dim, ctx.length = mesh, dim, t.shape[dim]
        COUNTS["all_gather"] += 1
        return _unshard(_all_gather(t, mesh), dim, (t.shape[dim],))

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.mesh.rank * ctx.length, ctx.length).contiguous(), None, None


def gather_seq(t: Tensor, mesh: Mesh, dim: int, segments: Optional[Tuple[int, ...]] = None) -> Tensor:
    """Every rank's `t` along `dim` (k or v after RoPE), in the unsharded
    order of `segments` (default: one stream); backward: the gradient
    summed over the axis, this rank's part kept."""
    if mesh.size == 1:
        return t
    return _GatherSeq.apply(t, mesh, dim, tuple(segments or (t.shape[dim],)))


def gather_out(t: Tensor, mesh: Mesh, dim: int = 1) -> Tensor:
    """Every rank's `t` along `dim`, for a computation every rank repeats
    whole (the loss, the sampler step); backward: this rank's slice."""
    if mesh.size == 1:
        return t
    return _GatherOut.apply(t, mesh, dim)
