"""Gradient accumulation over microbatches.

Counterpart of `ragb_vae_tpu/parallel/grad_accum.py`. The JAX package scans
the microbatches inside one compiled step; PyTorch runs eagerly, so this is
a Python loop whose backward passes add into the parameters' `.grad`, and
one microbatch's activations are alive at a time.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ragb_vae_tpu_torch.utils.profiling import annotate

Tensor = torch.Tensor
Batch = Dict[str, Tensor]


def split_microbatches(batch: Batch, num_micro: int) -> List[Batch]:
    """Cut every (B, ...) entry into `num_micro` equal chunks along the batch
    axis -> one dict per microbatch."""
    chunks: List[Batch] = [{} for _ in range(num_micro)]
    for name, value in batch.items():
        bsz = value.shape[0]
        if bsz % num_micro != 0:
            raise ValueError(f"Batch {bsz} not divisible by {num_micro} microbatches.")
        for micro, part in zip(chunks, value.reshape((num_micro, bsz // num_micro) + value.shape[1:])):
            micro[name] = part
    return chunks


def accumulated_grads(
    loss_fn: Callable[[Batch, int], Tuple[Tensor, Dict[str, Tensor]]],
    params: Sequence[Tensor],
    batch: Batch,
    num_micro: int,
    micro_weight_fn: Optional[Callable[[Batch], Tensor]] = None,
    backward_span: str = "backward",
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Mean loss, aux and gradients over `num_micro` microbatches.

    `loss_fn(microbatch, index) -> (loss, aux)` with a scalar loss and a dict
    of scalar aux values. Returns (loss, aux), both microbatch means; the
    mean gradient is left in each parameter's `.grad` (overwritten, not added
    to what was there).

    `micro_weight_fn(microbatch) -> scalar` weights each microbatch (for
    example by its real-sample weight sum). A loss that is a weighted mean
    per microbatch, averaged uniformly, is not the global weighted mean once
    padding rows (weight 0) gather in one microbatch; with W = sum of the
    weights per microbatch, sum(W * mean) / sum(W) is exactly the unpadded
    global mean, for the gradients as for the loss. Without it every
    microbatch counts the same.

    Each microbatch's backward is a span (`utils/profiling.py::annotate`)
    of the kind `backward_span`.
    """
    def backward(loss: Tensor) -> None:
        with annotate(backward_span):
            loss.backward()

    for p in params:
        p.grad = None
    if num_micro <= 1:
        loss, aux = loss_fn(batch, 0)
        backward(loss)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    total_loss: Optional[Tensor] = None
    total_aux: Dict[str, Tensor] = {}
    total_w: Optional[Tensor] = None
    for index, micro in enumerate(split_microbatches(batch, num_micro)):
        loss, aux = loss_fn(micro, index)
        w = loss.new_ones(()) if micro_weight_fn is None else micro_weight_fn(micro).float()
        backward(loss * w)
        loss = loss.detach()
        if total_loss is None:
            total_loss, total_w = w * loss, w
            total_aux = {k: w * v.detach() for k, v in aux.items()}
        else:
            total_loss, total_w = total_loss + w * loss, total_w + w
            for k, v in aux.items():
                total_aux[k] = total_aux[k] + w * v.detach()
    inv = 1.0 / torch.clamp(total_w, min=1e-8)
    for p in params:
        if p.grad is not None:
            p.grad.mul_(inv)
    return total_loss * inv, {k: v * inv for k, v in total_aux.items()}
