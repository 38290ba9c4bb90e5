"""Parallel axes of the PyTorch port: data (ZeRO-2) and model (tensor parallel) over process groups.

Re-exports, under the same names and lazily, the counterparts of what
`ragb_vae_tpu/parallel/__init__.py` exports (`ragb_vae_tpu_torch/_exports.py`).
JAX's GSPMD placements, multi-slice meshes and optax ZeRO functions have
none: the axes are process groups, and `parallel/zero_step.py::ZeroAdamW` is
the ZeRO-2 optimizer.
"""
from ragb_vae_tpu_torch._exports import lazy_exports

_MESH = "ragb_vae_tpu_torch.parallel.mesh"
_EXPORTS = {
    "accumulated_grads": "ragb_vae_tpu_torch.parallel.grad_accum",
    "split_microbatches": "ragb_vae_tpu_torch.parallel.grad_accum",
    "create_dp_tp_mesh": _MESH,
    "create_mesh": _MESH,
    "create_training_mesh": _MESH,
    "maybe_init_distributed": _MESH,
    "pad_batch_to_mesh": _MESH,
    "fsdp_sharding": "ragb_vae_tpu_torch.parallel.sharding",
    "zero_sharding": "ragb_vae_tpu_torch.parallel.sharding",
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
