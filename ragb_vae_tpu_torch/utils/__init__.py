"""Host-side utilities of the PyTorch port: metrics sink, preemption guard, tracing.

Re-exports, lazily, the counterparts of what `ragb_vae_tpu/utils/__init__.py`
exports (`ragb_vae_tpu_torch/_exports.py`); `torch.profiler` has no live
capture server, so JAX's `maybe_start_server` has none.
"""
from ragb_vae_tpu_torch._exports import lazy_exports

_EXPORTS = {
    "annotate": "ragb_vae_tpu_torch.utils.profiling",
    "trace_context": "ragb_vae_tpu_torch.utils.profiling",
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
