"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

Re-exports, lazily, `attention` as `ragb_vae_tpu/ops/pallas/__init__.py` does
(`ragb_vae_tpu_torch/_exports.py`); `int8_matmul` names the submodule here, so
the function stays `ops.kernels.int8_matmul.int8_matmul`. Nothing is built
until a kernel launches.
"""
from ragb_vae_tpu_torch._exports import lazy_exports

_EXPORTS = {
    "attention": "ragb_vae_tpu_torch.ops.kernels.flash_attention",
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
