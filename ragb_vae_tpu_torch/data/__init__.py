"""Host-side data helpers of the PyTorch port.

Re-exports, under the same names and lazily, the counterparts of what
`ragb_vae_tpu/data/__init__.py` exports (`ragb_vae_tpu_torch/_exports.py`);
JAX's `device_prefetch` is `data/loader.py::cuda_prefetch` here.
"""
from ragb_vae_tpu_torch._exports import lazy_exports

_D = "ragb_vae_tpu_torch.data."
_EXPORTS = {
    "BucketBatchSampler": _D + "sampler",
    "DataLoader": _D + "loader",
    "MixedBucketDataset": _D + "bucket_dataset",
    "MultiLayerDataset": _D + "multilayer_dataset",
    "MultiLayerSample": _D + "multilayer_dataset",
    "RandomBackgroundBlend": _D + "transforms",
    "RgbaComponentDataset": _D + "component_dataset",
    "TextAlphaBucketDataset": _D + "text_alpha_dataset",
    "build_bucket_entries": _D + "manifest",
    "create_component_dataloader": _D + "component_dataset",
    "default_collate": _D + "loader",
    "load_rgba": _D + "image_io",
    "multilayer_collate": _D + "multilayer_dataset",
    "pad_collate": _D + "loader",
    "pil_to_array": _D + "image_io",
    "save_rgba": _D + "image_io",
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
