"""Tensor ops of the PyTorch port.

Re-exports, under the same names and lazily, the counterparts of what
`ragb_vae_tpu/ops/__init__.py` exports (`ragb_vae_tpu_torch/_exports.py`);
the bucket helpers live in `data/buckets.py` in the port.
"""
from ragb_vae_tpu_torch._exports import lazy_exports

_RGBA = "ragb_vae_tpu_torch.ops.rgba"
_BUCKETS = "ragb_vae_tpu_torch.data.buckets"
_EXPORTS = {
    **dict.fromkeys(("ensure_alpha", "to_vae_range", "from_vae_range", "composite_over_background",
                     "composite_over_white", "composite_over_black", "blend_to_white", "checkerboard",
                     "composite_over_checkerboard"), _RGBA),
    "DiagonalGaussian": "ragb_vae_tpu_torch.ops.gaussian",
    "psnr": "ragb_vae_tpu_torch.ops.metrics",
    "alpha_mae": "ragb_vae_tpu_torch.ops.metrics",
    **dict.fromkeys(("round_to_multiple", "should_exclude_size", "bucket_for_size", "bucket_assignment",
                     "parse_bucket_dims", "format_bucket_key", "MAX_SIDE", "MAX_PIXELS", "MULTIPLE",
                     "MIN_BUCKET_SIDE", "FILTER_MIN_SIDE", "FILTER_MAX_AR"), _BUCKETS),
    "detail_augmented_triplet": "ragb_vae_tpu_torch.ops.triplet",
    "split_triplet": "ragb_vae_tpu_torch.ops.triplet",
    "pack_latents": "ragb_vae_tpu_torch.ops.packing",
    "unpack_latents": "ragb_vae_tpu_torch.ops.packing",
    "prepare_latent_image_ids": "ragb_vae_tpu_torch.ops.packing",
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
