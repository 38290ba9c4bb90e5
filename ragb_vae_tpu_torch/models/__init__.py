"""Model modules of the PyTorch port.

Re-exports, under the same names and lazily, the counterparts of what
`ragb_vae_tpu/models/__init__.py` exports (`ragb_vae_tpu_torch/_exports.py`).
"""
from ragb_vae_tpu_torch._exports import lazy_exports

_FLUX = "ragb_vae_tpu_torch.models.flux_kontext_textalpha"
_EXPORTS = {
    "AlphaVaeLoss": "ragb_vae_tpu_torch.models.losses:AlphaVaeLossConfig",   # the reference's class name
    "AlphaVaeLossConfig": "ragb_vae_tpu_torch.models.losses",
    "AutoencoderConfig": "ragb_vae_tpu_torch.models.vae_config",
    "AutoencoderKL": "ragb_vae_tpu_torch.models.vae",
    "FlowMatchEulerScheduler": "ragb_vae_tpu_torch.models.scheduler",
    "FluxTextAlphaModel": _FLUX,
    "FluxTransformer2D": "ragb_vae_tpu_torch.models.flux_transformer",
    "FluxTransformerConfig": "ragb_vae_tpu_torch.models.flux_transformer",
    "RgbaVAE": "ragb_vae_tpu_torch.models.rgba_vae",
    "adapt_params_to_rgba": "ragb_vae_tpu_torch.models.weights",
    "alphavae_reconstruction_loss": "ragb_vae_tpu_torch.models.losses",
    "composite_over_background": "ragb_vae_tpu_torch.ops.rgba",
    "composite_over_black": "ragb_vae_tpu_torch.ops.rgba",
    "composite_over_white": "ragb_vae_tpu_torch.ops.rgba",
    "encode_empty_prompt": _FLUX,
    "kl_loss": "ragb_vae_tpu_torch.models.losses",
    "load_autoencoder_params": "ragb_vae_tpu_torch.models.weights",
    "load_rgba_vae_from_path": _FLUX,
    "load_scheduler": _FLUX,
    "load_transformer": _FLUX,
    "perceptual_composites": "ragb_vae_tpu_torch.models.losses",
    "read_lora_metadata": _FLUX,
    "reduce_loss": "ragb_vae_tpu_torch.models.losses",
    "save_autoencoder_params": "ragb_vae_tpu_torch.models.weights",
    "write_lora_metadata": _FLUX,
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
