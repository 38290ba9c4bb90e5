"""PyTorch / CUDA port of ragb_vae_tpu for one NVIDIA H100.

Mirrors the JAX package's layout (`models/`, `ops/`, `ops/kernels/` in place
of `ops/pallas/`, `inference.py`, `serving.py`); the CUDA sources of the
hand-written kernels live in `csrc/`. Public functions keep the JAX
package's layout: NHWC images in [0, 1], FLUX tokens as (B, S, C).

The top-level names of `ragb_vae_tpu/__init__.py` load lazily here too
(`ragb_vae_tpu_torch/_exports.py`), so `import ragb_vae_tpu_torch` stays light.
"""
from ragb_vae_tpu_torch._exports import lazy_exports

_P = "ragb_vae_tpu_torch."
_EXPORTS = {
    "RgbaVAE": _P + "models.rgba_vae",
    "AutoencoderConfig": _P + "models.vae_config",
    "AlphaVaeLossConfig": _P + "models.losses",
    "FluxTextAlphaModel": _P + "models.flux_kontext_textalpha",
    "FluxTransformer2D": _P + "models.flux_transformer",
    "FluxTransformerConfig": _P + "models.flux_transformer",
    "FlowMatchEulerScheduler": _P + "models.scheduler",
    "RgbaComponentDataset": _P + "data.component_dataset",
    "create_component_dataloader": _P + "data.component_dataset",
    "MixedBucketDataset": _P + "data.bucket_dataset",
    "BucketBatchSampler": _P + "data.sampler",
    "TextAlphaBucketDataset": _P + "data.text_alpha_dataset",
    "MultiLayerDataset": _P + "data.multilayer_dataset",
    "DataLoader": _P + "data.loader",
    "load_config": _P + "config",
    "run_stage": _P + "training",
    "train_rgba_vae": _P + "training.rgba_vae_stage",
    "create_mesh": _P + "parallel.mesh",
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
