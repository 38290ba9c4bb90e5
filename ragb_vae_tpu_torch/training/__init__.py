"""Training stages of the PyTorch port and their dispatcher.

Counterpart of `ragb_vae_tpu/training/__init__.py`: `run_stage` dispatches
on `training.stage`. `rgba_vae` (stage 1) and `kontext_textalpha_lora` are
real; `decompose` and `refine` are placeholders, as in the JAX package. The
stage modules are imported when a stage runs, or when one of the stage-1
names JAX re-exports here is first used (`ragb_vae_tpu_torch/_exports.py`),
so importing this package loads neither.
"""
from __future__ import annotations

from typing import Any, Dict

from ragb_vae_tpu_torch._exports import lazy_exports

_EXPORTS = dict.fromkeys(("build_dataloader", "build_training_batch", "evaluate_rgba_vae", "save_checkpoints",
                          "train_rgba_vae"), "ragb_vae_tpu_torch.training.rgba_vae_stage")
__all__ = sorted([*_EXPORTS, "run_stage", "train_decomposition", "train_refine"])
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)


def train_decomposition(cfg: Dict[str, Any], **kwargs) -> None:
    raise NotImplementedError("Decomposition training stage (VLD-MMDiT) is not implemented yet.")


def train_refine(cfg: Dict[str, Any], **kwargs) -> None:
    raise NotImplementedError("Refinement training stage is not implemented yet.")


def run_stage(cfg: Dict[str, Any], **kwargs):
    """Run the stage `cfg["training"]["stage"]` names; keyword arguments
    (`device=` for both real stages) go to the stage's entry."""
    stage = cfg.get("training", {}).get("stage")
    if stage == "rgba_vae":
        from ragb_vae_tpu_torch.training.rgba_vae_stage import train_rgba_vae

        return train_rgba_vae(cfg, **kwargs)
    if stage == "kontext_textalpha_lora":
        from ragb_vae_tpu_torch.training.flux_kontext_textalpha_lora import train_from_config

        return train_from_config(cfg, **kwargs)
    if stage == "decompose":
        return train_decomposition(cfg, **kwargs)
    if stage == "refine":
        return train_refine(cfg, **kwargs)
    raise ValueError(f"Unknown training stage '{stage}'.")
