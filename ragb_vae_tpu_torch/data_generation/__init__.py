"""Offline data preparation (host-side, CPU, embarrassingly parallel).

Counterpart of `ragb_vae_tpu/data_generation/`: the RGBA bucket preparation
of multilayer renders (`rgba_buckets`), the PrismLayers bucketers and the
LAION downloader (`hf_bucketers`). They run on CPU hosts, in worker pools or
sharded by rank, never on the card.
"""
from ragb_vae_tpu_torch.data_generation.rgba_buckets import (
    iterate_foreground_groups,
    process_sample,
    run_prepare,
)

__all__ = ["iterate_foreground_groups", "process_sample", "run_prepare"]
