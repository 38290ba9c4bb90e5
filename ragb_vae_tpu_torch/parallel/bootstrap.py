"""Shared bootstrap of the `--tp` / `--pp` serving and inference paths.

Counterpart of `ragb_vae_tpu/parallel/bootstrap.py`: `inference.run` and
`serving_daemon.build_server` both turn the user's `--tp N | --pp N` flags
into the model axis or the pipeline here, so the checks live once.

The JAX package serves `--tp N` from one process over N devices. The port
runs one process per device under `torchrun --nproc-per-node N`: the model
axis is the whole world, N must equal its size, and each rank loads only its
shard of the transformer (`parallel/tensor_parallel.py`). `--pp N` runs as in
JAX, one process driving N devices (`parallel/pipeline.py`).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig
from ragb_vae_tpu_torch.parallel.mesh import Mesh, create_dp_tp_mesh, maybe_init_distributed, process_count
from ragb_vae_tpu_torch.parallel.pipeline import PipelinedFluxTransformer


def validate_tp_pp(tp: int, pp: int) -> None:
    """--tp and --pp are mutually exclusive (one transformer layout each)."""
    if tp > 1 and pp > 1:
        raise SystemExit("--tp and --pp are mutually exclusive.")


def build_tp_group(tp: int, device="cuda") -> Mesh:
    """The model axis of `--tp N`: the whole process group, which must hold
    exactly N processes (joined here from torchrun's environment on `device`
    when not yet joined); an axis of size 1 when tp <= 1. Without a group,
    or with a world of another size, it exits with a message that names
    torchrun."""
    if tp <= 1:
        return Mesh()
    maybe_init_distributed(device)
    world = process_count()
    if world != tp:
        raise SystemExit(f"--tp {tp} needs {tp} processes, one per device, found {world}: run it as "
                         f"`torchrun --nproc-per-node {tp} -m ...` with --tp equal to the world size.")
    _, model = create_dp_tp_mesh(tp)
    return model


def build_pipelined_transformer(pp: int, device, model_path) -> Optional[PipelinedFluxTransformer]:
    """The pipeline of `--pp N` over the checkpoint's transformer config
    (`<model_path>/transformer/config.json`): on the card its stages on
    `cuda:0` .. `cuda:N-1` (it exits naming the count, before reading
    anything, when fewer cards are visible), on the CPU N stages on the CPU;
    None when pp <= 1."""
    if pp <= 1:
        return None
    device = torch.device(device)
    if device.type == "cuda":
        found = torch.cuda.device_count()
        if found < pp:
            raise SystemExit(f"--pp {pp} needs {pp} devices, found {found}.")
        devices = [torch.device("cuda", i) for i in range(pp)]
    else:
        devices = [device] * pp
    config = FluxTransformerConfig.from_json(Path(model_path) / "transformer" / "config.json")
    return PipelinedFluxTransformer(config, devices)
