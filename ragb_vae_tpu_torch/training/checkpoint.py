"""Checkpoints of the stage-1 loop: weights, train state, resume.

Counterpart of `ragb_vae_tpu/training/checkpoint.py`. A checkpoint directory
holds, written in this order:
- `rgba_vae_hf/`: the weights in HF format (config.json and
  diffusion_pytorch_model.safetensors with the diffusers keys), the same
  files the JAX package writes, so either package reads the other's;
- `train_state.json`: {"step": N, ...};
- `train_state.pt`: torch.save of {"optimizer": the optimizer's state dict,
  "step": N, "generator": the noise generator's state}. It takes the place
  of the JAX package's `train_state.msgpack` (an optax state serialised by
  flax means nothing to `torch.optim`) and is written last: it marks the
  checkpoint complete. A directory the JAX package wrote has no such file;
  it resumes when named explicitly, with its weights and step and a fresh
  optimizer.
"""
from __future__ import annotations

import json
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
from ragb_vae_tpu_torch.models.weights import StateDict, load_autoencoder_params, save_autoencoder_params

STATE_FILE = "train_state.pt"
META_FILE = "train_state.json"
HF_SUBDIR = "rgba_vae_hf"


def checkpoint_dir(base: Union[str, Path], step: Optional[int] = None) -> Path:
    """`base/step_{NNNNNNN}`, or `base` itself without a step."""
    base = Path(base)
    return base if step is None else base / f"step_{step:07d}"


def _to_host(tree: Any) -> Any:
    """A copy of every tensor of a nested dict / list / tuple on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def save_train_checkpoint(
    directory: Union[str, Path],
    *,
    config: AutoencoderConfig,
    state: StateDict,
    optimizer_state: Optional[Dict[str, Any]] = None,
    generator_state: Optional[torch.Tensor] = None,
    step: int = 0,
    extra_meta: Optional[dict] = None,
) -> Path:
    """Write the weights (`state`: the module's state dict), the metadata and,
    last, the train state under `directory`."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    save_autoencoder_params(config, {k: v.float() for k, v in state.items()}, directory / HF_SUBDIR)
    meta = {"step": int(step), **(extra_meta or {})}
    (directory / META_FILE).write_text(json.dumps(meta, indent=2))
    train_state = {"optimizer": optimizer_state, "step": int(step), "generator": generator_state}
    tmp = directory / (STATE_FILE + ".tmp")
    torch.save(_to_host(train_state), tmp)
    tmp.replace(directory / STATE_FILE)
    return directory


def load_train_checkpoint(
    directory: Union[str, Path],
) -> Tuple[AutoencoderConfig, StateDict, Optional[Dict[str, Any]], dict]:
    """-> (config, state dict, train state or None, metadata). The train
    state is None for a directory without `train_state.pt` (one the JAX
    package wrote); the metadata's step is then the step to resume at."""
    directory = Path(directory)
    config, state = load_autoencoder_params(directory / HF_SUBDIR)
    meta_path = directory / META_FILE
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    state_path = directory / STATE_FILE
    train_state = torch.load(state_path, map_location="cpu", weights_only=True) if state_path.exists() else None
    return config, state, train_state, meta


def _step_number(path: Path) -> int:
    """The step of a step_* dir name, numerically (a lexical sort misorders
    steps that outgrow the zero padding)."""
    try:
        return int(path.name.split("_", 1)[1])
    except (IndexError, ValueError):
        return -1


def is_complete_checkpoint(path: Path) -> bool:
    """Whether the train state, written last, is there."""
    return (path / STATE_FILE).exists()


def latest_checkpoint(base: Union[str, Path]) -> Optional[Path]:
    """The newest complete step_* dir under `base` (for `resume_from: auto`)."""
    base = Path(base)
    if not base.exists():
        return None
    complete = [p for p in base.iterdir()
                if p.is_dir() and p.name.startswith("step_") and is_complete_checkpoint(p)]
    return max(complete, key=_step_number, default=None)


def prune_checkpoints(base: Union[str, Path], keep_last: int) -> int:
    """Keep the newest `keep_last` step_* dirs; returns how many went.
    Incomplete dirs sort oldest, so they go first and never push a complete
    checkpoint out of the kept set."""
    base = Path(base)
    if keep_last <= 0 or not base.exists():
        return 0
    candidates = sorted((p for p in base.iterdir() if p.is_dir() and p.name.startswith("step_")),
                        key=lambda p: (is_complete_checkpoint(p), _step_number(p)))
    stale = candidates[:-keep_last] if keep_last < len(candidates) else []
    for path in stale:
        shutil.rmtree(path)
    return len(stale)


class AsyncCheckpointWriter:
    """Writes checkpoints on a worker thread while the loop keeps stepping.

    `submit` copies the tensors to the host at once (the loop updates its
    parameters and optimizer state in place at the next step), then the
    worker serialises and writes. One save in flight at a time: a new submit
    waits for the previous one. Errors surface at the next submit or `wait`;
    call `wait` before reading a checkpoint or leaving."""

    def __init__(self) -> None:
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        self._pending = None

    def submit(self, directory: Union[str, Path], *, on_complete=None, **save_kwargs) -> None:
        """Queue `save_train_checkpoint(directory, **save_kwargs)`; then
        `on_complete()` on the worker, after the save has landed."""
        self.wait()
        save_kwargs = _to_host(save_kwargs)

        def save_then_complete():
            save_train_checkpoint(directory, **save_kwargs)
            if on_complete is not None:
                on_complete()

        self._pending = self._pool.submit(save_then_complete)

    def wait(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.wait()
        self._pool.shutdown(wait=True)
