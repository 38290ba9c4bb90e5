"""YAML config loading with `${env:VAR}` expansion.

The port's copy of `ragb_vae_tpu/config.py`: nested `{data, training, model}`
dicts read with `yaml.safe_load`, environment variables expanded through the
whole tree, and dtype names mapped to `torch` dtypes.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Dict, Union

import torch
import yaml

_ENV_PATTERN = re.compile(r"\$\{env:([A-Za-z_][A-Za-z0-9_]*)\}")

_DTYPES = {
    None: torch.float32,
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "fp16": torch.float16,
}


def resolve_env(value: Any) -> Any:
    """Expand `${env:VAR}` in every string of a nested dict / list; an unset
    variable is an error."""
    if isinstance(value, str):
        def repl(match: "re.Match[str]") -> str:
            resolved = os.environ.get(match.group(1))
            if resolved is None:
                raise ValueError(f"Environment variable '{match.group(1)}' required by config is not set.")
            return resolved

        return _ENV_PATTERN.sub(repl, value)
    if isinstance(value, dict):
        return {k: resolve_env(v) for k, v in value.items()}
    if isinstance(value, list):
        return [resolve_env(v) for v in value]
    return value


def load_config(path: Union[str, Path]) -> Dict[str, Any]:
    with Path(path).open("r", encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict):
        raise ValueError(f"Config {path} must be a mapping, got {type(cfg).__name__}.")
    return resolve_env(cfg)


def dtype_from_str(name: Any) -> torch.dtype:
    """Config dtype string -> torch dtype (None is fp32)."""
    if name not in _DTYPES:
        raise ValueError(f"Unknown dtype '{name}'.")
    return _DTYPES[name]
