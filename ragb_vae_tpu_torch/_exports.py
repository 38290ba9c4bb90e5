"""Lazy package-level re-exports (PEP 562).

Each subpackage of the port exports, under the JAX package's names, the
counterparts of what its JAX twin's `__init__.py` re-exports. The modules
behind them load on first use, so `import ragb_vae_tpu_torch.ops.rgba` does
not load the FLUX stack, and no package import can close a cycle.
"""
from __future__ import annotations

import importlib
import sys
from typing import Callable, Dict, List, Tuple


def lazy_exports(package: str, exports: Dict[str, str]) -> Tuple[Callable, Callable]:
    """(`__getattr__`, `__dir__`) of `package`, which re-exports each name of
    `exports` from the module it maps to (`"module"`, or `"module:attr"`
    where the package's name differs from the module's). A name is looked
    up once and then kept in the package."""

    def __getattr__(name: str):
        target = exports.get(name)
        if target is None:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        module, _, attr = target.partition(":")
        value = getattr(importlib.import_module(module), attr or name)
        setattr(sys.modules[package], name, value)
        return value

    def __dir__() -> List[str]:
        return sorted(set(vars(sys.modules[package])) | set(exports))

    return __getattr__, __dir__
