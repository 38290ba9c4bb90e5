"""Multilayer RGBA samples: a background and its ordered component layers.

Counterpart of `ragb_vae_tpu/data/multilayer_dataset.py`. One directory per
sample holds `background.png` and `component_<i>.png` (or the same names with
a sample prefix); the composite is the layers alpha-composited over the
background in index order, and `multilayer_collate` pads the variable layer
stacks of a batch with masks. NHWC throughout.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from ragb_vae_tpu_torch.data.image_io import pil_to_array

# dataset roots, overridable through the environment
RENDERED_ROOT = Path(os.getenv("QIL_RENDERED_ROOT", "data/multilayer_rendered"))
JSON_ROOT = Path(os.getenv("QIL_JSON_ROOT", "data/multilayer_json"))


def _layer_index(path: Path) -> Optional[int]:
    """The numeric layer index of a component file (the last all-digit part
    of its stem), or None for a thumbnail or a name without one."""
    if "thumbnail" in path.name.lower():
        return None
    digits = [part for part in path.stem.split("_") if part.isdigit()]
    return int(digits[-1]) if digits else None


def resolve_background_path(sample_dir: Path) -> Path:
    for candidate in (sample_dir / "background.png", sample_dir / f"{sample_dir.name}_background.png"):
        if candidate.exists():
            return candidate
    for candidate in sorted(sample_dir.glob("*_background.png")):
        if "thumbnail" not in candidate.name.lower():
            return candidate
    raise FileNotFoundError(f"Background image not found in {sample_dir}")


def find_component_paths(sample_dir: Path) -> List[Path]:
    """The sample's component layers in index order, from the first of the
    three naming patterns (bare, sample-prefixed, any prefix) that matches."""
    for pattern in ("component_*.png", f"{sample_dir.name}_component_*.png", "*_component_*.png"):
        indexed = [(k, p) for p in sample_dir.glob(pattern) if (k := _layer_index(p)) is not None]
        if indexed:
            return [p for _, p in sorted(indexed, key=lambda kp: kp[0])]
    return []


def composite_layers(background: Image.Image, components: Sequence[Image.Image]) -> Image.Image:
    composite = background.convert("RGBA") if background.mode != "RGBA" else background.copy()
    for component in components:
        overlay = component if component.mode == "RGBA" else component.convert("RGBA")
        if overlay.size != composite.size:
            raise ValueError(f"Component size {overlay.size} does not match background {composite.size}")
        composite = Image.alpha_composite(composite, overlay)
    return composite


@dataclass
class MultiLayerSample:
    sample_dir: Path
    background: np.ndarray          # (H, W, 4)
    components: List[np.ndarray]    # each (H, W, 4)
    composite: np.ndarray           # (H, W, 4)
    layout: Dict[str, Any]
    visible_masks: List[np.ndarray]  # each (H, W) bool


class MultiLayerDataset:
    def __init__(
        self,
        rendered_root: Path = RENDERED_ROOT,
        json_root: Path = JSON_ROOT,
        alpha_threshold: int = 100,
        max_samples: Optional[int] = None,
    ) -> None:
        self.rendered_root = Path(rendered_root)
        self.json_root = Path(json_root)
        self.alpha_threshold = alpha_threshold
        if not self.rendered_root.exists():
            raise FileNotFoundError(f"Rendered root not found: {self.rendered_root}")
        self.sample_dirs = sorted(p for p in self.rendered_root.iterdir() if p.is_dir())[:max_samples]
        if not self.sample_dirs:
            raise FileNotFoundError(f"No sample directories under {self.rendered_root}")

    def __len__(self) -> int:
        return len(self.sample_dirs)

    def __getitem__(self, index: int) -> MultiLayerSample:
        sample_dir = self.sample_dirs[index]
        with Image.open(resolve_background_path(sample_dir)) as img:
            background = img.convert("RGBA")
        components = []
        for path in find_component_paths(sample_dir):
            with Image.open(path) as img:
                components.append(img.convert("RGBA"))
        json_path = self.json_root / f"{sample_dir.name}.json"
        layout: Dict[str, Any] = {"layout_config": {"components": []}}
        if json_path.exists():
            layout = json.loads(json_path.read_text(encoding="utf-8"))
        return MultiLayerSample(
            sample_dir=sample_dir,
            background=pil_to_array(background),
            components=[pil_to_array(c) for c in components],
            composite=pil_to_array(composite_layers(background, components)),
            layout=layout,
            visible_masks=[np.asarray(c, dtype=np.uint8)[..., 3] >= self.alpha_threshold for c in components],
        )


def multilayer_collate(batch: List[MultiLayerSample]) -> Dict[str, Any]:
    """Stack a batch, padding every layer stack with zero layers to the
    longest: components (B, L, H, W, 4), component_mask (B, L) (True for a
    real layer), visible_masks (B, L, H, W). A sample without layers gets one
    zero layer."""
    if not batch:
        return {}
    n_layers = max(len(item.components) for item in batch)
    components, visible, masks = [], [], []
    for item in batch:
        comps = item.components or [np.zeros_like(item.background)]
        vis = item.visible_masks or [np.zeros(item.background.shape[:2], dtype=bool)]
        pad = n_layers - len(comps)
        components.append(np.stack(comps + [np.zeros_like(comps[0])] * pad, axis=0))
        visible.append(np.stack(vis + [np.zeros_like(vis[0])] * pad, axis=0))
        masks.append(np.arange(n_layers) < len(item.components))
    return {
        "background": np.stack([item.background for item in batch], axis=0),
        "composite": np.stack([item.composite for item in batch], axis=0),
        "components": np.stack(components, axis=0),
        "component_mask": np.stack(masks, axis=0),
        "visible_masks": np.stack(visible, axis=0),
        "layout": [item.layout for item in batch],
        "sample_dirs": [str(item.sample_dir) for item in batch],
    }
