"""HF-interoperable AutoencoderKL config (copy of
`ragb_vae_tpu/models/vae_config.py`; the port must not import the JAX package).

Field set mirrors the diffusers `AutoencoderKL` config consumed by the
reference (rgba_vae.py:249-255, flux_kontext_textalpha.py:233-235) so both
Flux (`ae` subfolder: latent 16, no quant convs, shift_factor) and
SD/Qwen-style (`vae` subfolder: latent 4, quant convs) checkpoints load from
their `config.json` unchanged.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional, Tuple, Union


@dataclasses.dataclass
class AutoencoderConfig:
    in_channels: int = 3
    out_channels: int = 3
    down_block_types: Tuple[str, ...] = ("DownEncoderBlock2D",) * 4
    up_block_types: Tuple[str, ...] = ("UpDecoderBlock2D",) * 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    act_fn: str = "silu"
    latent_channels: int = 16
    norm_num_groups: int = 32
    sample_size: int = 1024
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159
    mid_block_add_attention: bool = True
    use_quant_conv: bool = False
    use_post_quant_conv: bool = False
    force_upcast: bool = True

    @property
    def spatial_scale_factor(self) -> int:
        """Pixel->latent downscale: 2^(len(block_out_channels)-1).

        Matches `vae_scale_factor` at flux_kontext_textalpha.py:233.
        """
        return 2 ** (len(self.block_out_channels) - 1)

    @classmethod
    def flux(cls) -> "AutoencoderConfig":
        """The FLUX.1 `ae` operating point."""
        return cls()

    @classmethod
    def sd(cls) -> "AutoencoderConfig":
        """SD-style `vae`: latent 4 with quant convs."""
        return cls(
            latent_channels=4,
            scaling_factor=0.18215,
            shift_factor=0.0,
            sample_size=512,
            use_quant_conv=True,
            use_post_quant_conv=True,
        )

    @classmethod
    def tiny(cls, latent_channels: int = 4) -> "AutoencoderConfig":
        """Small config for tests: 2 blocks, 1 layer each, GN groups 4."""
        return cls(
            block_out_channels=(32, 64),
            down_block_types=("DownEncoderBlock2D",) * 2,
            up_block_types=("UpDecoderBlock2D",) * 2,
            layers_per_block=1,
            latent_channels=latent_channels,
            norm_num_groups=4,
            sample_size=64,
            scaling_factor=1.0,
            shift_factor=0.0,
        )

    @classmethod
    def from_json(cls, path: Union[str, Path]) -> "AutoencoderConfig":
        with Path(path).open("r", encoding="utf-8") as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in raw.items():
            if k not in known:
                continue
            if isinstance(v, list):
                v = tuple(v)
            kwargs[k] = v
        cfg = cls(**kwargs)
        if raw.get("shift_factor") is None:
            cfg.shift_factor = 0.0
        return cfg

    def to_json(self, path: Union[str, Path]) -> None:
        """Write a diffusers-compatible config.json (HF format export)."""
        d = dataclasses.asdict(self)
        d["down_block_types"] = list(d["down_block_types"])
        d["up_block_types"] = list(d["up_block_types"])
        d["block_out_channels"] = list(d["block_out_channels"])
        d["_class_name"] = "AutoencoderKL"
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with p.open("w", encoding="utf-8") as f:
            json.dump(d, f, indent=2)
