"""LPIPS perceptual loss (VGG16 backbone).

Counterpart of `ragb_vae_tpu/models/lpips.py`: torchvision VGG16 feature
slices, channel-unit-normalised activations, squared differences through
the learned 1x1 "lin" heads, spatial mean, layer sum. Public functions take
NHWC tensors, as the JAX package's do; the convolutions are PyTorch's own
(the JAX package leaves them to XLA too).

Weights come from a saved `lpips.LPIPS(net="vgg").state_dict()` (.pt or
.safetensors). Without weights the perceptual term is disabled.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ragb_vae_tpu_torch.models.losses import perceptual_composites, weighted_batch_mean
from ragb_vae_tpu_torch.models.weights import load_torch_state

Tensor = torch.Tensor

# torchvision vgg16.features conv indices per LPIPS slice (the lpips vgg16
# wrapper keeps the original Sequential indices inside each slice)
_SLICES: List[List[int]] = [[0, 2], [5, 7], [10, 12, 14], [17, 19, 21], [24, 26, 28]]
_POOL_BEFORE = {5, 10, 17, 24}  # a maxpool sits before these convs
_SLICE_CHANNELS = (64, 128, 256, 512, 512)

# lpips ScalingLayer constants: input in [-1, 1]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    """Frozen VGG16 slices and lin heads. Conv weights are OIHW buffers
    `conv{idx}_weight` / `conv{idx}_bias`; lin heads are (C,) non-negative
    channel weights `lin{k}`."""

    def __init__(self, convs: Mapping[int, Mapping[str, Tensor]], lins: Sequence[Tensor]):
        super().__init__()
        for idx, entry in convs.items():
            self.register_buffer(f"conv{idx}_weight", entry["weight"].float().contiguous())
            self.register_buffer(f"conv{idx}_bias", entry["bias"].float().contiguous())
        for k, lin in enumerate(lins):
            self.register_buffer(f"lin{k}", lin.float().reshape(-1).contiguous())
        self.register_buffer("shift", torch.tensor(_SHIFT))
        self.register_buffer("scale", torch.tensor(_SCALE))

    def _run_slice(self, h: Tensor, slice_idx: int, compute_dtype) -> Tensor:
        for idx in _SLICES[slice_idx]:
            if idx in _POOL_BEFORE:
                h = F.max_pool2d(h, 2, 2)
            w = getattr(self, f"conv{idx}_weight")
            b = getattr(self, f"conv{idx}_bias")
            if compute_dtype is not None:
                w, b = w.to(compute_dtype), b.to(compute_dtype)
            h = F.relu(F.conv2d(h, w, b, padding=1))
        return h

    def features(self, x: Tensor, *, remat: bool = True, compute_dtype=None) -> List[Tensor]:
        """VGG16 features of NHWC `x` -> the five slice outputs (post-ReLU),
        NHWC. remat=True checkpoints each slice: the backward recomputes one
        slice's conv activations at a time instead of keeping all 13.
        `compute_dtype` runs the convs at that dtype; None keeps fp32."""
        h = x.permute(0, 3, 1, 2)
        if compute_dtype is not None:
            h = h.to(compute_dtype)
        outputs = []
        for k in range(len(_SLICES)):
            if remat and torch.is_grad_enabled() and h.requires_grad:
                h = checkpoint(self._run_slice, h, k, compute_dtype, use_reentrant=False)
            else:
                h = self._run_slice(h, k, compute_dtype)
            outputs.append(h.permute(0, 2, 3, 1))
        return outputs


def _normalize_tensor(feat: Tensor, eps: float = 1e-10) -> Tensor:
    norm = torch.sqrt(torch.sum(feat**2, dim=-1, keepdim=True))
    return feat / (norm + eps)


def lpips_distance(
    pred: Tensor, target: Tensor, model: LPIPS, *, compute_dtype=None, remat: bool = True
) -> Tensor:
    """Per-sample LPIPS distance, inputs NHWC RGB in [-1, 1] -> (B,).

    The value is symmetric in (pred, target); the gradient is not: `target`
    is detached (it is data), so its stream keeps nothing for a backward."""
    x_in = (pred.float() - model.shift) / model.scale
    feats_x = model.features(x_in, remat=remat, compute_dtype=compute_dtype)
    with torch.no_grad():
        y_in = (target.float() - model.shift) / model.scale
        feats_y = model.features(y_in, remat=False, compute_dtype=compute_dtype)
    total = torch.zeros(pred.shape[0], dtype=torch.float32, device=pred.device)
    for k, (fx, fy) in enumerate(zip(feats_x, feats_y)):
        diff = (_normalize_tensor(fx.float()) - _normalize_tensor(fy.float())) ** 2
        weighted = diff * getattr(model, f"lin{k}")
        total = total + torch.mean(torch.sum(weighted, dim=-1), dim=(1, 2))
    return total


def lpips_from_state(state: Mapping[str, Union[Tensor, np.ndarray]]) -> LPIPS:
    """Build from a `lpips.LPIPS(net='vgg').state_dict()`: conv keys
    `net.sliceK.N.weight` (full lpips dump) or `features.N.weight` (bare
    torchvision vgg16); lin heads `linK.model.1.weight` are optional (unit
    weights, the lpips baseline mode, when absent)."""
    state = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, Tensor) else v) for k, v in state.items()}
    convs: Dict[int, Dict[str, Tensor]] = {}
    for key, value in state.items():
        parts = key.split(".")
        idx: Optional[int] = None
        if parts[0] == "net" and parts[1].startswith("slice") and parts[-1] in ("weight", "bias"):
            idx = int(parts[2])
        elif parts[0] == "features" and parts[-1] in ("weight", "bias"):
            idx = int(parts[1])
        if idx is not None:
            convs.setdefault(idx, {})[parts[-1]] = value.float()
    needed = [i for s in _SLICES for i in s]
    missing = [i for i in needed if "weight" not in convs.get(i, {})]
    if missing:
        raise ValueError(f"LPIPS checkpoint is missing VGG conv layers {missing}.")
    lins = []
    for k, slice_convs in enumerate(_SLICES):
        lin = state.get(f"lin{k}.model.1.weight", state.get(f"lins.{k}.model.1.weight"))
        if lin is not None:
            lins.append(torch.clamp(lin.float().reshape(-1), min=0.0))
        else:
            # baseline mode SUMS the channel differences: unit weights, not 1/C
            lins.append(torch.ones(convs[slice_convs[-1]]["weight"].shape[0]))
    return LPIPS({i: convs[i] for i in needed}, lins)


def lpips_from_numpy_store(convs: Mapping[int, Mapping[str, np.ndarray]], lins: Sequence[np.ndarray]) -> LPIPS:
    """Build from the JAX package's flat numpy store (`LPIPSParams.convs`,
    HWIO kernels and biases, and `.lins`), so both packages hold one set of
    weights."""
    t_convs = {
        int(idx): {
            "weight": torch.from_numpy(np.ascontiguousarray(np.asarray(e["kernel"]).transpose(3, 2, 0, 1))),
            "bias": torch.from_numpy(np.asarray(e["bias"]).copy()),
        }
        for idx, e in convs.items()
    }
    return LPIPS(t_convs, [torch.from_numpy(np.asarray(l).copy()) for l in lins])


def random_lpips(seed: int = 0, *, device: Union[str, torch.device, None] = None) -> LPIPS:
    """VGG16-shaped weights drawn from a seed (He-scaled kernels, small
    biases, non-negative lin heads), for smoke runs and timings on a machine
    that holds no LPIPS checkpoint. The distances mean nothing perceptually;
    shapes, cost and gradient flow are those of the real network."""
    gen = torch.Generator().manual_seed(seed)
    convs: Dict[int, Dict[str, Tensor]] = {}
    lins = []
    c_in = 3
    for slice_convs, c_out in zip(_SLICES, _SLICE_CHANNELS):
        for idx in slice_convs:
            std = (2.0 / (9 * c_in)) ** 0.5
            convs[idx] = {"weight": torch.randn((c_out, c_in, 3, 3), generator=gen) * std,
                          "bias": torch.randn((c_out,), generator=gen) * 0.01}
            c_in = c_out
        lins.append(torch.rand((c_out,), generator=gen) * 0.1)
    return LPIPS(convs, lins).to(device)


def load_lpips_params(path: Union[str, Path]) -> LPIPS:
    """Import a torch `lpips.LPIPS(net='vgg').state_dict()` checkpoint file."""
    return lpips_from_state(load_torch_state(path))


def make_perceptual_loss(
    model: LPIPS, *, compute_dtype=None, remat: bool = True
) -> Callable[[Tensor, Tensor, Optional[Tensor]], Tensor]:
    """The training loop's perceptual term over RGBA inputs in [-1, 1]: LPIPS
    over the black and the white composite (fed unnormalised, as the
    reference does), both in ONE 2B-batch VGG pass per stream."""

    def perceptual_loss(pred: Tensor, target: Tensor, weights: Optional[Tensor] = None) -> Tensor:
        pred_black, target_black, pred_white, target_white = perceptual_composites(pred, target)
        bsz = pred.shape[0]
        d = lpips_distance(
            torch.cat([pred_black, pred_white], dim=0),
            torch.cat([target_black, target_white], dim=0),
            model, compute_dtype=compute_dtype, remat=remat,
        )
        return weighted_batch_mean(0.5 * (d[:bsz] + d[bsz:]), weights)

    return perceptual_loss


def maybe_build_lpips(
    weights_path: Optional[Union[str, Path]],
    *,
    compute_dtype=None,
    remat: bool = True,
    device: Union[str, torch.device, None] = None,
) -> Optional[Callable[[Tensor, Tensor, Optional[Tensor]], Tensor]]:
    """The perceptual term from a weights file, or None when there is none."""
    if not weights_path or not Path(weights_path).exists():
        return None
    model = load_lpips_params(weights_path).to(device)
    return make_perceptual_loss(model, compute_dtype=compute_dtype, remat=remat)
