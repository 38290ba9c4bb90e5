"""Plain float32 FLUX `ae` (diffusers AutoencoderKL), its posterior, and the
AlphaVAE stage's losses with LPIPS-VGG16.

Written from diffusers' AutoencoderKL (GroupNorm 32 / SiLU resnet blocks, a
(0, 1) pad and stride-2 conv down, nearest 2x and conv up, one single-head
attention in each mid block) and the AlphaVAE stage's loss (Eq. 9
premultiplied reconstruction, LPIPS on the black and white composites, KL,
KL of the composites against a frozen reference). Reads state dicts under
diffusers' keys; images are NHWC, convolutions run on NCHW. Imports nothing
of the program.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.numerics import Numerics
from perfbench.reference.weights import LPIPS_SLICES

Tensor = torch.Tensor
State = Dict[str, Tensor]


class VaeReference:
    def __init__(self, P: State, cfg: dict, num: Numerics):
        self.P, self.cfg, self.num = P, cfg, num
        self.groups = cfg["norm_num_groups"]

    def _conv(self, x: Tensor, name: str, **kw) -> Tensor:
        return self.num.conv(x, self.P[f"{name}.weight"], self.P[f"{name}.bias"], **kw)

    def _gn(self, x: Tensor, name: str) -> Tensor:
        return F.group_norm(x, self.groups, self.P[f"{name}.weight"].float(), self.P[f"{name}.bias"].float(), eps=1e-6)

    def _resnet(self, x: Tensor, p: str) -> Tensor:
        h = self._conv(F.silu(self._gn(x, f"{p}.norm1")), f"{p}.conv1", padding=1)
        h = self._conv(F.silu(self._gn(h, f"{p}.norm2")), f"{p}.conv2", padding=1)
        if f"{p}.conv_shortcut.weight" in self.P:
            x = self._conv(x, f"{p}.conv_shortcut")
        return x + h

    def _attention(self, x: Tensor, p: str) -> Tensor:
        b, c, h, w = x.shape
        y = self._gn(x, f"{p}.group_norm").reshape(b, c, h * w).transpose(1, 2)
        q, k, v = (self.num.linear(y, self.P[f"{p}.{n}.weight"], self.P[f"{p}.{n}.bias"])
                   for n in ("to_q", "to_k", "to_v"))
        out = self.num.linear(self.num.attention(q, k, v), self.P[f"{p}.to_out.0.weight"], self.P[f"{p}.to_out.0.bias"])
        return x + out.transpose(1, 2).reshape(b, c, h, w)

    def _mid(self, x: Tensor, p: str) -> Tensor:
        x = self._resnet(x, f"{p}.resnets.0")
        if f"{p}.attentions.0.to_q.weight" in self.P:
            x = self._attention(x, f"{p}.attentions.0")
        return self._resnet(x, f"{p}.resnets.1")

    def encode(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        """NHWC in [-1, 1] -> (mean, logvar) NHWC, logvar clamped to [-30, 20]."""
        cfg = self.cfg
        h = self._conv(x.float().permute(0, 3, 1, 2), "encoder.conv_in", padding=1)
        n = len(cfg["block_out_channels"])
        for i in range(n):
            for j in range(cfg["layers_per_block"]):
                h = self._resnet(h, f"encoder.down_blocks.{i}.resnets.{j}")
            if i < n - 1:
                h = self._conv(F.pad(h, (0, 1, 0, 1)), f"encoder.down_blocks.{i}.downsamplers.0.conv", stride=2)
        h = self._mid(h, "encoder.mid_block")
        h = self._conv(F.silu(self._gn(h, "encoder.conv_norm_out")), "encoder.conv_out", padding=1)
        if "quant_conv.weight" in self.P:
            h = self._conv(h, "quant_conv")
        mean, logvar = h.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z: Tensor) -> Tensor:
        """NHWC latent -> NHWC image in about [-1, 1] (not clamped)."""
        cfg = self.cfg
        h = z.float().permute(0, 3, 1, 2)
        if "post_quant_conv.weight" in self.P:
            h = self._conv(h, "post_quant_conv")
        h = self._mid(self._conv(h, "decoder.conv_in", padding=1), "decoder.mid_block")
        n = len(cfg["block_out_channels"])
        for i in range(n):
            for j in range(cfg["layers_per_block"] + 1):
                h = self._resnet(h, f"decoder.up_blocks.{i}.resnets.{j}")
            if i < n - 1:
                h = self._conv(F.interpolate(h, scale_factor=2, mode="nearest"),
                               f"decoder.up_blocks.{i}.upsamplers.0.conv", padding=1)
        h = self._conv(F.silu(self._gn(h, "decoder.conv_norm_out")), "decoder.conv_out", padding=1)
        return h.permute(0, 2, 3, 1)


def sample(mean: Tensor, logvar: Tensor, eps: Tensor) -> Tensor:
    return mean + torch.exp(0.5 * logvar) * eps.float()


def kl(mean: Tensor, logvar: Tensor, other: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """(B,) KL summed over the non-batch axes, against N(0, 1) or `other`."""
    axes = tuple(range(1, mean.ndim))
    if other is None:
        return 0.5 * torch.sum(mean ** 2 + torch.exp(logvar) - 1.0 - logvar, dim=axes)
    o_mean, o_logvar = other
    o_var = torch.exp(o_logvar)
    return 0.5 * torch.sum((mean - o_mean) ** 2 / o_var + torch.exp(logvar) / o_var - 1.0 - logvar + o_logvar,
                           dim=axes)


# ---------------------------------------------------------------------------
# The AlphaVAE stage's loss
# ---------------------------------------------------------------------------
EB = (-0.0357, -0.0811, -0.1797)
EB2 = (0.3163, 0.3060, 0.3634)
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


def triplet(target: Tensor) -> Tensor:
    """(original, over black, over white) on the batch axis; the composites opaque."""
    fg = (1.0 + target[..., 3:4]) * 0.5
    bg = (1.0 - target[..., 3:4]) * 0.5
    one = torch.ones_like(target[..., 3:4])
    black = torch.cat([(target * fg - bg)[..., :3], one], dim=-1)
    white = torch.cat([(target * fg + bg)[..., :3], one], dim=-1)
    return torch.cat([target, black, white], dim=0)


def reconstruction(pred: Tensor, target: Tensor) -> Tensor:
    """(B,) per-pixel mean of AlphaVAE Eq. 9 on RGBA in [-1, 1]."""
    ta, pa = (target[..., 3:] + 1.0) * 0.5, (pred[..., 3:] + 1.0) * 0.5
    d = target[..., :3] * ta - pred[..., :3] * pa
    da = ta - pa
    eb = torch.tensor(EB, device=pred.device)
    eb2 = torch.tensor(EB2, device=pred.device)
    loss = d ** 2 - 2.0 * eb * d * da + eb2 * da ** 2
    return loss.reshape(loss.shape[0], -1).mean(dim=1)


def lpips_distance(x: Tensor, y: Tensor, L: State, num: Numerics) -> Tensor:
    """(B,) LPIPS-VGG16 between NHWC RGB inputs (y is data: no gradient)."""
    shift = torch.tensor(_LPIPS_SHIFT, device=x.device)
    scale = torch.tensor(_LPIPS_SCALE, device=x.device)

    def features(v: Tensor):
        h = ((v.float() - shift) / scale).permute(0, 3, 1, 2)
        out = []
        for convs in LPIPS_SLICES:
            for idx in convs:
                if idx in (5, 10, 17, 24):
                    h = F.max_pool2d(h, 2, 2)
                h = F.relu(num.conv(h, L[f"conv{idx}_weight"], L[f"conv{idx}_bias"], padding=1))
            out.append(h)
        return out

    fx = features(x)
    with torch.no_grad():
        fy = features(y)
    total = torch.zeros(x.shape[0], device=x.device)
    for k, (a, b) in enumerate(zip(fx, fy)):
        na = a / (torch.sqrt(torch.sum(a ** 2, dim=1, keepdim=True)) + 1e-10)
        nb = b / (torch.sqrt(torch.sum(b ** 2, dim=1, keepdim=True)) + 1e-10)
        total = total + torch.mean(torch.sum((na - nb) ** 2 * L[f"lin{k}"].float()[None, :, None, None], dim=1),
                                   dim=(1, 2))
    return total


def perceptual(pred: Tensor, target: Tensor, L: State, num: Numerics) -> Tensor:
    """(B,) LPIPS averaged over the black and the white composite."""
    ta, pa = (target[..., 3:] + 1.0) * 0.5, (pred[..., 3:] + 1.0) * 0.5
    tb, pb = target[..., :3] * ta, pred[..., :3] * pa
    tw, pw = tb + (1.0 - ta), pb + (1.0 - pa)
    b = pred.shape[0]
    d = lpips_distance(torch.cat([pb, pw]), torch.cat([tb, tw]), L, num)
    return 0.5 * (d[:b] + d[b:])


def alphavae_loss(vae: VaeReference, ref: VaeReference, L: State, images: Tensor, eps: Tensor, scales: dict
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """(B,) per-image total of the stage's loss on `images` (B, H, W, 4) in
    [0, 1], with the posterior draw `eps`; the batch's loss is their mean."""
    target = torch.clamp(images.float(), 0.0, 1.0) * 2.0 - 1.0
    mean, logvar = vae.encode(triplet(target))
    b = target.shape[0]
    pred = vae.decode(sample(mean[:b], logvar[:b], eps))
    terms = {"recon": reconstruction(pred, target)}
    total = terms["recon"]
    if scales["lpips_scale"] > 0:
        terms["lpips"] = perceptual(pred, target, L, vae.num)
        total = total + scales["lpips_scale"] * terms["lpips"]
    if scales["kl_scale"] > 0:
        terms["kl"] = kl(mean[:b], logvar[:b])
        total = total + scales["kl_scale"] * terms["kl"]
    if scales["ref_kl_scale"] > 0:
        with torch.no_grad():
            r_mean, r_logvar = ref.encode(triplet(target))
        terms["ref_kl"] = 0.5 * (kl(mean[b:2 * b], logvar[b:2 * b], (r_mean[b:2 * b], r_logvar[b:2 * b]))
                                 + kl(mean[2 * b:], logvar[2 * b:], (r_mean[2 * b:], r_logvar[2 * b:])))
        total = total + scales["ref_kl_scale"] * terms["ref_kl"]
    return total, terms
