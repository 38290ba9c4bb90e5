"""Weights drawn from a seed on the device, in a few large calls.

The benchmark, not the program, makes every weight. Each model is described
here by an ordered list of leaves (its diffusers state-dict key, its shape,
how it is initialised and which dtype group holds it); `draw_state` draws the
standard normals of each dtype group in one call from a `torch.Generator` on
the device, scales each leaf's view of that buffer to its init, and hands the
views back under the keys. The program's modules load those tensors
(`load_state_dict(assign=True)`); the reference draws the same tensors again
from the same seed and reads them. Nothing here imports the program.

Inits (the lecun-normal scale the program's own random init uses): a weight
N(0, 1/fan_in), a bias 0, a norm scale 1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    init: str            # "normal" (std), "zeros", "ones", "uniform" (values in [0, std))
    std: float = 1.0
    group: str = "model"  # dtype group: "model" (the served dtype) or "fp32"


def _linear(prefix: str, n_in: int, n_out: int, *, bias: bool = True, group: str = "model") -> List[Leaf]:
    out = [Leaf(f"{prefix}.weight", (n_out, n_in), "normal", 1.0 / math.sqrt(n_in), group)]
    if bias:
        out.append(Leaf(f"{prefix}.bias", (n_out,), "zeros", group=group))
    return out


def _conv(prefix: str, cin: int, cout: int, k: int = 3) -> List[Leaf]:
    return [Leaf(f"{prefix}.weight", (cout, cin, k, k), "normal", 1.0 / math.sqrt(cin * k * k)),
            Leaf(f"{prefix}.bias", (cout,), "zeros")]


def _norm(prefix: str, c: int, *, bias: bool = True) -> List[Leaf]:
    out = [Leaf(f"{prefix}.weight", (c,), "ones")]
    if bias:
        out.append(Leaf(f"{prefix}.bias", (c,), "zeros"))
    return out


# ---------------------------------------------------------------------------
# FLUX transformer (diffusers FluxTransformer2DModel keys)
# ---------------------------------------------------------------------------
def flux_leaves(cfg: dict) -> List[Leaf]:
    """The transformer's leaves. The AdaLN modulation linears (`*.norm*.linear`,
    `norm_out.linear`) are fp32 in the served model, the rest in the served dtype."""
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    hd = cfg["attention_head_dim"]
    out_ch = cfg.get("out_channels") or cfg["in_channels"]
    leaves = _linear("x_embedder", cfg["in_channels"], d) + _linear("context_embedder", cfg["joint_attention_dim"], d)
    embedders = ["timestep_embedder"] + (["guidance_embedder"] if cfg["guidance_embeds"] else [])
    for e in embedders:
        leaves += _linear(f"time_text_embed.{e}.linear_1", 256, d) + _linear(f"time_text_embed.{e}.linear_2", d, d)
    leaves += (_linear("time_text_embed.text_embedder.linear_1", cfg["pooled_projection_dim"], d)
               + _linear("time_text_embed.text_embedder.linear_2", d, d))
    for i in range(cfg["num_layers"]):
        p = f"transformer_blocks.{i}"
        leaves += _linear(f"{p}.norm1.linear", d, 6 * d, group="fp32")
        leaves += _linear(f"{p}.norm1_context.linear", d, 6 * d, group="fp32")
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0", "to_add_out"):
            leaves += _linear(f"{p}.attn.{name}", d, d)
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            leaves += _norm(f"{p}.attn.{name}", hd, bias=False)
        for ff in ("ff", "ff_context"):
            leaves += _linear(f"{p}.{ff}.net.0.proj", d, 4 * d) + _linear(f"{p}.{ff}.net.2", 4 * d, d)
    for i in range(cfg["num_single_layers"]):
        p = f"single_transformer_blocks.{i}"
        leaves += _linear(f"{p}.norm.linear", d, 3 * d, group="fp32")
        leaves += _linear(f"{p}.proj_mlp", d, 4 * d)
        for name in ("to_q", "to_k", "to_v"):
            leaves += _linear(f"{p}.attn.{name}", d, d)
        leaves += _norm(f"{p}.attn.norm_q", hd, bias=False) + _norm(f"{p}.attn.norm_k", hd, bias=False)
        leaves += _linear(f"{p}.proj_out", 5 * d, d)
    leaves += _linear("norm_out.linear", d, 2 * d, group="fp32") + _linear("proj_out", d, out_ch)
    return leaves


LORA_TARGETS = ("to_q", "to_k", "to_v", "to_out.0", "add_q_proj", "add_k_proj", "add_v_proj", "to_add_out",
                "net.0.proj", "net.2")


def lora_leaves(cfg: dict, rank: int) -> List[Leaf]:
    """The adapters' A matrices (N(0, 1/rank), as peft's gaussian init) of every
    target linear of the blocks, in module order; each B starts at 0."""
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    leaves: List[Leaf] = []
    shapes = {"net.0.proj": (d, 4 * d), "net.2": (4 * d, d)}

    def add(prefix: str, name: str) -> None:
        n_in, n_out = shapes.get(name, (d, d))
        leaves.append(Leaf(f"{prefix}.{name}.lora_A", (rank, n_in), "normal", 1.0 / rank, "fp32"))
        leaves.append(Leaf(f"{prefix}.{name}.lora_B", (n_out, rank), "zeros", group="fp32"))

    for i in range(cfg["num_layers"]):
        p = f"transformer_blocks.{i}"
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0", "to_add_out"):
            add(f"{p}.attn", name)
        for ff in ("ff", "ff_context"):
            add(f"{p}.{ff}", "net.0.proj")
            add(f"{p}.{ff}", "net.2")
    for i in range(cfg["num_single_layers"]):
        for name in ("to_q", "to_k", "to_v"):
            add(f"single_transformer_blocks.{i}.attn", name)
    return leaves


# ---------------------------------------------------------------------------
# The FLUX `ae` (diffusers AutoencoderKL keys)
# ---------------------------------------------------------------------------
def _resnet(prefix: str, cin: int, cout: int) -> List[Leaf]:
    out = _norm(f"{prefix}.norm1", cin) + _conv(f"{prefix}.conv1", cin, cout)
    out += _norm(f"{prefix}.norm2", cout) + _conv(f"{prefix}.conv2", cout, cout)
    if cin != cout:
        out += _conv(f"{prefix}.conv_shortcut", cin, cout, k=1)
    return out


def _mid(prefix: str, c: int, attention: bool) -> List[Leaf]:
    out = _resnet(f"{prefix}.resnets.0", c, c)
    if attention:
        a = f"{prefix}.attentions.0"
        out += _norm(f"{a}.group_norm", c)
        for name in ("to_q", "to_k", "to_v", "to_out.0"):
            out += _linear(f"{a}.{name}", c, c)
    return out + _resnet(f"{prefix}.resnets.1", c, c)


def vae_leaves(cfg: dict) -> List[Leaf]:
    ch = list(cfg["block_out_channels"])
    lat = cfg["latent_channels"]
    layers = cfg["layers_per_block"]
    attn = cfg.get("mid_block_add_attention", True)
    leaves = _conv("encoder.conv_in", cfg["in_channels"], ch[0])
    for i, cout in enumerate(ch):
        cin = ch[max(i - 1, 0)]
        for j in range(layers):
            leaves += _resnet(f"encoder.down_blocks.{i}.resnets.{j}", cin if j == 0 else cout, cout)
        if i < len(ch) - 1:
            leaves += _conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", cout, cout)
    leaves += _mid("encoder.mid_block", ch[-1], attn)
    leaves += _norm("encoder.conv_norm_out", ch[-1]) + _conv("encoder.conv_out", ch[-1], 2 * lat)
    rev = list(reversed(ch))
    leaves += _conv("decoder.conv_in", lat, rev[0]) + _mid("decoder.mid_block", rev[0], attn)
    for i, cout in enumerate(rev):
        cin = rev[max(i - 1, 0)]
        for j in range(layers + 1):
            leaves += _resnet(f"decoder.up_blocks.{i}.resnets.{j}", cin if j == 0 else cout, cout)
        if i < len(rev) - 1:
            leaves += _conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", cout, cout)
    leaves += _norm("decoder.conv_norm_out", rev[-1]) + _conv("decoder.conv_out", rev[-1], cfg["out_channels"])
    if cfg.get("use_quant_conv"):
        leaves += _conv("quant_conv", 2 * lat, 2 * lat, k=1)
    if cfg.get("use_post_quant_conv"):
        leaves += _conv("post_quant_conv", lat, lat, k=1)
    return leaves


# ---------------------------------------------------------------------------
# LPIPS-VGG16 (the program's LPIPS buffer names)
# ---------------------------------------------------------------------------
LPIPS_SLICES = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
LPIPS_CHANNELS = (64, 128, 256, 512, 512)


def lpips_leaves() -> List[Leaf]:
    """VGG16-shaped convs at He scale, small biases, non-negative lin heads."""
    leaves: List[Leaf] = []
    cin = 3
    for convs, cout in zip(LPIPS_SLICES, LPIPS_CHANNELS):
        for idx in convs:
            leaves.append(Leaf(f"conv{idx}_weight", (cout, cin, 3, 3), "normal", math.sqrt(2.0 / (9 * cin)), "fp32"))
            leaves.append(Leaf(f"conv{idx}_bias", (cout,), "normal", 0.01, "fp32"))
            cin = cout
    for k, cout in enumerate(LPIPS_CHANNELS):
        leaves.append(Leaf(f"lin{k}", (cout,), "uniform", 0.1, "fp32"))
    return leaves


# ---------------------------------------------------------------------------
# Drawing
# ---------------------------------------------------------------------------
def draw_state(leaves: Sequence[Leaf], seed: int, device, dtypes: Dict[str, torch.dtype],
               *, stream: int = 0) -> Dict[str, Tensor]:
    """{key: tensor} of `leaves` on `device`: per dtype group one normal draw and
    one uniform draw, each a single call of a generator seeded with
    (seed, stream); every leaf is a view of its group's buffer. The same
    arguments give the same tensors on the same device."""
    gen = torch.Generator(device).manual_seed(_mix(seed, stream))
    out: Dict[str, Tensor] = {}
    for group in sorted({leaf.group for leaf in leaves}):
        dtype = dtypes[group]
        mine = [leaf for leaf in leaves if leaf.group == group]
        for init, fill in (("normal", torch.randn), ("uniform", torch.rand)):
            drawn = [leaf for leaf in mine if leaf.init == init]
            total = sum(math.prod(leaf.shape) for leaf in drawn)
            if not total:
                continue
            flat = fill(total, generator=gen, device=device, dtype=dtype)
            offset = 0
            for leaf in drawn:
                n = math.prod(leaf.shape)
                out[leaf.name] = flat[offset:offset + n].view(leaf.shape).mul_(leaf.std)
                offset += n
        for leaf in mine:
            if leaf.init == "zeros":
                out[leaf.name] = torch.zeros(leaf.shape, device=device, dtype=dtype)
            elif leaf.init == "ones":
                out[leaf.name] = torch.ones(leaf.shape, device=device, dtype=dtype)
    return {leaf.name: out[leaf.name] for leaf in leaves}


def _mix(seed: int, stream: int) -> int:
    """A generator seed for (seed, stream): seeds up to 2**63 stay distinct per stream."""
    return (int(seed) * 1_000_003 + int(stream) * 7_919) % (2**63 - 1)


def draw_like(seed: int, stream: int, shape: Iterable[int], device, dtype=torch.float32,
              kind: str = "normal") -> Tensor:
    """One tensor of inputs (prompt embeddings, images) from (seed, stream)."""
    gen = torch.Generator(device).manual_seed(_mix(seed, stream))
    fill = torch.randn if kind == "normal" else torch.rand
    return fill(tuple(shape), generator=gen, device=device, dtype=dtype)


def param_count(leaves: Sequence[Leaf], group: Optional[str] = None) -> int:
    return sum(math.prod(leaf.shape) for leaf in leaves if group is None or leaf.group == group)
