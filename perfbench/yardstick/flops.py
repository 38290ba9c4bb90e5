"""Model tensor-core FLOP counts: a frozen copy of the program's
`ops/flops.py` walks (conv and matmul work only, recompute excluded), so a
change to the program cannot move the yardstick. Configurations are read as
attribute objects (`as_config(dict)`). A test holds these counts equal to the
program's module at the time of copying.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Tuple


def as_config(d: dict) -> SimpleNamespace:
    """A configuration dict as the attribute object the walks read."""
    ns = SimpleNamespace(**d)
    if "num_attention_heads" in d:
        ns.inner_dim = d["num_attention_heads"] * d["attention_head_dim"]
    return ns


def _conv(h: int, w: int, cin: int, cout: int, k: int = 3) -> float:
    """Multiply-add pairs counted as 2 FLOPs, at OUTPUT resolution h x w."""
    return 2.0 * h * w * cin * cout * k * k


def _resnet(h: int, w: int, cin: int, cout: int) -> float:
    f = _conv(h, w, cin, cout) + _conv(h, w, cout, cout)
    if cin != cout:
        f += _conv(h, w, cin, cout, k=1)
    return f


def _mid_attention(h: int, w: int, c: int) -> float:
    seq = h * w
    proj = 4 * 2.0 * seq * c * c          # q, k, v, out projections
    scores = 2 * 2.0 * seq * seq * c      # qk^T and attn @ v
    return proj + scores


def _mid_block(h: int, w: int, c: int) -> float:
    return 2 * _resnet(h, w, c, c) + _mid_attention(h, w, c)


def _hw(size) -> Tuple[int, int]:
    """Accept an int (square) or an (h, w) tuple (reference bucket shapes)."""
    if isinstance(size, (tuple, list)):
        return int(size[0]), int(size[1])
    return int(size), int(size)


def vae_encode_flops(config, size) -> float:
    """Tensor-core FLOPs for one image of `size`^2 through the encoder."""
    ch = list(config.block_out_channels)
    h, w = _hw(size)
    f = _conv(h, w, config.in_channels, ch[0])
    cin = ch[0]
    for i, cout in enumerate(ch):
        for j in range(config.layers_per_block):
            f += _resnet(h, w, cin if j == 0 else cout, cout)
        cin = cout
        if i < len(ch) - 1:
            h, w = h // 2, w // 2
            f += _conv(h, w, cout, cout)  # strided downsample, output res
    f += _mid_block(h, w, ch[-1])
    f += _conv(h, w, ch[-1], 2 * config.latent_channels)
    return f


def vae_decode_flops(config, size) -> float:
    """Tensor-core FLOPs for one latent decoded back to `size`^2."""
    ch = list(reversed(config.block_out_channels))
    n_down = len(ch) - 1
    h0, w0 = _hw(size)
    h, w = h0 // (2 ** n_down), w0 // (2 ** n_down)
    f = _conv(h, w, config.latent_channels, ch[0])
    f += _mid_block(h, w, ch[0])
    cin = ch[0]
    for i, cout in enumerate(ch):
        for j in range(config.layers_per_block + 1):
            f += _resnet(h, w, cin if j == 0 else cout, cout)
        cin = cout
        if i < len(ch) - 1:
            h, w = h * 2, w * 2
            f += _conv(h, w, cout, cout)  # post-nearest-upsample conv
    f += _conv(h, w, ch[-1], config.out_channels)
    return f


def vae_forward_flops(config, size) -> float:
    """Encode + decode tensor-core FLOPs per image."""
    return vae_encode_flops(config, size) + vae_decode_flops(config, size)


def vgg16_feature_flops(size, in_channels: int = 3) -> float:
    """Tensor-core FLOPs for ONE VGG16 feature pass (13 convs, through relu5_3).

    The LPIPS backbone (models/lpips.py:_SLICES): conv pairs at full res,
    then pool-halved stages. The learned "lin" heads are per-channel
    elementwise weights, not matmuls — excluded like all elementwise work.
    """
    stages = [  # (n_convs_at_this_res, cin_of_first, cout)
        (2, in_channels, 64),
        (2, 64, 128),
        (3, 128, 256),
        (3, 256, 512),
        (3, 512, 512),
    ]
    f = 0.0
    h, w = _hw(size)
    for i, (n, cin, cout) in enumerate(stages):
        if i > 0:
            h, w = h // 2, w // 2
        f += _conv(h, w, cin, cout)
        f += (n - 1) * _conv(h, w, cout, cout)
    return f


def vae_train_step_flops(
    config, size, *, lpips: bool = True
) -> float:
    """MODEL tensor-core FLOPs per image of one RGBA-VAE training step.

    Mirrors training/vae_step.py:compute_vae_loss at the bench operating
    point (kl on, ref_kl off, lpips_scale 0.5):
      forward   = 3x encode (detail-augmented triplet) + 1x decode
                  + 4x VGG16 (black & white composites, pred AND target
                    streams — maybe_build_lpips batches them but the
                    per-image conv work is 4 passes)
      backward  = 2x the (encode+decode) forward (dx + dW convs; the
                  black/white encode streams ride the same batched convs,
                  so their dW/dx work is scheduled even where cotangents
                  are zero)
                + 2x VGG16 (pred streams only, dx only: the VGG weights
                  are frozen closure constants and `target` is detached,
                  so no dW and no target-stream backward)

    This is the standard MFU convention: required model FLOPs, EXCLUDING
    remat/checkpoint recomputation (that extra work counts toward HFU,
    not MFU — reporting it would flatter the utilization number).
    """
    enc = vae_encode_flops(config, size)
    dec = vae_decode_flops(config, size)
    f = 3.0 * (3.0 * enc + dec)  # fwd + 2x bwd
    if lpips:
        vgg = vgg16_feature_flops(size)
        f += 4.0 * vgg + 2.0 * vgg
    return f


def flux_transformer_flops(config, img_seq: int, txt_seq: int) -> float:
    """Tensor-core FLOPs for ONE FluxTransformer2D forward pass (batch 1).

    Walks models/flux_transformer.py exactly: x/context embedders,
    `num_layers` double-stream blocks (per-stream q/k/v/out projections +
    joint attention over txt+img + per-stream 4x-GELU FeedForward +
    AdaLayerNormZero 6d modulation), `num_single_layers` single-stream
    blocks (qkv + parallel 4d MLP + fused (d+4d)->d out projection +
    3d modulation) on the concatenated sequence, and the
    AdaLayerNormContinuous head. RoPE/RMSNorm/softmax are elementwise work and
    excluded, consistent with the VAE walk above.
    """
    d = config.inner_dim
    s = img_seq + txt_seq
    mm = lambda m, k, n: 2.0 * m * k * n

    f = mm(img_seq, config.in_channels, d)            # x_embedder
    f += mm(txt_seq, config.joint_attention_dim, d)   # context_embedder
    # CombinedTimestepEmbeddings: timestep (+guidance) sinusoidal-256 MLPs
    # and the pooled-text MLP, each in->d->d; seq-independent, tiny
    n_sin = 2 if config.guidance_embeds else 1
    f += n_sin * (mm(1, 256, d) + mm(1, d, d))
    f += mm(1, config.pooled_projection_dim, d) + mm(1, d, d)

    attn = 2.0 * mm(s, d, s)  # qk^T + attn@v (scores at head_dim sum to d)
    for _ in range(config.num_layers):
        f += 4.0 * mm(img_seq, d, d) + 4.0 * mm(txt_seq, d, d)  # q,k,v,out per stream
        f += attn
        f += 2.0 * mm(img_seq, d, 4 * d) + 2.0 * mm(txt_seq, d, 4 * d)  # FeedForward
        f += 2.0 * mm(1, d, 6 * d)  # AdaLayerNormZero (img + txt)
    for _ in range(config.num_single_layers):
        f += 3.0 * mm(s, d, d)       # qkv
        f += attn
        f += mm(s, d, 4 * d)         # proj_mlp
        f += mm(s, 5 * d, d)         # proj_out on concat([attn, mlp])
        f += mm(1, d, 3 * d)         # AdaLayerNormZero(n=3)
    out_ch = getattr(config, "out_channels", None) or config.in_channels
    f += mm(1, d, 2 * d)             # norm_out head
    f += mm(img_seq, d, out_ch)      # proj_out
    return f


def textalpha_sample_flops(
    t_config,
    vae_config,
    size: int,
    steps: int,
    txt_seq: int,
) -> float:
    """Tensor-core FLOPs per image for FluxTextAlphaModel.sample (batch 1).

    One cond-image VAE encode, `steps` transformer forwards over the
    packed cond+target token sequence (img_seq = 2*(size/16)^2 — Kontext
    in-context conditioning doubles the image stream, as
    `FluxTextAlphaModel` packs it), one VAE decode.
    """
    img_seq = 2 * (size // 16) ** 2
    f = vae_encode_flops(vae_config, size)
    f += steps * flux_transformer_flops(t_config, img_seq, txt_seq)
    f += vae_decode_flops(vae_config, size)
    return f


def lora_train_step_flops(t_config, img_seq: int, txt_seq: int) -> float:
    """MODEL tensor-core FLOPs per sample of one frozen-base LoRA training step.

    forward = one transformer pass. backward: every frozen dense needs
    only dx (one same-size GEMM — dW against frozen weights is dead), the
    LoRA adapters' own dW is O(rank/d) and ignored, and attention backward
    needs dq/dk/dv/dscores (2x its forward matmul FLOPs). The blanket
    "bwd = 2x fwd" rule for full fine-tuning therefore over-counts; this
    walk splits the terms. Remat recompute excluded (MFU convention, see
    vae_train_step_flops).
    """
    d = t_config.inner_dim
    s = img_seq + txt_seq
    mm = lambda m, k, n: 2.0 * m * k * n
    attn = 2.0 * mm(s, d, s)

    dense_fwd = 0.0
    dense_fwd += mm(img_seq, t_config.in_channels, d)
    dense_fwd += mm(txt_seq, t_config.joint_attention_dim, d)
    attn_fwd = 0.0
    for _ in range(t_config.num_layers):
        dense_fwd += 4.0 * mm(img_seq, d, d) + 4.0 * mm(txt_seq, d, d)
        dense_fwd += 2.0 * mm(img_seq, d, 4 * d) + 2.0 * mm(txt_seq, d, 4 * d)
        dense_fwd += 2.0 * mm(1, d, 6 * d)
        attn_fwd += attn
    for _ in range(t_config.num_single_layers):
        dense_fwd += 3.0 * mm(s, d, d) + mm(s, d, 4 * d) + mm(s, 5 * d, d)
        dense_fwd += mm(1, d, 3 * d)
        attn_fwd += attn
    out_ch = getattr(t_config, "out_channels", None) or t_config.in_channels
    dense_fwd += mm(img_seq, d, out_ch) + mm(1, d, 2 * d)
    return 2.0 * dense_fwd + 3.0 * attn_fwd
