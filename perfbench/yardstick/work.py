"""The work a roofline is taken against: operations and bytes computed from
the configuration's shapes, whatever kernel does them, with the card's
peaks, and the device-kernel classes the trace is split by.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit): 989 TFLOP/s
bf16 on the tensor cores, 3.35 TB/s of HBM3. A roofline's least time is
max(ops / peak, bytes / bandwidth), with each input byte read once and each
output byte written once.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}
PEAK_HBM_BYTES = {"NVIDIA H100 80GB HBM3": 3.35e12}
BF16 = 2


def peak_flops(kind: str) -> Optional[float]:
    return PEAK_BF16_FLOPS.get(kind)


def peak_bytes(kind: str) -> Optional[float]:
    return PEAK_HBM_BYTES.get(kind)


def least_time(ops: float, nbytes: float, kind: str) -> Optional[float]:
    flops, bw = peak_flops(kind), peak_bytes(kind)
    if flops is None or bw is None:
        return None
    return max(ops / flops, nbytes / bw)


# ---------------------------------------------------------------------------
# Attention: softmax(q k^T / sqrt(d)) v over (batch, heads, seq, d)
# ---------------------------------------------------------------------------
def attention_fwd(batch: int, heads: int, seq: int, d: int) -> Tuple[float, float]:
    """(ops, bytes): q k^T and p v; q, k, v read, o written, in bf16."""
    ops = 2 * 2.0 * batch * heads * seq * seq * d
    nbytes = 4.0 * batch * heads * seq * d * BF16
    return ops, nbytes


def attention_bwd(batch: int, heads: int, seq: int, d: int) -> Tuple[float, float]:
    """(ops, bytes) the gradient needs: dV = P^T dO, dP = dO V^T, dQ = dS K,
    dK = dS^T Q (twice the forward's products; the recompute of P is the
    kernel's choice and not counted); q, k, v, o, dO and the fp32 row
    statistics read, dQ, dK, dV written."""
    ops = 4 * 2.0 * batch * heads * seq * seq * d
    nbytes = 8.0 * batch * heads * seq * d * BF16 + batch * heads * seq * 4
    return ops, nbytes


def flux_attention_calls(cfg: dict, img_seq: int, txt_seq: int) -> Tuple[int, int, int, int]:
    """(calls, heads, seq, d) of one transformer forward for one sample."""
    return (cfg["num_layers"] + cfg["num_single_layers"], cfg["num_attention_heads"], img_seq + txt_seq,
            cfg["attention_head_dim"])


def vae_mid_attention(cfg: dict, size: int) -> Tuple[int, int, int, int]:
    """(calls, heads, seq, d) of the mid block's attention for one image of
    `size`^2 through the encoder or the decoder."""
    scale = 2 ** (len(cfg["block_out_channels"]) - 1)
    return 1, 1, (size // scale) ** 2, cfg["block_out_channels"][-1]


# ---------------------------------------------------------------------------
# The resnet blocks' 3x3 convolutions (with their 1x1 projection)
# ---------------------------------------------------------------------------
def _block_work(h: int, w: int, cin: int, cout: int) -> Tuple[float, float]:
    """(ops, bytes) of one resnet block's two 3x3 convs and its 1x1 skip on
    one image: each conv reads its input and weights and writes its output;
    the second also reads the skip input."""
    ops = 2.0 * h * w * 9 * (cin * cout + cout * cout)
    nbytes = (h * w * cin + h * w * cout + 9 * cin * cout) * BF16          # conv1
    nbytes += (h * w * cout + h * w * cout + 9 * cout * cout + h * w * cin) * BF16  # conv2 + skip
    if cin != cout:
        ops += 2.0 * h * w * cin * cout
        nbytes += cin * cout * BF16
    return ops, nbytes


def resnet_blocks(cfg: dict, size: int, part: str) -> List[Tuple[float, float, bool]]:
    """(ops, bytes, in_stack) per resnet block of the encoder or the decoder
    for one image; `in_stack` marks the down / up stacks' blocks (the ones
    gradient checkpointing recomputes), not the mid block's."""
    ch = list(cfg["block_out_channels"])
    layers = cfg["layers_per_block"]
    out: List[Tuple[float, float, bool]] = []
    if part == "encoder":
        h = size
        for i, cout in enumerate(ch):
            cin = ch[max(i - 1, 0)]
            for j in range(layers):
                out.append((*_block_work(h, h, cin if j == 0 else cout, cout), True))
            if i < len(ch) - 1:
                h //= 2
        out += [(*_block_work(h, h, ch[-1], ch[-1]), False)] * 2
        return out
    rev = list(reversed(ch))
    h = size // 2 ** (len(ch) - 1)
    out += [(*_block_work(h, h, rev[0], rev[0]), False)] * 2
    for i, cout in enumerate(rev):
        cin = rev[max(i - 1, 0)]
        for j in range(layers + 1):
            out.append((*_block_work(h, h, cin if j == 0 else cout, cout), True))
        if i < len(rev) - 1:
            h *= 2
    return out


# ---------------------------------------------------------------------------
# Kernel classes (first match wins), from the kernel names the program's
# sources give their __global__ functions
# ---------------------------------------------------------------------------
def _engine(mode: int) -> re.Pattern:
    return re.compile(rf"conv_sm90_kernel<(\(int\))?{mode}>")


KERNEL_CLASSES: List[Tuple[str, re.Pattern]] = [
    ("k1_resnet_conv", _engine(3)),
    ("k2_subpixel_up", _engine(4)),
    ("k6_dx", _engine(2)),
    ("k7_dx", _engine(5)),
    ("k7_dw", re.compile(r"wgrad_sm90_kernel<(\(int\))?2>")),
    ("k6_dw", re.compile(r"wgrad_sm90_kernel")),
    ("k6_k7_slice_sum", re.compile(r"sum_slices_kernel")),
    ("k6_dskip", _engine(6)),
    ("k6_k7_dye", re.compile(r"dye_kernel|reduce_rows_kernel")),
    ("stats_reduce", re.compile(r"stats_reduce_kernel")),
    ("k8_wino_conv", re.compile(r"wino_conv_kernel")),
    ("k8_wino_act", re.compile(r"wino_act_kernel")),
    ("k9_k11_conv_engine", re.compile(r"conv_sm90_kernel")),
    ("k3_attention", re.compile(r"flash_fwd|flash_merge_kernel")),
    ("k4_attention_dq", re.compile(r"flash_dq_kernel")),
    ("k5_attention_dkv", re.compile(r"flash_dkv_kernel")),
    ("k10_int8_matmul", re.compile(r"int8_wgmma_kernel|int8_gemv_kernel")),
    ("nccl", re.compile(r"nccl", re.I)),
    ("cudnn_conv", re.compile(r"fprop|dgrad|wgrad|cudnn|convolve|winograd|implicit_gemm", re.I)),
    ("cublas_gemm", re.compile(r"gemm|gemv|xmma|cutlass|nvjet|cublas|sm90_xmma", re.I)),
]
ELEMENTWISE = "pytorch_elementwise"


def kernel_class(name: str) -> str:
    for label, pattern in KERNEL_CLASSES:
        if pattern.search(name):
            return label
    return ELEMENTWISE


def class_seconds(kernels: Sequence[Tuple[str, float, float]]) -> Dict[str, float]:
    """Device seconds by kernel class."""
    out: Dict[str, float] = {}
    for name, _, dur in kernels:
        label = kernel_class(name)
        out[label] = out.get(label, 0.0) + dur
    return out
