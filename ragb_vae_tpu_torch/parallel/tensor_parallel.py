"""Megatron tensor parallelism of the FLUX transformer over a model group.

Counterpart of `ragb_vae_tpu/parallel/tensor_parallel.py`. The JAX package
shards the parameter tree over a mesh "model" axis and lets GSPMD insert the
collectives; the port runs one process per device and each process holds its
shard of a built `FluxTransformer2D` (`shard_transformer_`) and makes the
collectives itself over the model group (a `parallel/mesh.py::Mesh`):

- the residual stream stays REPLICATED: every rank holds every token;
- attention q/k/v, the feed-forward up-projections and the MLP embedders'
  `linear_1` are COLUMN-parallel (rank r holds output channels
  [r * out / T, (r + 1) * out / T), so attention runs on its H / T heads);
- attention out, the feed-forward down-projections and the embedders'
  `linear_2` are ROW-parallel (rank r holds the input channels its column
  region produced); each rank's partial product is all-reduced over the group
  and the bias is added once, after the all-reduce;
- the AdaLN modulation linears are column-parallel for memory (3.25 B of
  FLUX.1's 11.9 B parameters, fp32) and their (B, n * dim) fp32 output is
  all-gathered before it is chunked into shift / scale / gate: a contiguous
  split of n * dim does not align with the chunks;
- the embedders and the final head are replicated (tiny).

Two conjugate autograd operators bound each region, as in Megatron:
`region_in` (identity forward, all-reduce of the input's gradient backward)
at a column region's input, and the row layer's `region_out` (all-reduce
forward, identity backward) at its output; `gather_last` all-gathers a
column-sharded output along its last axis (backward: this rank's slice of the
gradient). Every rank runs the same collectives in the same order, also in a
block's recompute under gradient checkpointing.

The all-reduce runs in the compute dtype: bf16 on the card. Each rank's
partial sum is rounded to bf16 before the reduce, so at T ranks the output
carries up to T + 1 roundings where the unsharded fp32 accumulation carries
one; reducing in fp32 would need fp32 outputs from K10 and from cuBLAS's bf16
GEMM, twice the bytes on the wire for a difference inside bf16's own noise.

The single-stream block's `proj_out` is row-parallel (as in JAX) but over
another index set: its input is cat([attn (dim), mlp (4 dim)]), and rank r
produces attention columns [r dim / T, (r + 1) dim / T) and MLP columns
[r 4dim / T, (r + 1) 4dim / T), so its row shard is exactly those rows of the
5 dim inputs, not a contiguous 5 dim / T (GSPMD reshards the activation to
JAX's contiguous rows instead).

LoRA adapters stay replicated (JAX: P()), but each rank uses its slice: on a
column layer all of A and rank r's rows of B, on a row layer rank r's columns
of A and all of B (the bypass is then part of the partial sum that the one
all-reduce covers). Every adapter gradient is therefore a partial that the
training step sums over the model group (`sum_grads_over`).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from ragb_vae_tpu_torch.parallel.mesh import Mesh, all_reduce

Tensor = torch.Tensor
Ranges = Tuple[Tuple[int, int], ...]

# Module names (the leaf of the port's module path, diffusers' own) whose
# weight (out, in) shards on the OUTPUT axis ...
COLUMN = {
    "to_q", "to_k", "to_v",
    "add_q_proj", "add_k_proj", "add_v_proj",
    "proj_mlp", "net.0.proj",
    "linear",            # AdaLayerNormZero / AdaLayerNormContinuous modulation
    "linear_1",          # MLPEmbedder up
}
# ... and on the INPUT axis (their input is the column region's sharded
# activation; one all-reduce closes the region).
ROW = {"to_out.0", "to_add_out", "net.2", "linear_2"}

# collectives made by the operators below since the last reset
COUNTS = {"all_reduce": 0, "all_gather": 0}


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def dense_kind(name: str) -> str:
    """"column", "row" or "replicated" for the linear at module path `name`
    (JAX `_dense_kind` over the port's names)."""
    if name.rsplit(".", 1)[-1] == "proj_out":
        # single_transformer_blocks.N.proj_out is the block's row-parallel
        # down-projection; the top-level proj_out head is tiny -> replicate
        return "row" if name.startswith("single_transformer_blocks.") else "replicated"
    for kind, names in (("column", COLUMN), ("row", ROW)):
        if any(name == n or name.endswith("." + n) for n in names):
            return kind
    return "replicated"


def leaf_kind(key: str) -> str:
    """The plan for one state-dict entry: "column" (sharded on its first
    axis: a column layer's weight, weight_q, bias and weight_scale), "row" (a
    row layer's weight or weight_q, sharded on its input axis) or
    "replicated" (everything else: a row layer's bias and scale, the LoRA
    adapters, the norms, the replicated linears). Counterpart of JAX's
    `transformer_param_specs`: P(None, model) / P(model) -> "column",
    P(model, None) -> "row", P() -> "replicated"."""
    module, leaf = key.rsplit(".", 1)
    if leaf in ("lora_A", "lora_B"):
        return "replicated"
    kind = dense_kind(module)
    if kind == "row" and leaf in ("weight", "weight_q"):
        return "row"
    if kind == "column" and leaf in ("weight", "weight_q", "bias", "weight_scale"):
        return "column"
    return "replicated"


def shard_ranges(name: str, kind: str, full: int, dim: int, size: int, rank: int) -> Ranges:
    """(start, length) pieces of the `full` channels that `rank` of `size`
    holds on the sharded axis. Contiguous 1/size, except the single-stream
    block's proj_out: its rank's attention rows and MLP rows (see the module
    docstring)."""
    if kind == "row" and name.startswith("single_transformer_blocks.") and name.endswith(".proj_out"):
        attn, mlp = dim // size, 4 * dim // size
        return ((rank * attn, attn), (dim + rank * mlp, mlp))
    per = full // size
    return ((rank * per, per),)


def take(t: Tensor, dim: int, ranges: Ranges) -> Tensor:
    """The pieces `ranges` of `t` along `dim`, end to end (works on the meta
    device too)."""
    parts = [t.narrow(dim, start, length) for start, length in ranges]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


# ---------------------------------------------------------------------------
# The degree
# ---------------------------------------------------------------------------
def validate_tp(config, tp: int, *, cuda: bool = False, weight_quant: str = "none") -> None:
    """Raise, naming the degree, when `tp` does not divide the heads or, on
    the card (`cuda`), when a shard misses the kernels' checks: K3 / K4 / K5
    take head dim 128 (and B * H <= 65535), K10 needs K % 16 and N % 8 on
    every int8 shard. FLUX.1 (24 heads) allows 1, 2, 3, 4, 6, 8, 12, 24."""
    tp = int(tp)
    heads, dim = config.num_attention_heads, config.inner_dim
    if tp < 1 or heads % tp:
        allowed = [d for d in range(1, heads + 1) if heads % d == 0]
        raise ValueError(f"tensor_parallel={tp} must divide the {heads} attention heads: one of {allowed}")
    if tp == 1 or not cuda:
        return
    if config.attention_head_dim != 128:
        raise ValueError(f"tensor_parallel={tp}: the attention kernels on the card take head dim 128, "
                         f"got {config.attention_head_dim}")
    if weight_quant == "int8":
        # (K, N) of every sharded int8 product: column shards cut N, row shards K
        shards = [(dim, dim // tp), (dim, 4 * dim // tp), (dim, 6 * dim // tp), (dim, 2 * dim // tp),
                  (256, dim // tp), (config.pooled_projection_dim, dim // tp),
                  (dim // tp, dim), (4 * dim // tp, dim), (5 * dim // tp, dim)]
        for k, n in shards:
            if k % 16 or n % 8:
                raise ValueError(f"tensor_parallel={tp}: an int8 shard of K={k}, N={n} misses the int8 "
                                 "matmul's K % 16 == 0 and N % 8 == 0")


# ---------------------------------------------------------------------------
# The collectives as autograd operators
# ---------------------------------------------------------------------------
def _reduce(t: Tensor, mesh: Mesh) -> Tensor:
    COUNTS["all_reduce"] += 1
    return all_reduce(t.contiguous(), mesh)


class _RegionIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.clone(), ctx.mesh), None


class _RegionOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh):
        return _reduce(y, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather(t: Tensor, mesh: Mesh) -> Tensor:
    """Every rank's `t` end to end along the last axis, in rank order."""
    COUNTS["all_gather"] += 1
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=-1)


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh, ctx.width = mesh, t.shape[-1]
        return _gather(t, mesh)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g[..., ctx.mesh.rank * w : (ctx.mesh.rank + 1) * w].contiguous(), None


def region_in(x: Tensor, mesh: Mesh) -> Tensor:
    """A column region's input: x forward, the gradient all-reduced over the
    model group backward (each rank's column shard gives a partial one)."""
    return x if mesh.size == 1 else _RegionIn.apply(x, mesh)


def region_out(y: Tensor, mesh: Mesh) -> Tensor:
    """A row layer's output: the partial sums all-reduced forward, the
    gradient passed through backward."""
    return y if mesh.size == 1 else _RegionOut.apply(y, mesh)


def gather_last(t: Tensor, mesh: Mesh) -> Tensor:
    """A column layer's output shards end to end along the last axis."""
    return t if mesh.size == 1 else _GatherLast.apply(t, mesh)


# ---------------------------------------------------------------------------
# Sharding a built transformer
# ---------------------------------------------------------------------------
def linear_plan(transformer) -> List[Tuple[str, object, str]]:
    """(name, module, kind) of every linear of `transformer`, in module order."""
    from ragb_vae_tpu_torch.models.flux_transformer import QLinear

    return [(name, m, dense_kind(name)) for name, m in transformer.named_modules() if isinstance(m, QLinear)]


@torch.no_grad()
def shard_transformer_(transformer, mesh: Mesh):
    """Slice a built `FluxTransformer2D` in place to this rank's shard over
    the model axis `mesh` (on whatever device it lives, the meta device
    included). Returns the transformer."""
    from ragb_vae_tpu_torch.models import flux_transformer as ft

    cfg = transformer.config
    validate_tp(cfg, mesh.size)
    if mesh.size == 1:
        return transformer
    dim = cfg.inner_dim
    for name, m, kind in linear_plan(transformer):
        if kind != "replicated":
            full = m.out_features if kind == "column" else m.in_features
            m.shard_(mesh, kind, shard_ranges(name, kind, full, dim, mesh.size, mesh.rank))
    for m in transformer.modules():
        if isinstance(m, (ft.JointAttention, ft.SingleAttention)):
            m.heads = cfg.num_attention_heads // mesh.size
        if isinstance(m, (ft.JointAttention, ft.FeedForward, ft.MLPEmbedder, ft.AdaLayerNormZero,
                          ft.AdaLayerNormContinuous, ft.FluxSingleTransformerBlock, ft.FluxTransformer2D)):
            m.tp = mesh
    return transformer


def shard_state_entry(transformer, key: str, full: Tensor) -> Tensor:
    """This rank's part of the unsharded entry `key` of a sharded
    transformer's state dict (the entry itself where it is replicated)."""
    module, leaf = key.rsplit(".", 1)
    m = transformer.get_submodule(module)
    return m.shard_of(leaf, full) if hasattr(m, "shard_of") else full


def sum_grads_over(params: Sequence[Tensor], mesh: Mesh) -> None:
    """Sum the `.grad` of `params` over the model group, in one all-reduce
    of one flat fp32 buffer (a parameter without a gradient counts as zeros
    and gets the sum): the adapters' gradients are partials on each rank."""
    if mesh.size == 1 or not params:
        return
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
                      for p in params])
    _reduce(flat, mesh)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset : offset + n].view(p.shape).to(p.dtype)
        offset += n


def shard_bytes(transformer) -> int:
    """Bytes of the transformer's parameters and buffers on this rank."""
    return sum(t.numel() * t.element_size() for t in list(transformer.parameters()) + list(transformer.buffers()))



