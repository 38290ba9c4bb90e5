"""FSDP of the frozen FLUX base over the data group (`--shard_base_params`).

Counterpart of `shard_tree(base, fsdp_sharding(base, mesh))` in the JAX LoRA
stage: each large frozen leaf is split over the "data" axis by JAX's leaf
rule (`parallel/sharding.py::spec_dim`: leaves of fewer than 2**16 elements
stay whole, any other is split on the first dim the axis size divides) and
GSPMD all-gathers it where it is used. The port runs one process per device
and makes the gathers itself:

- `shard_base_(transformer, mesh)` keeps this rank's contiguous 1/N of every
  leaf the rule splits (on whatever device the transformer lives, the meta
  device included) and records the plan on `transformer.fsdp`. The LoRA
  adapters are never split: they stay replicated and `ZeroAdamW` shards their
  optimizer state.
- The transformer runs each unit through `FsdpPlan.call`: a block, or one of
  the embedders, `norm_out` and `proj_out`. The unit's split leaves are
  all-gathered into fresh tensors (one all-gather per dtype of the unit, the
  shards concatenated in data-rank order along the dim the rule split), the
  unit runs on them through `torch.func.functional_call`, and they are
  dropped when it returns. `Parameter.data` is never swapped, so autograd's
  saved tensors keep their own storage.
- The gather sits inside the function that `torch.utils.checkpoint`
  recomputes (`FluxTransformer2D._run_block`), so the backward gathers the
  block again instead of keeping every block alive. Without gradient
  checkpointing autograd keeps each gathered block for the backward (a
  linear saves its weight to give its input's gradient) and FSDP saves
  little: the LoRA stage keeps recompute on.
- An int8 base (`weight_quant: int8`) goes through the same rule: `weight_q`
  is split like the float weight and gathered whole before K10 runs on it;
  its per-column `weight_scale` is split or whole by the rule on its own
  shape and, where split, gathered in the same call as `weight_q`.

Every rank gathers the same units in the same order (the forward, the
recompute, validation sampling), as the collectives require.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ragb_vae_tpu_torch.parallel import sharding
from ragb_vae_tpu_torch.parallel.mesh import Mesh, all_reduce

Tensor = torch.Tensor
Split = Tuple[int, Tuple[int, ...]]        # (split dim, full shape)

# collectives and bytes gathered since the last reset
COUNTS = {"all_gather": 0, "gathered_bytes": 0}

BLOCK_LISTS = ("transformer_blocks", "single_transformer_blocks")


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def unit_of(key: str) -> Tuple[str, str]:
    """(unit, key within it) of a transformer state-dict key: a block
    ("transformer_blocks.3") or a top-level module ("x_embedder")."""
    parts = key.split(".")
    n = 2 if parts[0] in BLOCK_LISTS else 1
    return ".".join(parts[:n]), ".".join(parts[n:])


def _is_adapter(key: str) -> bool:
    return key.rsplit(".", 1)[-1] in ("lora_A", "lora_B")


def _frozen_leaves(module: nn.Module) -> Iterator[Tuple[str, Tensor]]:
    for key, t in list(module.named_parameters()) + list(module.named_buffers()):
        if not _is_adapter(key):
            yield key, t


def _replace(module: nn.Module, key: str, value: Tensor) -> None:
    owner_name, leaf = key.rsplit(".", 1) if "." in key else ("", key)
    owner = module.get_submodule(owner_name)
    if leaf in owner._parameters:
        owner._parameters[leaf] = nn.Parameter(value, requires_grad=False)
    else:
        owner._buffers[leaf] = value


def _leaf(module: nn.Module, key: str) -> Tensor:
    owner_name, leaf = key.rsplit(".", 1) if "." in key else ("", key)
    return getattr(module.get_submodule(owner_name), leaf)


@dataclasses.dataclass
class FsdpPlan:
    """The split leaves of a transformer over the data axis `mesh`:
    {unit: {key within the unit: (split dim, full shape)}}."""

    mesh: Mesh
    min_size: int
    units: Dict[str, Dict[str, Split]] = dataclasses.field(default_factory=dict)

    def split_of(self, key: str) -> Optional[Split]:
        unit, rel = unit_of(key)
        return self.units.get(unit, {}).get(rel)

    def part(self, full: Tensor, dim: int) -> Tensor:
        """This rank's contiguous 1/N of `full` along `dim`."""
        per = full.shape[dim] // self.mesh.size
        return full.narrow(dim, self.mesh.rank * per, per)

    def take(self, key: str, full: Tensor) -> Tensor:
        """This rank's part of the unsplit entry `key` (the entry itself
        where the rule keeps it whole)."""
        split = self.split_of(key)
        return full if split is None else self.part(full, split[0])

    @torch.no_grad()
    def gathered(self, unit: str, module: nn.Module) -> Dict[str, Tensor]:
        """{key within the unit: the whole tensor} of the unit's split
        leaves: one all-gather per dtype, every rank's shards end to end in
        data-rank order along each leaf's split dim."""
        entries = self.units.get(unit)
        if not entries:
            return {}
        by_dtype: Dict[torch.dtype, List[Tuple[str, int, Tensor]]] = {}
        for rel, (dim, _) in entries.items():
            local = _leaf(module, rel)
            by_dtype.setdefault(local.dtype, []).append((rel, dim, local))
        out = {}
        for leaves in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for _, _, t in leaves])
            parts = [torch.empty_like(flat) for _ in range(self.mesh.size)]
            dist.all_gather(parts, flat, group=self.mesh.group)
            stacked = torch.stack(parts)
            COUNTS["all_gather"] += 1
            COUNTS["gathered_bytes"] += stacked.numel() * stacked.element_size()
            start = 0
            for rel, dim, local in leaves:
                n = local.numel()
                piece = stacked[:, start : start + n].reshape((self.mesh.size,) + tuple(local.shape))
                out[rel] = piece.movedim(0, dim).flatten(dim, dim + 1)
                start += n
        return out

    def call(self, unit: str, module: nn.Module, *args):
        """`module(*args)` on the unit's whole leaves, gathered for the call."""
        full = self.gathered(unit, module)
        if not full:
            return module(*args)
        return torch.func.functional_call(module, full, args)


@torch.no_grad()
def shard_base_(transformer: nn.Module, mesh: Mesh, min_size: Optional[int] = None) -> nn.Module:
    """Keep this rank's part of every frozen leaf of a built
    `FluxTransformer2D` that JAX's rule splits over the data axis `mesh`, and
    record the plan on `transformer.fsdp`. `min_size` defaults to
    `sharding.DEFAULT_MIN_SHARD_SIZE`, read at the call. Nothing happens at
    size 1. Tensor parallelism and FSDP of one base are exclusive."""
    if mesh.size == 1:
        return transformer
    if getattr(transformer, "fsdp", None) is not None:
        raise ValueError("the transformer's base is already FSDP-sharded")
    if transformer.tp.size > 1:
        raise ValueError("tensor_parallel and shard_base_params are mutually exclusive "
                         "(Megatron model-axis sharding vs FSDP data-axis sharding of the same frozen base)")
    plan = FsdpPlan(mesh, sharding.DEFAULT_MIN_SHARD_SIZE if min_size is None else int(min_size))
    leaves = dict(_frozen_leaves(transformer))
    dims = sharding.fsdp_sharding({k: t.shape for k, t in leaves.items()}, mesh.size, plan.min_size)
    for key, t in leaves.items():
        dim = dims[key]
        if dim is None:
            continue
        unit, rel = unit_of(key)
        plan.units.setdefault(unit, {})[rel] = (dim, tuple(t.shape))
        _replace(transformer, key, plan.part(t, dim).clone())
    transformer.fsdp = plan
    return transformer


@torch.no_grad()
def quantize_sharded_(transformer: nn.Module, device=None, dtype=None) -> nn.Module:
    """`quantize_module_` for an FSDP-sharded float transformer: each linear
    quantises its shard where it lives and ends with what the whole layer
    quantised and split by the rule gives, bit for bit. A shard of output
    rows has its own channels' scales; a shard of input columns takes the
    max over the data group (max is exact); the scale is then gathered or
    cut to what the rule makes of its own shape."""
    from ragb_vae_tpu_torch.models.flux_transformer import Fp32Linear, QLinear

    plan: FsdpPlan = transformer.fsdp
    mesh = plan.mesh
    for name, m in transformer.named_modules():
        if not isinstance(m, QLinear) or m.weight_quant == "int8":
            continue
        unit, rel = unit_of(f"{name}.weight")
        entries = plan.units.setdefault(unit, {})
        split = entries.pop(rel, None)
        dim_w = None if split is None else split[0]
        reduce_max = None
        if dim_w == 1:
            reduce_max = lambda absmax: all_reduce(absmax, mesh, op=dist.ReduceOp.MAX)   # noqa: E731
        m.quantize_(device, None if isinstance(m, Fp32Linear) else dtype, reduce_absmax=reduce_max)
        prefix = rel[: -len("weight")]
        if split is not None:
            entries[prefix + "weight_q"] = split
        dim_s = sharding.spec_dim((m.out_features,), mesh.size, plan.min_size)
        scale = m.weight_scale
        if dim_w == 0 and dim_s is None:        # this rank's channels -> the whole layer's
            parts = [torch.empty_like(scale) for _ in range(mesh.size)]
            dist.all_gather(parts, scale.contiguous(), group=mesh.group)
            m.weight_scale = torch.cat(parts)
        elif dim_w != 0 and dim_s == 0:          # whole -> this rank's part
            m.weight_scale = plan.part(scale, 0).clone()
        if dim_s is not None:
            entries[prefix + "weight_scale"] = (dim_s, (m.out_features,))
    transformer.weight_quant = "int8"
    return transformer


def shard_bytes(transformer: nn.Module) -> Dict[str, int]:
    """Bytes this rank holds of the frozen base: "split" (its parts of the
    split leaves), "whole" (the leaves the rule keeps whole) and "adapters"."""
    plan = getattr(transformer, "fsdp", None)
    out = {"split": 0, "whole": 0, "adapters": 0}
    for key, t in list(transformer.named_parameters()) + list(transformer.named_buffers()):
        kind = "adapters" if _is_adapter(key) else (
            "split" if plan is not None and plan.split_of(key) is not None else "whole")
        out[kind] += t.numel() * t.element_size()
    return out
