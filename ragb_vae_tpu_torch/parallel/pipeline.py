"""Pipeline parallelism of the FLUX transformer (`--pp N`).

Counterpart of `ragb_vae_tpu/parallel/pipeline.py`. The 19 double and 38
single blocks are cut into contiguous stages, each stage's parameters live
on ONE device, and microbatches stream through the stages. Per boundary only
the activation carrier `(img, txt, temb)` moves; there are no collectives.

One process drives every stage, as JAX's single controller does (tensor
parallelism, `parallel/tensor_parallel.py`, runs one process per device
instead). CUDA launches are asynchronous per device and a hop
`.to(stage_device, non_blocking=True)` is ordered after the work that made
its source, so while nothing in the loop waits on the host, stage s on
microbatch m runs beside stage s-1 on microbatch m+1. The bubble is the
usual (n_stages - 1) / (n_microbatches + n_stages - 1). Every stage runs
under its device's guard, and every kernel launch of the port makes its
tensor's device current (`ops/kernels/_build.py::launch`).

Stage boundaries balance FLOPs (`stage_ranges`): a double block weighs two
single blocks, the embedders ride the first stage and the AdaLN head the
last. A stage is an `nn.Module` over the SAME block modules as the
`FluxTransformer2D` it was placed from, under their global names, so its
state dict is a key subset of the transformer's and the pipelined forward at
microbatch = batch is the monolithic one bit for bit on one device.

Differences from the JAX package, on purpose:

- the loop-invariant inputs (pooled projection, timestep, guidance, ids) are
  moved to each stage's device once per call, not through a bounded cache
  keyed by `id()` (which exists in JAX only to bound a leak);
- training recomputes each stage under `torch.utils.checkpoint`, which
  keeps only the stage's input carrier (JAX's stage-level remat); autograd
  carries the cotangent back across devices.
"""
from __future__ import annotations

import contextlib
from functools import reduce
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ragb_vae_tpu_torch.models.flux_kontext_textalpha import per_sample_loss
from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformer2D, FluxTransformerConfig, rope_frequencies

Tensor = torch.Tensor

FIRST_KEYS = ("x_embedder", "context_embedder", "time_text_embed")
LAST_KEYS = ("norm_out", "proj_out")


def stage_ranges(config: FluxTransformerConfig, n_stages: int) -> List[Tuple[range, range]]:
    """FLOP-balanced contiguous (double_blocks, single_blocks) per stage.

    Blocks are laid out double-then-single (the model's execution order);
    a double block weighs 2 single blocks. Every stage gets at least one
    block; boundaries never split a block."""
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}.")
    n_double, n_single = config.num_layers, config.num_single_layers
    if n_stages > n_double + n_single:
        raise ValueError(f"n_stages={n_stages} exceeds the {n_double + n_single} blocks.")
    weights = [2.0] * n_double + [1.0] * n_single
    # greedy cut: close a stage once its weight reaches the remaining average
    ranges: List[Tuple[range, range]] = []
    start, acc, remaining = 0, 0.0, sum(weights)
    for idx, w in enumerate(weights):
        acc += w
        stages_left = n_stages - len(ranges)
        blocks_left = n_double + n_single - idx - 1
        if (acc >= remaining / stages_left and blocks_left >= stages_left - 1) or (
            blocks_left == stages_left - 1
        ):
            end = idx + 1
            d = range(min(start, n_double), min(end, n_double))
            s = range(max(start - n_double, 0), max(end - n_double, 0))
            ranges.append((d, s))
            remaining -= acc
            acc = 0.0
            start = end
            if len(ranges) == n_stages:
                break
    return ranges


def _stage_prefixes(ranges: Sequence[Tuple[range, range]], s: int) -> Tuple[str, ...]:
    """The module names (state-dict key prefixes) stage `s` holds."""
    dr, sr = ranges[s]
    names = FIRST_KEYS if s == 0 else ()
    names += tuple(f"transformer_blocks.{i}" for i in dr)
    names += tuple(f"single_transformer_blocks.{i}" for i in sr)
    return names + (LAST_KEYS if s == len(ranges) - 1 else ())


def split_transformer_params(state: Dict[str, Tensor], config: FluxTransformerConfig,
                             n_stages: int) -> List[Dict[str, Tensor]]:
    """The transformer's state dict (dotted names) cut into one dict per
    stage; every key lands in exactly one, and a key of no stage raises."""
    ranges = stage_ranges(config, n_stages)
    owner = {p: s for s in range(n_stages) for p in _stage_prefixes(ranges, s)}
    out: List[Dict[str, Tensor]] = [{} for _ in range(n_stages)]
    for key, value in state.items():
        parts = key.split(".")
        prefix = ".".join(parts[:2]) if parts[0].endswith("transformer_blocks") else parts[0]
        if prefix not in owner:
            raise KeyError(f"{key} belongs to no pipeline stage")
        out[owner[prefix]][key] = value
    return out


class PipelineStage(nn.Module):
    """One contiguous slice of a `FluxTransformer2D`, over its own modules.

    The first stage embeds (x, context, time and text), every stage runs its
    block range, the last applies the AdaLN head and `proj_out`. Blocks keep
    their global names (`transformer_blocks.3`, ...), so `state_dict()` is a
    key subset of the transformer's. RoPE is recomputed from the ids on every
    stage instead of crossing the boundaries."""

    def __init__(self, transformer: FluxTransformer2D, double_blocks: Sequence[int],
                 single_blocks: Sequence[int], is_first: bool, is_last: bool):
        super().__init__()
        self.config = transformer.config
        self.is_first, self.is_last = is_first, is_last
        if is_first:
            for name in FIRST_KEYS:
                setattr(self, name, getattr(transformer, name))
        self.transformer_blocks = nn.ModuleDict(
            {str(i): transformer.transformer_blocks[i] for i in double_blocks})
        self.single_transformer_blocks = nn.ModuleDict(
            {str(i): transformer.single_transformer_blocks[i] for i in single_blocks})
        if is_last:
            for name in LAST_KEYS:
                setattr(self, name, getattr(transformer, name))

    @staticmethod
    def join(txt: Tensor, img: Tensor) -> Tensor:
        """The single blocks' joint stream: txt first, as in the monolithic forward."""
        return torch.cat([txt, img], dim=1)

    @staticmethod
    def split(x: Tensor, n_txt: int) -> Tuple[Tensor, Tensor]:
        """The joint stream back into (txt, img) at a stage's end."""
        return x[:, :n_txt], x[:, n_txt:]

    def forward(self, img: Tensor, txt: Tensor, temb: Optional[Tensor], pooled: Tensor, timestep: Tensor,
                guidance: Optional[Tensor], img_ids: Tensor, txt_ids: Tensor):
        """First stage: img (B, S_img, in_channels) packed latents, txt
        (B, S_txt, joint_attention_dim), temb ignored. Others: the carrier.
        -> the next carrier (img, txt, temb), or on the last stage the
        prediction (B, S_img, out_channels)."""
        if self.is_first:
            img = self.x_embedder(img)
            txt = self.context_embedder(txt)
            temb = self.time_text_embed(timestep, guidance, pooled)
        rope = rope_frequencies(torch.cat([txt_ids, img_ids], dim=0), self.config.axes_dims_rope)
        for block in self.transformer_blocks.values():
            img, txt = block(img, txt, temb, rope)
        if len(self.single_transformer_blocks):
            segments = (txt.shape[1], img.shape[1])
            x = self.join(txt, img)
            for block in self.single_transformer_blocks.values():
                x = block(x, temb, rope, None, segments)
            txt, img = self.split(x, segments[0])
        if self.is_last:
            return self.proj_out(self.norm_out(img, temb).to(self.proj_out.compute_dtype))
        return img, txt, temb


def _device_guard(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _has_meta(module: nn.Module) -> bool:
    return any(t.is_meta for t in (*module.parameters(), *module.buffers()))


class PipelinedFluxTransformer:
    """The FLUX transformer as an n-stage pipeline, one device per stage
    (devices may repeat: on one card every stage can sit on `cuda:0`).

        pipe = PipelinedFluxTransformer(config, ["cuda:0", "cuda:1"]).place_(transformer)
        pred = pipe(hidden_states=..., ..., microbatch=2)

    `place_` moves each stage's modules of a built transformer to its device
    in place (a transformer on the meta device is materialised there,
    uninitialised); the transformer keeps owning them. The prediction comes
    back on the first stage's device, `self.device`."""

    def __init__(self, config: FluxTransformerConfig, devices: Sequence):
        if len(devices) < 1:
            raise ValueError("Need at least one device.")
        self.config = config
        self.devices = [torch.device(d) for d in devices]
        self.n_stages = len(self.devices)
        self.ranges = stage_ranges(config, self.n_stages)
        self.stages: List[PipelineStage] = []

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def stage_modules(self, transformer: FluxTransformer2D, s: int) -> List[nn.Module]:
        """The top-level modules of `transformer` that stage `s` holds."""
        return [transformer.get_submodule(name) for name in _stage_prefixes(self.ranges, s)]

    def place_(self, transformer: FluxTransformer2D) -> "PipelinedFluxTransformer":
        """Put each stage's modules of `transformer` on its device and build
        the stages over them."""
        if transformer.config != self.config:
            raise ValueError("the transformer's config is not the pipeline's")
        if transformer.tp.size > 1 or transformer.fsdp is not None:
            raise ValueError("a pipeline stage holds whole blocks: the transformer is sharded (TP or FSDP)")
        for s, device in enumerate(self.devices):
            for module in self.stage_modules(transformer, s):
                if _has_meta(module):
                    module.to_empty(device=device)
                else:
                    module.to(device)
        n = self.n_stages
        self.stages = [PipelineStage(transformer, dr, sr, s == 0, s == n - 1)
                       for s, (dr, sr) in enumerate(self.ranges)]
        return self

    @staticmethod
    def carry(carrier, device: torch.device):
        """The stage-boundary hop: the carrier to the next stage's device."""
        return tuple(None if t is None else t.to(device, non_blocking=True) for t in carrier)

    def microbatches(self, *, hidden_states: Tensor, encoder_hidden_states: Tensor, pooled_projections: Tensor,
                     timestep: Tensor, img_ids: Tensor, txt_ids: Tensor, guidance: Optional[Tensor] = None,
                     microbatch: int = 1, remat: bool = False):
        """Yield (rows, prediction) per microbatch, each microbatch's whole
        chain issued before the next; the prediction lies on the last
        stage's device. `remat`: each stage under `torch.utils.checkpoint`
        (only its input carrier is kept for the backward)."""
        if not self.stages:
            raise RuntimeError("place_() a transformer on the pipeline first")
        b = hidden_states.shape[0]
        if microbatch < 1 or b % microbatch:
            raise ValueError(f"batch {b} not divisible by microbatch {microbatch}.")
        # the loop-invariant inputs, on each stage's device once per call
        consts = {}
        for device in self.devices:
            if device not in consts:
                consts[device] = tuple(None if t is None else t.to(device, non_blocking=True)
                                       for t in (pooled_projections, timestep, guidance, img_ids, txt_ids))
        for m in range(b // microbatch):
            rows = slice(m * microbatch, (m + 1) * microbatch)
            carrier = (hidden_states[rows], encoder_hidden_states[rows], None)
            for stage, device in zip(self.stages, self.devices):
                pooled, ts, g, ids_img, ids_txt = consts[device]
                args = (*self.carry(carrier, device), pooled[rows], ts[rows],
                        None if g is None else g[rows], ids_img, ids_txt)
                with _device_guard(device):
                    if remat:
                        carrier = checkpoint(stage, *args, use_reentrant=False, preserve_rng_state=False)
                    else:
                        carrier = stage(*args)
            yield rows, carrier

    def __call__(self, *, hidden_states: Tensor, encoder_hidden_states: Tensor, pooled_projections: Tensor,
                 timestep: Tensor, img_ids: Tensor, txt_ids: Tensor, guidance: Optional[Tensor] = None,
                 seq=None, microbatch: int = 1) -> Tensor:
        """The monolithic forward's signature plus `microbatch` (rows per
        microbatch; it must divide the batch). `seq` (sequence parallelism)
        is not taken."""
        if seq is not None:
            raise ValueError("a pipeline stage runs the whole sequence: sequence parallelism is not taken")
        outs = [pred.to(self.device, non_blocking=True) for _, pred in self.microbatches(
            hidden_states=hidden_states, encoder_hidden_states=encoder_hidden_states,
            pooled_projections=pooled_projections, timestep=timestep, img_ids=img_ids, txt_ids=txt_ids,
            guidance=guidance, microbatch=microbatch)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)


def stage_bytes(transformer: FluxTransformer2D, n_stages: int) -> List[int]:
    """Bytes of parameters and buffers each of `n_stages` stages would hold
    of `transformer` (the meta device will do)."""
    pipe = PipelinedFluxTransformer(transformer.config, ["meta"] * n_stages)
    return [sum(t.numel() * t.element_size() for m in pipe.stage_modules(transformer, s)
                for t in (*m.parameters(), *m.buffers()))
            for s in range(n_stages)]


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
def pipelined_sample_latents(model, pipe: PipelinedFluxTransformer, cond_latent: Tensor, init_noise: Tensor,
                             step_noises: Tensor, *, microbatch: int = 1) -> Tensor:
    """`model.sample_latents_from_noise` with the transformer pipelined: all
    noise is injected, the per-step re-noising quirk is kept, and the loop is
    the monolithic one."""
    return model.sample_latents_from_noise(
        cond_latent, init_noise, step_noises, transformer=lambda **kw: pipe(**kw, microbatch=microbatch))


def pipelined_sample(model, pipe: PipelinedFluxTransformer, gt: Tensor, *, num_inference_steps: int = 20,
                     generator: Optional[torch.Generator] = None, microbatch: int = 1) -> Tensor:
    """`model.sample` with the transformer pipelined: the same draws from
    `generator` in the same order, so a seed gives the answer it gives
    without the pipeline."""
    return model.sample(gt, num_inference_steps=num_inference_steps, generator=generator,
                        transformer=lambda **kw: pipe(**kw, microbatch=microbatch))


# ---------------------------------------------------------------------------
# training: GPipe over the stages
# ---------------------------------------------------------------------------
def _adapters(stage: nn.Module) -> Dict[str, nn.Parameter]:
    return {n: p for n, p in stage.named_parameters() if n.rsplit(".", 1)[-1] in ("lora_A", "lora_B")}


def loss_numerator(pred: Tensor, loss_target: Tensor, weighting: Tensor, w: Tensor, seq_cond: int,
                   latent_h: int, latent_w: int) -> Tensor:
    """sum_i w_i * mean(weighting_i * (pred_target_i - target_i)^2) in fp32,
    as `compute_loss_from_latents` computes its weighted sum; the caller
    divides by the global weight sum."""
    return (per_sample_loss(pred, loss_target, weighting, seq_cond, latent_h, latent_w) * w).sum()


def pipelined_lora_loss_and_grads(
    pipe: PipelinedFluxTransformer, *, hidden_states: Tensor, encoder_hidden_states: Tensor,
    pooled_projections: Tensor, timestep: Tensor, img_ids: Tensor, txt_ids: Tensor, guidance: Optional[Tensor],
    loss_target: Tensor, weighting: Tensor, weights: Tensor, seq_cond: int, latent_h: int, latent_w: int,
    microbatch: int = 1,
) -> Tuple[Tensor, List[Dict[str, Tensor]]]:
    """GPipe forward and backward over the stages -> (loss, per-stage adapter
    gradients by global name).

    Every microbatch runs forward with each stage recomputed in the backward
    (only each stage's input carrier is kept); each contributes the NUMERATOR
    of the weighted mean (fp32), and its gradients accumulate in the
    adapters' `.grad`, cleared first. The division by the clamped global
    weight sum happens once, at the end, on the loss and on every gradient,
    so the microbatch split cannot perturb the weighted mean. The base must
    be frozen (`freeze_base_parameters`). `loss_target` (B, h, w, C) is
    noise - target, `weighting` (B, 1, 1, 1) the SD3 weighting, `weights`
    (B,) the sample weights."""
    adapters = [_adapters(stage) for stage in pipe.stages]
    for p in (p for a in adapters for p in a.values()):
        p.grad = None
    last = pipe.devices[-1]
    loss_target, weighting, w = (t.to(last) for t in (loss_target, weighting, weights.float()))
    nums = []
    for rows, pred in pipe.microbatches(
            hidden_states=hidden_states, encoder_hidden_states=encoder_hidden_states,
            pooled_projections=pooled_projections, timestep=timestep, img_ids=img_ids, txt_ids=txt_ids,
            guidance=guidance, microbatch=microbatch, remat=True):
        nums.append(loss_numerator(pred, loss_target[rows], weighting[rows], w[rows], seq_cond, latent_h, latent_w))
    total = reduce(torch.add, nums)
    total.backward()
    den = torch.clamp(w.sum(), min=1e-8)
    grads = []
    for a in adapters:
        for p in a.values():
            if p.grad is not None:
                p.grad.div_(den.to(p.grad.device))
        grads.append({n: p.grad for n, p in a.items()})
    return (total / den).detach(), grads


class PipelineLoraTrainer:
    """LoRA training with the frozen FLUX base cut into pipeline stages.

    Each stage's frozen base, its adapters and their optimizer state live on
    the stage's device; `make_optimizer(params)` builds one optimizer per
    stage over that stage's adapters (JAX updates per stage). A step mirrors
    `compute_loss_from_latents`'s preparation (`model.loss_inputs`), runs
    the GPipe forward and backward, then each stage's optimizer.

        trainer = PipelineLoraTrainer(model, pipe,
                                      lambda ps: torch.optim.AdamW(ps, lr=1e-4, weight_decay=1e-4))
        loss, stats = trainer.step(cond_latent, target_latent, noise, u, weights=w, microbatch=2)
    """

    def __init__(self, model, pipe: PipelinedFluxTransformer, make_optimizer: Callable):
        self.model, self.pipe = model, pipe
        self.adapters = [list(_adapters(stage).values()) for stage in pipe.stages]
        self.optimizers = [make_optimizer(ps) for ps in self.adapters if ps]

    def loss_and_grads(self, cond_latent: Tensor, target_latent: Tensor, noise: Tensor, u: Tensor, *,
                       weights: Optional[Tensor] = None, microbatch: int = 1):
        """(loss, per-stage gradients, stats) of the step, without the update."""
        model = self.model
        inp = model.loss_inputs(cond_latent, target_latent, noise, u)
        bsz = inp["bsz"]
        prompt, pooled = model.text_conditioning(bsz)
        w = torch.ones((bsz,), dtype=torch.float32, device=inp["packed"].device) if weights is None else weights
        loss, grads = pipelined_lora_loss_and_grads(
            self.pipe, hidden_states=inp["packed"], encoder_hidden_states=prompt, pooled_projections=pooled,
            timestep=inp["timesteps"] / 1000.0, img_ids=inp["img_ids"], txt_ids=model.text_ids,
            guidance=model._guidance(bsz), loss_target=inp["loss_target"], weighting=inp["weighting"],
            weights=w, seq_cond=inp["seq_cond"], latent_h=inp["latent_h"], latent_w=inp["latent_w"],
            microbatch=microbatch)
        stats = {"timesteps_mean": inp["timesteps"].mean(), "sigmas_mean": inp["sigmas"].mean()}
        return loss, grads, stats

    def step(self, cond_latent: Tensor, target_latent: Tensor, noise: Tensor, u: Tensor, *,
             weights: Optional[Tensor] = None, microbatch: int = 1):
        """One GPipe LoRA step from pre-encoded latents -> (loss, stats)."""
        loss, _, stats = self.loss_and_grads(cond_latent, target_latent, noise, u, weights=weights,
                                             microbatch=microbatch)
        for opt in self.optimizers:
            opt.step()
        return loss, stats
