"""FLUX-Kontext text-alpha model: transformer + RGBA VAE + flow matching,
the sampler and the LoRA training loss.

Counterpart of `ragb_vae_tpu/models/flux_kontext_textalpha.py`. The JAX
package passes parameter trees through every call; here the transformer
module owns base and adapters, so `init_lora` / `load_lora` change the module
in place and `compute_loss` takes no parameters. It keeps the reference's
quirks:

- in-context conditioning by concatenating the packed cond and target token
  streams, with the SAME latent image-id grid repeated for both halves;
- fresh noise injected at every denoising step
  (`noisy_target = (1-σ)·latents + σ·noise_i`);
- the guidance tensor (3.5) only when the transformer is guidance-distilled;
- logit-normal timestep sampling with the index clipped into the schedule,
  SD3 weighting (identically 1 for "logit_normal").

All randomness comes from an explicit `torch.Generator`, drawn in a fixed
order: sampling draws posterior eps, initial latents, then one noise tensor
per step; the training loss draws the condition's eps, the target's eps, the
noise and the timestep density.

Two parallel axes of the LoRA stage live here: `fsdp=` (a data axis) keeps
this rank's part of the frozen base (`parallel/fsdp.py`), and `seq=` (a
sequence axis) runs every transformer call on this rank's 1/sp of the image
and prompt streams and gathers the prediction (`_transformer_pred`, JAX
`_constrain_seq`), in the loss and in the sampler alike.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ragb_vae_tpu_torch.device import resolve_device
from ragb_vae_tpu_torch.models.flux_transformer import (
    WEIGHT_QUANT_MODES,
    FluxTransformer2D,
    FluxTransformerConfig,
    QLinear,
    add_lora,
    freeze_base_parameters,
)
from ragb_vae_tpu_torch.models.flux_weights import (
    DTypes,
    StateDict,
    load_flux_transformer_params,
    load_lora_state,
    lora_parameters,
    lora_params_to_peft_state,
    lora_state,
    params_from_flax,
    peft_state_to_lora_params,
)
from ragb_vae_tpu_torch.models.quantize import (
    is_quantized_checkpoint,
    load_quantized_transformer,
    quantize_module_,
)
from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
from ragb_vae_tpu_torch.models.scheduler import (
    FlowMatchEulerConfig,
    FlowMatchEulerScheduler,
    calc_mu,
    compute_density_for_timestep_sampling,
    compute_loss_weighting_for_sd3,
)
from ragb_vae_tpu_torch.models.text_encoders import (
    clip_empty_prompt_ids,
    load_clip_text_encoder,
    load_t5_encoder,
    t5_empty_prompt_ids,
)
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
from ragb_vae_tpu_torch.models.weights import load_autoencoder_params, load_torch_state, save_torch_state
from ragb_vae_tpu_torch.ops.packing import pack_latents, prepare_latent_image_ids, unpack_latents
from ragb_vae_tpu_torch.parallel import sequence_parallel as spm
from ragb_vae_tpu_torch.parallel.fsdp import shard_base_
from ragb_vae_tpu_torch.parallel.mesh import Mesh, randn_rows
from ragb_vae_tpu_torch.parallel.tensor_parallel import shard_state_entry, shard_transformer_, validate_tp

Tensor = torch.Tensor

EMPTY_PROMPT_FILE = "empty_prompt_embeds.npz"
LORA_WEIGHT_FILES = ("pytorch_lora_weights.safetensors", "pytorch_lora_weights.bin")


def load_transformer(
    model_path: Union[str, Path], *, subfolder: Optional[str] = "transformer", take=None,
    dtype: DTypes = torch.float32,
) -> Tuple[FluxTransformerConfig, StateDict, bool]:
    """(config, the port's state dict, whether it is weight-only int8). A
    directory with the quantisation marker is read as the quantised tree it
    holds (written by either package); any other as a diffusers checkpoint,
    each entry cast to `dtype` as it is read (`load_flux_transformer_params`).
    `take(key, full) -> part` keeps part of each entry (a tensor-parallel
    rank's slice): a diffusers checkpoint is then read one tensor at a time,
    a quantised tree whole and cut afterwards."""
    directory = Path(model_path) / subfolder if subfolder else Path(model_path)
    if is_quantized_checkpoint(directory):
        config, tree = load_quantized_transformer(directory)
        state = params_from_flax(tree)
        if take is not None:
            state = {k: take(k, v).clone() for k, v in state.items()}
        return config, state, True
    return (*load_flux_transformer_params(model_path, subfolder, take=take, dtype=dtype), False)


def load_scheduler(model_path: Union[str, Path]) -> FlowMatchEulerScheduler:
    cfg_path = Path(model_path) / "scheduler" / "scheduler_config.json"
    config = FlowMatchEulerConfig.from_json(cfg_path) if cfg_path.exists() else FlowMatchEulerConfig()
    return FlowMatchEulerScheduler(config)


def load_rgba_vae_from_path(vae_path: Union[str, Path], *, subfolder: Optional[str] = "ae",
                            dtype: torch.dtype = torch.float32, device: Union[str, torch.device] = "cuda",
                            fused: bool = False) -> RgbaVAE:
    """The RGBA VAE of `<vae_path>/<subfolder>`, or of `vae_path` itself when
    that subfolder does not exist; an RGB checkpoint is widened to RGBA
    (JAX's `load_rgba_vae_from_path`). The module holds its weights, in
    `dtype` on `device`, where JAX returns (model, params). `device` is the
    card unless the caller names the CPU; a missing card raises."""
    device = resolve_device(device)
    try:
        config, state = load_autoencoder_params(vae_path, subfolder, adapt_to_rgba=True)
    except FileNotFoundError:
        config, state = load_autoencoder_params(vae_path, None, adapt_to_rgba=True)
    vae = RgbaVAE(config, dtype=dtype, fused=fused, device="meta")
    want = {k: p.dtype for k, p in vae.module.state_dict().items()}
    vae.module.load_state_dict({k: v.to(want.get(k, dtype)) for k, v in state.items()}, strict=True, assign=True)
    vae.module.to(device)
    return vae


def read_empty_prompt(model_path: Union[str, Path]) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(prompt_embeds, pooled_prompt_embeds, text_ids) from
    `empty_prompt_embeds.npz` beside the checkpoint (written by either
    package), or None when there is none."""
    path = Path(model_path) / EMPTY_PROMPT_FILE
    if not path.exists():
        return None
    with np.load(path) as data:
        return data["prompt_embeds"], data["pooled_prompt_embeds"], data["text_ids"]


def save_empty_prompt_embeds(path: Union[str, Path], prompt_embeds, pooled_prompt_embeds, text_ids) -> None:
    """`empty_prompt_embeds.npz` in `path` with the JAX package's keys, in
    fp32. Written under a name of this process's own and moved into place, so
    ranks that write it at once never leave a torn file."""
    target = Path(path) / EMPTY_PROMPT_FILE
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    try:
        with open(tmp, "wb") as f:
            np.savez(f, prompt_embeds=np.asarray(prompt_embeds, np.float32),
                     pooled_prompt_embeds=np.asarray(pooled_prompt_embeds, np.float32),
                     text_ids=np.asarray(text_ids, np.float32))
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)


@contextlib.contextmanager
def _full_fp32_matmuls():
    """TF32 off for the matmuls and convolutions inside; the settings restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def encode_empty_prompt(
    model_path: Union[str, Path], *, device: Union[str, torch.device] = "cuda"
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(prompt_embeds, pooled_prompt_embeds, text_ids) of the empty prompt,
    as the JAX package's `encode_empty_prompt` computes them.

    `empty_prompt_embeds.npz` beside the checkpoint is read when it exists.
    Otherwise the checkpoint's CLIP (`tokenizer/`, `text_encoder/`) and T5
    (`tokenizer_2/`, `text_encoder_2/`) encoders run once on `device` in
    fp32 with TF32 off, one after the other, and are freed; the result is
    written to the npz. The pooled embedding is CLIP's final LayerNorm
    applied once more to its last hidden state, at token 0 (as in the JAX
    package). The prompt is the CLIP stream then the T5 stream when their
    widths match, else the T5 stream alone (published FLUX: (1, 512, 4096)).
    `device` is the card unless the caller names the CPU; a missing card
    raises."""
    device = resolve_device(device)
    model_path = Path(model_path)
    cached = read_empty_prompt(model_path)
    if cached is not None:
        return cached
    ids_one, mask_one = clip_empty_prompt_ids(model_path / "tokenizer")
    ids_two, mask_two = t5_empty_prompt_ids(model_path / "tokenizer_2")
    with _full_fp32_matmuls(), torch.no_grad():
        clip = load_clip_text_encoder(model_path / "text_encoder", device=device)
        prompt_one = clip(ids_one.to(device), mask_one.to(device))
        pooled = clip.text_model.final_layer_norm(prompt_one)[:, 0]
        del clip
        t5 = load_t5_encoder(model_path / "text_encoder_2", device=device)
        prompt_two = t5(ids_two.to(device), mask_two.to(device))
        del t5
    if prompt_one.shape[-1] == prompt_two.shape[-1]:
        prompt = torch.cat([prompt_one, prompt_two], dim=1)
    else:
        prompt = prompt_two
    out = (prompt.float().cpu().numpy(), pooled.float().cpu().numpy(),
           np.zeros((prompt.shape[1], 3), dtype=np.float32))
    del prompt_one, prompt_two, prompt, pooled
    if device.type == "cuda":
        torch.cuda.empty_cache()
    save_empty_prompt_embeds(model_path, *out)
    return out


def write_lora_metadata(directory: Union[str, Path], *, model_id: str, rank: int,
                        lora_alpha: float, dtype: str, step: int) -> None:
    """`metadata.json` beside the adapters, in the JAX package's format."""
    meta = {"model_id": model_id, "rank": int(rank), "lora_alpha": float(lora_alpha),
            "dtype": dtype, "step": int(step)}
    Path(directory).mkdir(parents=True, exist_ok=True)
    (Path(directory) / "metadata.json").write_text(json.dumps(meta, indent=2))


def read_lora_metadata(directory: Union[str, Path]) -> Optional[Dict[str, Any]]:
    path = Path(directory) / "metadata.json"
    if not path.exists():
        return None
    return json.loads(path.read_text())


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise parameters in place at lecun-normal scale, as the JAX
    initializers do: weights ~ N(0, 1/fan_in), biases 0, norm scales 1,
    LoRA B 0. Draws follow `named_parameters` order, so a seed fixes them.
    An int8 linear draws its integers uniformly with the scale
    3 / sqrt(in) / 127 (the JAX package's `random_quantized_params_like`):
    about what a quantised lecun-normal layer carries, so activations stay
    O(1) in a model too large to build in bf16 first.

    A tensor-parallel shard (`QLinear.shard_`) and an FSDP part
    (`parallel/fsdp.py`) draw the FULL tensor in turn and keep their slice, so
    a seed fixes the same model at any degree and no more than one full
    weight exists at a time."""
    plan = getattr(module, "fsdp", None)

    def drawn(like: Tensor, fill) -> Tensor:
        """`fill(like)`, drawn on the generator's device: a pipeline stage on
        another device gets the numbers the whole model on one device gets."""
        if like.device == generator.device:
            return fill(like)
        return like.copy_(fill(torch.empty_like(like, device=generator.device)))

    def draw(m, key: str, like: Tensor, fill) -> Tensor:
        split = None if plan is None else plan.split_of(key)
        if split is not None:
            full = torch.empty(split[1], dtype=like.dtype, device=like.device)
            return like.copy_(plan.part(drawn(full, fill), split[0]))
        if not isinstance(m, QLinear) or m.tp_kind == "none":
            return drawn(like, fill)
        full = torch.empty((m.out_features, m.in_features), dtype=like.dtype, device=like.device)
        return like.copy_(m.shard_of(key.rsplit(".", 1)[-1], drawn(full, fill)))

    for name, m in module.named_modules():
        if isinstance(m, QLinear) and m.weight_quant == "int8":
            draw(m, f"{name}.weight_q", m.weight_q, lambda t: t.random_(-127, 128, generator=generator))
            m.weight_scale.fill_(3.0 / math.sqrt(m.in_features) / 127.0)
            if m.bias is not None:
                m.bias.zero_()
    for name, p in module.named_parameters():
        owner, leaf = name.rpartition(".")[::2]
        if leaf == "lora_B" or leaf == "bias":
            p.zero_()
        elif p.ndim == 1:
            p.fill_(1.0)
        elif leaf == "lora_A":
            drawn(p, lambda t: t.normal_(0.0, 1.0 / p.shape[0], generator=generator))  # std 1/rank, as peft
        else:
            m = module.get_submodule(owner)
            fan_in = m.in_features if isinstance(m, QLinear) else p[0].numel()
            draw(m, name, p, lambda t: t.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator))


def _sharded(transformer: FluxTransformer2D, tp: Optional[Mesh], device, weight_quant: str,
             fsdp: Optional[Mesh] = None) -> FluxTransformer2D:
    """`transformer` (on the meta device) cut to this rank's shard over the
    model axis `tp`, or to its FSDP part over the data axis `fsdp`; a degree
    that does not divide the heads, or a shard the kernels cannot take,
    raises before anything is drawn or read."""
    if tp is not None and tp.size > 1:
        validate_tp(transformer.config, tp.size, cuda=torch.device(device).type == "cuda", weight_quant=weight_quant)
        shard_transformer_(transformer, tp)
    return shard_base_(transformer, fsdp) if fsdp is not None else transformer


def per_sample_loss(pred: Tensor, loss_target: Tensor, weighting: Tensor, seq_cond: int,
                    latent_h: int, latent_w: int) -> Tensor:
    """(B,) mean of weighting * (pred_target - loss_target)^2 in fp32 over the
    target half of the packed prediction (B, seq_cond + n, C)."""
    pred_target = unpack_latents(pred[:, seq_cond:, :].float(), latent_h, latent_w)
    return (weighting * (pred_target - loss_target) ** 2).reshape(pred.shape[0], -1).mean(dim=1)


class FluxTextAlphaModel:
    """Transformer module + RgbaVAE + scheduler + empty-prompt embeddings."""

    def __init__(
        self,
        transformer: FluxTransformer2D,
        vae: RgbaVAE,
        scheduler: FlowMatchEulerScheduler,
        prompt_embeds: Tensor,          # (1, txt_seq, joint_dim)
        pooled_prompt_embeds: Tensor,   # (1, pooled_dim)
        text_ids: Tensor,               # (txt_seq, 3)
        *,
        guidance_scale: float = 3.5,
        lora_rank: int = 0,
        lora_alpha: float = 0.0,
        dtype: torch.dtype = torch.float32,
        seq: Optional[Mesh] = None,
    ):
        self.transformer = transformer
        self.seq = seq or Mesh()
        self._told_unsharded = False
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        self.transformer_config = transformer.config
        self.vae = vae
        self.scheduler = scheduler
        device = self.device
        self.prompt_embeds = torch.as_tensor(prompt_embeds, dtype=torch.float32).to(device)
        self.pooled_prompt_embeds = torch.as_tensor(pooled_prompt_embeds, dtype=torch.float32).to(device)
        self.text_ids = torch.as_tensor(text_ids, dtype=torch.float32).to(device)
        self.guidance_scale = guidance_scale
        self.dtype = dtype
        self.vae_scale_factor = vae.config.spatial_scale_factor
        self.scaling_factor = float(vae.config.scaling_factor)
        self.shift_factor = float(vae.config.shift_factor)
        # train-time schedule: all of num_train_timesteps, with the dynamic
        # shift's mu taken from the VAE sample size
        self._train_sched = FlowMatchEulerScheduler(self.scheduler.config)
        self._train_sched.set_timesteps(
            self.scheduler.config.num_train_timesteps, mu=self._schedule_mu())

    def _schedule_mu(self) -> Optional[float]:
        sample = self.vae.config.sample_size or 256
        h = max(int(sample // self.vae_scale_factor), 1)
        return calc_mu(self.scheduler.config, h * h)

    @property
    def device(self) -> torch.device:
        return self.transformer.x_embedder.base_weight.device

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    @classmethod
    def random(
        cls,
        t_config: FluxTransformerConfig,
        vae_config: AutoencoderConfig,
        *,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
        dtype: torch.dtype = torch.float32,
        fused: bool = False,
        prompt_len: int = 512,
        lora_rank: int = 0,
        lora_alpha: float = 0.0,
        use_gradient_checkpointing: bool = True,
        weight_quant: str = "none",
        tp: Optional[Mesh] = None,
        fsdp: Optional[Mesh] = None,
        seq: Optional[Mesh] = None,
        pipeline=None,
    ) -> "FluxTextAlphaModel":
        """A model with random weights and random prompt embeddings, all
        drawn from `seed` on `device` (the card unless the caller names the
        CPU; a missing card raises). Modules are built on the meta device
        and materialised directly on `device` in `dtype`, so a full-size
        transformer never exists in host memory. With `lora_rank` > 0 fresh
        adapters are attached after the base is drawn and the base is frozen.
        `weight_quant="int8"` draws the transformer's linears as int8.

        `tp` (a model axis, `parallel/mesh.py`): this rank's tensor-parallel
        shard of the transformer, drawn from the same seeded stream as the
        whole one (each full weight in turn, its slice kept); the VAE and the
        embeddings are whole on every rank. `fsdp` (a data axis): this rank's
        FSDP part of the frozen base, drawn the same way. `seq` (a sequence
        axis): the transformer runs sequence-parallel over it.

        `pipeline` (a `parallel/pipeline.py::PipelinedFluxTransformer` of this
        config): each stage's part of the transformer is materialised on its
        stage's device and drawn there from the same stream (each tensor
        drawn on the first stage's device and copied over), so a seed gives
        the same model at any placement; the VAE and the prompt live on the
        first stage's device, which replaces `device`."""
        device = resolve_device(device if pipeline is None else pipeline.device)
        gen = torch.Generator(device).manual_seed(seed)
        transformer = _sharded(FluxTransformer2D(
            t_config, remat=use_gradient_checkpointing, weight_quant=weight_quant,
            device="meta", dtype=dtype,
        ), tp, device, weight_quant, fsdp)
        if pipeline is None:
            transformer.to_empty(device=device)
        else:
            pipeline.place_(transformer)
        vae = RgbaVAE(vae_config, dtype=dtype, fused=fused, device="meta")
        vae.module.to_empty(device=device)
        init_random_(transformer, gen)
        init_random_(vae.module, gen)
        prompt = torch.randn((1, prompt_len, t_config.joint_attention_dim), generator=gen, device=device)
        pooled = torch.randn((1, t_config.pooled_projection_dim), generator=gen, device=device)
        text_ids = torch.zeros((prompt_len, 3), device=device)
        model = cls(transformer.eval(), vae, FlowMatchEulerScheduler(), prompt, pooled, text_ids,
                    lora_rank=lora_rank, lora_alpha=lora_alpha, dtype=dtype, seq=seq)
        if lora_rank > 0:
            model.init_lora(gen)
        return model

    @classmethod
    def from_pretrained(
        cls,
        model_path: Union[str, Path],
        *,
        vae_path: Union[str, Path],
        vae_subfolder: str = "ae",
        dtype: torch.dtype = torch.float32,
        device: Union[str, torch.device] = "cuda",
        fused: bool = False,
        lora_rank: int = 0,
        lora_alpha: float = 0.0,
        use_gradient_checkpointing: bool = True,
        weight_quant: str = "none",
        tp: Optional[Mesh] = None,
        fsdp: Optional[Mesh] = None,
        seq: Optional[Mesh] = None,
        pipeline=None,
    ) -> "FluxTextAlphaModel":
        """Transformer from `<model_path>/transformer`, scheduler config and
        the empty prompt's embeddings from `model_path` (`encode_empty_prompt`:
        the npz, or the text encoders on `device`), RGBA VAE from
        `<vae_path>/<vae_subfolder>` (or `vae_path` itself). With `lora_rank`
        > 0 fresh adapters (seed 0) are attached and the base is frozen.

        `weight_quant="int8"` serves the transformer in weight-only int8: a
        quantised checkpoint directory loads as it is; a plain one is
        quantised at load from its fp32 values, one linear at a time on
        `device`, so the result is the JAX package's bit for bit and no more
        than one float weight is on the device at once.

        `tp` (a model axis, `parallel/mesh.py`): this rank keeps only its
        tensor-parallel shard. A diffusers checkpoint is read one tensor at a
        time and cut as it is read; a quantised one is read whole and cut; a
        plain one quantised at load is quantised shard by shard, each row
        shard with the scale of the whole layer (the max over the model
        group), so the int8 shards are slices of the quantised whole layer.

        `fsdp` (a data axis): this rank keeps only its FSDP part of the frozen
        base, read the same ways; a plain checkpoint quantised at load is
        quantised part by part (`fsdp.quantize_sharded_`), so the parts are
        those of the quantised whole. `seq`: as in `random`.

        `pipeline` (a `parallel/pipeline.py::PipelinedFluxTransformer` of the
        checkpoint's config): the weights are read into host memory and each
        stage's modules go straight to its stage's device; a plain checkpoint
        quantised at load is quantised one linear at a time on its stage's
        device. No device holds more than its stage, and the first stage's
        device also the VAE and the prompt (it replaces `device`).

        `device` is the card unless the caller names the CPU; a missing card
        raises."""
        device = resolve_device(device if pipeline is None else pipeline.device)
        if weight_quant not in WEIGHT_QUANT_MODES:
            raise ValueError(f"Unknown weight_quant mode {weight_quant!r}.")
        t_dir = Path(model_path) / "transformer"
        quantized = is_quantized_checkpoint(t_dir)
        if quantized and weight_quant != "int8":
            raise ValueError(
                f"{model_path} holds a weight-only int8 transformer: load it with weight_quant='int8'.")
        vae = load_rgba_vae_from_path(vae_path, subfolder=vae_subfolder, dtype=dtype, device=device, fused=fused)
        # the text encoders run (when the npz is absent) and are freed
        # before any of the transformer reaches the device
        prompt, pooled, text_ids = encode_empty_prompt(model_path, device=device)
        quantize_here = weight_quant == "int8" and not quantized
        transformer = _sharded(FluxTransformer2D(
            FluxTransformerConfig.from_json(t_dir / "config.json"), remat=use_gradient_checkpointing,
            weight_quant="int8" if quantized else "none",
            device="meta", dtype=torch.float32 if quantize_here else dtype), tp, device, weight_quant, fsdp)
        take = None
        if transformer.tp.size > 1:
            take = lambda key, full: shard_state_entry(transformer, key, full)   # noqa: E731
        elif transformer.fsdp is not None:
            take = transformer.fsdp.take
        # each tensor keeps the dtype its module declared (fp32 for the AdaLN
        # modulation, int8 and fp32 for a quantised linear, `dtype` elsewhere),
        # cast as it is read: the host never holds a second copy of the model
        want = {k: p.dtype for k, p in transformer.state_dict().items()}
        _, t_state, _ = load_transformer(model_path, take=take, dtype=want)
        transformer.load_state_dict({k: v.to(want.get(k, dtype)) for k, v in t_state.items()},
                                    strict=True, assign=True)
        del t_state
        if quantize_here:
            if pipeline is None:
                quantize_module_(transformer, device=device, dtype=dtype)
            else:
                for s, stage_device in enumerate(pipeline.devices):
                    for part in pipeline.stage_modules(transformer, s):
                        quantize_module_(part, device=stage_device, dtype=dtype)
                transformer.weight_quant = "int8"
            for p in transformer.parameters():      # what is left: the RMSNorm weights
                p.data = p.data.to(dtype)
        if pipeline is None:
            transformer.to(device)
        else:
            pipeline.place_(transformer)
        model = cls(transformer.eval(), vae, load_scheduler(model_path), torch.from_numpy(prompt),
                    torch.from_numpy(pooled), torch.from_numpy(text_ids),
                    lora_rank=lora_rank, lora_alpha=lora_alpha, dtype=dtype, seq=seq)
        if lora_rank > 0:
            model.init_lora(torch.Generator(model.device).manual_seed(0))
        return model

    # ------------------------------------------------------------------
    # LoRA adapters
    # ------------------------------------------------------------------
    def init_lora(self, generator: Optional[torch.Generator] = None) -> None:
        """Attach fresh fp32 adapters of `lora_rank` / `lora_alpha` to the
        transformer's target linears (A ~ N(0, 1/rank), B = 0) and freeze
        every other transformer parameter."""
        if self.lora_rank <= 0:
            raise ValueError("lora_rank must be > 0 to initialize LoRA.")
        add_lora(self.transformer, self.lora_rank, self.lora_alpha, generator)
        freeze_base_parameters(self.transformer)

    def load_lora(self, lora_dir: Union[str, Path]) -> None:
        """Attach adapters (when the transformer has none yet) and load
        peft-format weights from `lora_dir` (.safetensors, then .bin)."""
        lora_dir = Path(lora_dir)
        for name in LORA_WEIGHT_FILES:
            if (lora_dir / name).exists():
                state = load_torch_state(lora_dir / name)
                break
        else:
            raise FileNotFoundError(f"No LoRA weights in {lora_dir}.")
        if not lora_parameters(self.transformer):
            self.init_lora()
        load_lora_state(self.transformer, peft_state_to_lora_params(state))

    def lora_state_dict(self) -> Dict[str, Tensor]:
        """The adapters in peft's key format (fp32, on the host)."""
        return lora_params_to_peft_state(lora_state(self.transformer))

    def save_lora_weights(self, output_dir: Union[str, Path]) -> None:
        """peft / FluxPipeline-compatible safetensors export."""
        save_torch_state(self.lora_state_dict(), Path(output_dir) / LORA_WEIGHT_FILES[0])

    # ------------------------------------------------------------------
    # Core helpers
    # ------------------------------------------------------------------
    def encode_latents(self, x: Tensor, eps: Tensor) -> Tensor:
        """[0,1] NHWC image -> scaled/shifted fp32 latent (B, h, w, C), the
        posterior sampled with the standard-normal draw `eps`."""
        posterior = self.vae.encode((x * 2.0 - 1.0).to(self.dtype))
        latents = posterior.sample(eps, dtype=torch.float32)
        return (latents - self.shift_factor) * self.scaling_factor

    def decode_latents(self, latents: Tensor) -> Tensor:
        """Sampler latents -> [0,1] fp32 NHWC image."""
        decoded = self.vae.decode((latents / self.scaling_factor + self.shift_factor).to(self.dtype))
        return torch.clamp((decoded.float() + 1.0) / 2.0, 0.0, 1.0)

    def _guidance(self, batch_size: int) -> Optional[Tensor]:
        if not self.transformer_config.guidance_embeds:
            return None
        return torch.full((batch_size,), self.guidance_scale, dtype=torch.float32, device=self.device)

    def sequence_sharded(self, height: int, width: int) -> bool:
        """Whether a batch of (height, width) images runs sequence-parallel
        over `seq`: both streams (2 x the packed latent tokens, and the
        prompt) divide by its size."""
        h, w, _ = self.latent_shape(height, width)
        return spm.applies(self.seq, 2 * (h // 2) * (w // 2), self.prompt_embeds.shape[1])

    def text_conditioning(self, batch_size: int) -> Tuple[Tensor, Tensor]:
        """(prompt (B, txt_seq, joint_dim), pooled (B, pooled_dim)) in the model dtype."""
        prompt = self.prompt_embeds.expand(batch_size, -1, -1).to(self.dtype)
        pooled = self.pooled_prompt_embeds.expand(batch_size, -1).to(self.dtype)
        return prompt, pooled

    def _transformer_pred(self, packed: Tensor, timestep: Tensor, img_ids: Tensor, batch_size: int,
                          transformer=None) -> Tensor:
        """The transformer's prediction for the whole packed stream. Over a
        sequence axis each rank runs this rank's contiguous 1/sp of the image
        and the prompt streams and of their ids (txt first, as in the joint
        sequence), and the prediction is gathered; where a stream does not
        divide by sp the whole call runs unsharded on every rank, as JAX's
        `_constrain_seq` and `attention` fall back. `transformer`: what runs
        in place of `self.transformer`, with its keyword signature (a
        pipeline, `parallel/pipeline.py`)."""
        prompt, pooled = self.text_conditioning(batch_size)
        txt_ids, seq = self.text_ids, None
        if spm.applies(self.seq, packed.shape[1], prompt.shape[1]):
            seq = self.seq
            packed, prompt = spm.local_part(packed, seq), spm.local_part(prompt, seq)
            img_ids, txt_ids = spm.local_part(img_ids, seq, 0), spm.local_part(txt_ids, seq, 0)
        elif self.seq.size > 1 and not self._told_unsharded:
            self._told_unsharded = True
            print(f"[sequence_parallel] streams of {packed.shape[1]} image and {prompt.shape[1]} prompt tokens "
                  f"do not divide by {self.seq.size}: the transformer runs unsharded on every rank", flush=True)
        pred = (self.transformer if transformer is None else transformer)(
            hidden_states=packed,
            encoder_hidden_states=prompt,
            pooled_projections=pooled,
            timestep=timestep,
            img_ids=img_ids,
            txt_ids=txt_ids,
            guidance=self._guidance(batch_size),
            seq=seq,
        )
        return pred if seq is None else spm.gather_out(pred, seq)

    # ------------------------------------------------------------------
    # Training loss
    # ------------------------------------------------------------------
    def compute_loss(
        self,
        gt: Tensor,
        text_alpha: Tensor,
        generator: Optional[torch.Generator],
        weights: Optional[Tensor] = None,
        mesh: Optional[Mesh] = None,
    ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """gt / text_alpha: (B, H, W, 4) RGBA in [0, 1]. `weights` (B,) makes
        the loss a weighted batch mean (weight 0 marks a padding sample).
        Four draws from `generator`, in this order: the condition's posterior
        eps, the target's, the noise, the timestep density; over a `mesh`
        (the rows are this process's), each is drawn for every process's rows
        and this process keeps its own. Both encodes run without a gradient
        (the VAE is frozen)."""
        gt, text_alpha = gt.to(self.device), text_alpha.to(self.device)
        bsz = gt.shape[0]
        lat_shape = (bsz,) + self.latent_shape(gt.shape[1], gt.shape[2])
        mesh = mesh or Mesh()
        eps_cond = randn_rows(lat_shape, generator, mesh, device=self.device)
        eps_target = randn_rows(lat_shape, generator, mesh, device=self.device)
        with torch.no_grad():
            cond_latent = self.encode_latents(gt, eps_cond)
            target_latent = self.encode_latents(text_alpha, eps_target)
        noise = randn_rows(lat_shape, generator, mesh, device=self.device)
        u = compute_density_for_timestep_sampling(
            generator, bsz, weighting_scheme="logit_normal", device=self.device,
            draw=randn_rows((bsz,), generator, mesh, device=self.device))
        return self.compute_loss_from_latents(cond_latent, target_latent, noise, u, weights=weights)

    def compute_loss_from_latents(
        self,
        cond_latent: Tensor,
        target_latent: Tensor,
        noise: Tensor,
        u: Tensor,
        weights: Optional[Tensor] = None,
    ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Deterministic core of the flow-matching loss: the noise and the
        timestep density are handed in."""
        inp = self.loss_inputs(cond_latent, target_latent, noise, u)
        pred = self._transformer_pred(inp["packed"], inp["timesteps"] / 1000.0, inp["img_ids"], inp["bsz"])
        per_sample = per_sample_loss(pred, inp["loss_target"], inp["weighting"], inp["seq_cond"],
                                     inp["latent_h"], inp["latent_w"])
        if weights is None:
            loss = per_sample.mean()
        else:
            w = weights.float()
            loss = (per_sample * w).sum() / torch.clamp(w.sum(), min=1e-8)
        stats = {"timesteps_mean": inp["timesteps"].mean(), "sigmas_mean": inp["sigmas"].mean()}
        return loss, stats

    def loss_inputs(self, cond_latent: Tensor, target_latent: Tensor, noise: Tensor, u: Tensor) -> Dict[str, Any]:
        """What the loss feeds the transformer and compares its prediction
        with: the timesteps and sigmas `u` picks from the train schedule, the
        packed (cond, noisy target) stream, its image ids, noise - target and
        the SD3 weighting, with the sizes to unpack the prediction."""
        bsz, latent_h, latent_w = target_latent.shape[:3]
        device = target_latent.device
        sched = self._train_sched
        n_train = self.scheduler.config.num_train_timesteps
        max_idx = min(len(sched.timesteps) - 1, len(sched.sigmas) - 1)
        indices = torch.clamp((u * n_train).long(), 0, max_idx)

        timesteps = torch.as_tensor(sched.timesteps, device=device)[indices]
        sigmas = torch.as_tensor(sched.sigmas, device=device)[indices].reshape(bsz, 1, 1, 1)

        noisy_target = (1.0 - sigmas) * target_latent + sigmas * noise
        packed_cond = pack_latents(cond_latent.to(self.dtype))
        packed = torch.cat([packed_cond, pack_latents(noisy_target.to(self.dtype))], dim=1)

        # the SAME latent image-id grid for both halves
        ids_single = prepare_latent_image_ids(latent_h // 2, latent_w // 2, device=device)
        img_ids = torch.cat([ids_single, ids_single], dim=0)
        return {
            "bsz": bsz, "latent_h": latent_h, "latent_w": latent_w, "timesteps": timesteps, "sigmas": sigmas,
            "packed": packed, "img_ids": img_ids, "seq_cond": packed_cond.shape[1],
            "loss_target": noise - target_latent,
            "weighting": compute_loss_weighting_for_sd3(sigmas, weighting_scheme="logit_normal"),
        }

    # ------------------------------------------------------------------
    # Sampling
    # ------------------------------------------------------------------
    def sampling_schedule(self, num_inference_steps: int) -> FlowMatchEulerScheduler:
        """Inference schedule, dynamic-shift μ from the VAE sample size."""
        sched = FlowMatchEulerScheduler(self.scheduler.config)
        sched.set_timesteps(num_inference_steps, mu=self._schedule_mu())
        return sched

    def sample_latents_from_noise(
        self,
        cond_latent: Tensor,
        init_noise: Tensor,
        step_noises: Tensor,
        *,
        return_trajectory: bool = False,
        transformer=None,
    ):
        """Deterministic core of `sample`: all noise is injected.

        `init_noise` initialises the latents; `step_noises` is
        (num_steps, B, h, w, C), one fresh tensor per denoising step. With
        `return_trajectory` the (num_steps, B, h, w, C) latents after each
        Euler step come back beside the final latents. `transformer`: what
        runs in place of `self.transformer` (`_transformer_pred`)."""
        num_steps = step_noises.shape[0]
        sched = self.sampling_schedule(num_steps)
        bsz, latent_h, latent_w = cond_latent.shape[:3]
        device = cond_latent.device
        ids_single = prepare_latent_image_ids(latent_h // 2, latent_w // 2, device=device)
        img_ids = torch.cat([ids_single, ids_single], dim=0)
        packed_cond = pack_latents(cond_latent.to(self.dtype))
        seq_cond = packed_cond.shape[1]

        latents = init_noise.float()
        trajectory = []
        for i in range(num_steps):
            sigma = float(sched.sigmas[i])
            # the reference's quirk: fresh noise injected at EVERY step
            noisy_target = (1.0 - sigma) * latents + sigma * step_noises[i].float()
            packed = torch.cat([packed_cond, pack_latents(noisy_target.to(self.dtype))], dim=1)
            timestep = torch.full((bsz,), float(sched.timesteps[i]) / 1000.0, device=device)
            pred = self._transformer_pred(packed, timestep, img_ids, bsz, transformer)
            pred_target = unpack_latents(pred[:, seq_cond:, :].float(), latent_h, latent_w)
            latents = sched.step(pred_target, i, latents)
            if return_trajectory:
                trajectory.append(latents)
        if return_trajectory:
            return latents, torch.stack(trajectory)
        return latents

    def draw_noise(
        self, lat_shape, num_steps: int, generator: torch.Generator
    ) -> Tuple[Tensor, Tensor, Tensor]:
        """(eps, init, step_noises) for one request, drawn in that order."""
        kw = {"generator": generator, "device": self.device, "dtype": torch.float32}
        eps = torch.randn(lat_shape, **kw)
        init = torch.randn(lat_shape, **kw)
        steps = torch.randn((num_steps,) + tuple(lat_shape), **kw)
        return eps, init, steps

    def latent_shape(self, height: int, width: int) -> Tuple[int, int, int]:
        f = self.vae_scale_factor
        return (height // f, width // f, self.vae.config.latent_channels)

    @torch.inference_mode()
    def sample(self, gt: Tensor, *, num_inference_steps: int = 20,
               generator: Optional[torch.Generator] = None, transformer=None) -> Tensor:
        """(B, H, W, 4) [0,1] condition -> (B, H, W, 4) [0,1] text-alpha
        prediction. Each sample's noise is drawn from `generator` in order.
        `transformer`: as in `sample_latents_from_noise`."""
        gt = gt.to(self.device)
        lat_shape = self.latent_shape(gt.shape[1], gt.shape[2])
        draws = [self.draw_noise(lat_shape, num_inference_steps, generator) for _ in range(gt.shape[0])]
        eps, init, steps = (torch.stack(t) for t in zip(*draws))
        cond = self.encode_latents(gt, eps)
        latents = self.sample_latents_from_noise(cond, init, steps.transpose(0, 1), transformer=transformer)
        return self.decode_latents(latents)
