"""RGBA-VAE train and eval steps on one device.

Counterpart of `ragb_vae_tpu/training/vae_step.py`: triplet build, encode,
posterior split, sample, decode, loss assembly, backward over the
microbatches, global-norm clip and AdamW. The JAX package compiles this into
one program and passes parameters and optimizer state through it; here the
model owns its parameters and the optimizer its state, and a step updates
both in place and returns the metrics.

The compute dtype is the model's (`RgbaVAE(compute_dtype=...)`): training
keeps fp32 parameters for AdamW and runs activations and kernel operands in
bf16 on the card. The posterior noise comes from one `torch.Generator` per
step, drawn per microbatch in order, or is handed in as `eps`.

With a `mesh` (`parallel/mesh.py`, the data axis over a process group) the
step is ZeRO-2 (`parallel/zero_step.py`): each process runs the loss and its
backward on its rows, and the gradients, the clip and AdamW are reduced and
partitioned over the processes, AdamW's moments optionally in host memory
between steps (`offload_opt_state`). Each micro-batch's noise is then drawn
at the global micro-batch's shape from the one generator and each process
keeps its own rows, so N processes draw what one draws.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ragb_vae_tpu_torch.models.losses import AlphaVaeLossConfig
from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
from ragb_vae_tpu_torch.ops.gaussian import split_batch
from ragb_vae_tpu_torch.ops.metrics import alpha_mae, psnr
from ragb_vae_tpu_torch.ops.rgba import composite_over_background, ensure_alpha, from_vae_range, to_vae_range
from ragb_vae_tpu_torch.ops.triplet import detail_augmented_triplet
from ragb_vae_tpu_torch.parallel.grad_accum import accumulated_grads
from ragb_vae_tpu_torch.parallel.mesh import Mesh, global_rows, local_rows, randn_rows
from ragb_vae_tpu_torch.parallel.zero_step import ZeroAdamW, weighted_mean_over_ranks

Tensor = torch.Tensor
Batch = Dict[str, Tensor]
PerceptualLoss = Callable[[Tensor, Tensor, Optional[Tensor]], Tensor]


@dataclasses.dataclass(frozen=True)
class VaeStepConfig:
    """Knobs of the step (mirrors flux_vae.yaml training.*)."""

    kl_scale: float = 0.0
    ref_kl_scale: float = 0.0
    lpips_scale: float = 0.0
    gradient_accumulation_steps: int = 1


def trainable_parameters(model: RgbaVAE) -> List[Tensor]:
    return [p for p in model.module.parameters() if p.requires_grad]


def global_norm(tensors: Sequence[Tensor]) -> Tensor:
    """sqrt of the sum of squares over all tensors, in fp32."""
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


class ClippedAdamW(torch.optim.AdamW):
    """AdamW behind a global-norm clip: gradients are scaled by
    max_grad_norm / max(norm, max_grad_norm) before the update (no clip when
    `max_grad_norm` is None)."""

    def __init__(self, params, lr: float, *, betas: Tuple[float, float], eps: float,
                 weight_decay: float, max_grad_norm: Optional[float]):
        super().__init__(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
        self.max_grad_norm = max_grad_norm

    def clipped_step(self, grad_norm: Tensor) -> None:
        """Clip by `grad_norm` (the global norm of the current gradients, which
        the caller has already taken for its metrics), then update."""
        if self.max_grad_norm is not None:
            scale = self.max_grad_norm / torch.clamp(grad_norm, min=self.max_grad_norm)
            for group in self.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.mul_(scale)
        self.step()


def make_optimizer(
    params: Sequence[Tensor],
    learning_rate: float,
    *,
    betas: Tuple[float, float] = (0.5, 0.9),
    weight_decay: float = 0.01,
    max_grad_norm: Optional[float] = None,
) -> ClippedAdamW:
    """Global-norm clip, then AdamW(betas=(0.5, 0.9), eps=1e-8,
    weight_decay=0.01), as the JAX package's optax chain."""
    return ClippedAdamW(params, learning_rate, betas=betas, eps=1e-8,
                        weight_decay=weight_decay, max_grad_norm=max_grad_norm)


def init_train_state(model: RgbaVAE, optimizer: ClippedAdamW, *, mesh: Optional[Mesh] = None,
                     offload: bool = False):
    """Create the AdamW moments (zeros) and step counts for every trainable
    parameter now instead of at the first update, so the optimizer's state
    dict is complete before any step (as `tx.init(params)` is); returns that
    state dict. With a `mesh`: the ZeRO-2 optimizer over `optimizer`
    (`ZeroAdamW`, this process's slice of the moments, in host memory
    between steps when `offload`), which `make_train_step(mesh=)` takes and
    whose `state_dict()` is the single-device one."""
    if mesh is not None:
        return ZeroAdamW(optimizer, mesh, offload=offload)
    if offload:
        raise ValueError("offload requires a mesh")
    for p in trainable_parameters(model):
        if not optimizer.state[p]:
            optimizer.state[p] = {
                "step": torch.tensor(0.0, dtype=torch.float32),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
            }
    return optimizer.state_dict()


def vae_loss_fn(
    model: RgbaVAE,
    batch: Batch,
    *,
    loss_cfg: AlphaVaeLossConfig,
    step_cfg: VaeStepConfig,
    ref_model: Optional[RgbaVAE] = None,
    lpips_fn: Optional[PerceptualLoss] = None,
    eps: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Loss assembly of the AlphaVAE stage.

    `batch["images"]`: (B, H, W, 4) RGBA in [0, 1]. `batch["weights"]`
    (optional): (B,) per-sample loss weights; zeros mark padding samples,
    which then change neither the loss nor the gradients. `eps` is the
    posterior's standard-normal draw (B, h, w, latent); without it, it is
    drawn from `generator`, over a `mesh` as this process's rows of the
    draw for every process's rows.
    """
    dtype = model.compute_dtype
    target = torch.clamp(batch["images"], 0.0, 1.0)
    weights = batch.get("weights")
    target_vae = to_vae_range(target).to(dtype)
    triplet = detail_augmented_triplet(target_vae)

    posterior, posterior_black, posterior_white = split_batch(model.encode(triplet), 3)
    if eps is None and mesh is not None:
        eps = randn_rows(posterior.mean.shape, generator, mesh, device=posterior.mean.device)
    z = posterior.sample(eps, generator=generator, dtype=dtype)
    pred = model.decode(z)

    recon_loss = loss_cfg.reconstruction_loss(pred, target_vae, weights)
    total = recon_loss
    metrics: Dict[str, Tensor] = {"train/recon": recon_loss}

    if step_cfg.lpips_scale > 0.0 and lpips_fn is not None:
        lpips_loss = lpips_fn(pred, target_vae, weights)
        total = total + step_cfg.lpips_scale * lpips_loss
        metrics["train/lpips"] = lpips_loss

    if step_cfg.kl_scale > 0.0:
        kl = loss_cfg.kl_loss(posterior, weights=weights)
        total = total + step_cfg.kl_scale * kl
        metrics["train/kl"] = kl

    if step_cfg.ref_kl_scale > 0.0 and ref_model is not None:
        with torch.no_grad():
            _, ref_black, ref_white = split_batch(ref_model.encode(triplet), 3)
        ref_kl = 0.5 * (
            loss_cfg.kl_loss(posterior_black, ref_black, weights=weights)
            + loss_cfg.kl_loss(posterior_white, ref_white, weights=weights)
        )
        total = total + step_cfg.ref_kl_scale * ref_kl
        metrics["train/ref_kl"] = ref_kl

    metrics["train/loss"] = total
    return total, metrics


def make_train_step(
    model: RgbaVAE,
    optimizer,
    loss_cfg: AlphaVaeLossConfig,
    step_cfg: VaeStepConfig,
    *,
    mesh: Optional[Mesh] = None,
    ref_model: Optional[RgbaVAE] = None,
    lpips_fn: Optional[PerceptualLoss] = None,
    offload_opt_state: bool = False,
):
    """Build `step(batch, *, generator=None, eps=None) -> metrics`.

    A step runs the loss and its backward over
    `step_cfg.gradient_accumulation_steps` microbatches (each weighted by its
    real-sample weight sum when the batch carries "weights", so padding stays
    exactly invariant across the split), clips, and updates the model's
    parameters and the optimizer's state in place. The metrics are scalar
    tensors on the model's device, "train/grad_norm" (before the clip)
    included. `eps`, when given, is the batch's posterior noise and is
    split like the batch. `ref_model` is the frozen reference of the ref-KL
    term.

    With a `mesh`, `batch` holds this process's rows, the update is ZeRO-2
    over the processes (`optimizer` is the `ZeroAdamW` of
    `init_train_state(mesh=)`, or the `ClippedAdamW` it wraps) and the
    metrics are weighted means over every process's rows.
    `offload_opt_state` keeps the moments in host memory between steps; it
    needs a mesh (a 1-process one will do), as in the JAX package.
    """
    if mesh is None and offload_opt_state:
        raise ValueError("offload_opt_state requires a mesh")
    params = trainable_parameters(model)
    num_micro = step_cfg.gradient_accumulation_steps
    zero = None
    if mesh is not None:
        zero = optimizer if isinstance(optimizer, ZeroAdamW) else ZeroAdamW(optimizer, mesh,
                                                                             offload=offload_opt_state)
        if zero.offload != bool(offload_opt_state):
            raise ValueError(f"offload_opt_state={offload_opt_state} but the optimizer was built with "
                             f"offload={zero.offload}")

    def step(batch: Batch, *, generator: Optional[torch.Generator] = None,
             eps: Optional[Tensor] = None) -> Dict[str, Tensor]:
        eps_micro = None if eps is None else eps.chunk(max(num_micro, 1), dim=0)

        def loss(micro: Batch, index: int):
            return vae_loss_fn(
                model, micro, loss_cfg=loss_cfg, step_cfg=step_cfg, ref_model=ref_model,
                lpips_fn=lpips_fn, generator=generator, mesh=mesh,
                eps=None if eps_micro is None else eps_micro[index],
            )

        _, metrics = accumulated_grads(
            loss, params, batch, num_micro,
            micro_weight_fn=(lambda mb: mb["weights"].sum()) if "weights" in batch else None,
        )
        if zero is not None:
            w_local = batch["weights"].sum() if "weights" in batch else None
            grad_norm = zero.step(w_local)
            metrics = weighted_mean_over_ranks(metrics, w_local, mesh)
        else:
            grad_norm = global_norm([p.grad for p in params if p.grad is not None])
            optimizer.clipped_step(grad_norm)
        metrics["train/grad_norm"] = grad_norm
        return metrics

    return step


def resolve_background_spec(spec):
    """'white' / 'black' / scalar / sequence -> background value."""
    if isinstance(spec, str):
        lowered = spec.lower()
        if lowered == "white":
            return 1.0
        if lowered == "black":
            return 0.0
        raise ValueError(f"Unknown background spec '{spec}'.")
    return spec


def make_eval_step(model: RgbaVAE, *, mesh: Optional[Mesh] = None,
                   background_specs: Sequence = ("white", "black")):
    """Build the validation step `step(images, *, generator=None, eps=None)`:
    a sampled forward, PSNR over each background composite, alpha MAE.
    Returns per-sample vectors ("psnr_<spec>", "alpha_mae") and the
    reconstruction ("recon"), so the caller aggregates across batches.

    With a `mesh`, `images` (and `eps`) is the whole batch on every process
    (its rows a multiple of the processes); each process runs its rows, the
    noise drawn as in the train step, and every output is gathered back to
    the whole batch on every process."""
    backgrounds = [(str(s), resolve_background_spec(s)) for s in background_specs]

    @torch.no_grad()
    def step(images: Tensor, *, generator: Optional[torch.Generator] = None,
             eps: Optional[Tensor] = None) -> Dict[str, Tensor]:
        images = ensure_alpha(torch.clamp(images, 0.0, 1.0))
        if mesh is not None:
            images = local_rows(images, mesh)
            eps = None if eps is None else local_rows(eps, mesh)
        # RgbaVAE.forward, with the noise drawn once the latent shape is known
        posterior = model.encode(to_vae_range(images).to(model.compute_dtype))
        if eps is None and mesh is not None:
            eps = randn_rows(posterior.mean.shape, generator, mesh, device=posterior.mean.device)
        z = posterior.sample(eps, generator=generator, dtype=model.compute_dtype)
        recon = torch.clamp(from_vae_range(model.decode(z).float()), 0.0, 1.0)
        out = {}
        for name, bg in backgrounds:
            out[f"psnr_{name}"] = psnr(composite_over_background(recon, bg),
                                       composite_over_background(images, bg))
        out["alpha_mae"] = alpha_mae(recon, images)
        out["recon"] = recon
        if mesh is not None:
            out = {k: global_rows(v.contiguous(), mesh) for k, v in out.items()}
        return out

    return step
