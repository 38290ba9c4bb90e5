"""ZeRO-2 over the data axis: gradients and AdamW state partitioned, parameters
replicated.

Counterpart of `ragb_vae_tpu/parallel/zero_step.py` (the literal DeepSpeed
ZeRO-2 dataflow of the reference's configs/deepspeed_zero2.json), over a
`torch.distributed` group instead of a `shard_map`. After every rank's
backward has left the gradient of ITS rows in `.grad` (a weighted mean over
those rows), `ZeroAdamW.step`:

  1. lays the gradients end to end in one fp32 buffer (`sharding.FlatLayout`,
     zero-padded to a multiple of the ranks);
  2. scales it by the rank's weight sum, reduce-scatters it (sum), and
     divides this rank's slice by the all-reduced global weight sum: the
     gradient of the weighted mean over ALL rows, whichever rank the padding
     rows (weight 0) fell on. A plain mean of the per-rank means is wrong as
     soon as the ranks' weight sums differ;
  3. clips by the global norm: the slice's sum of squares, all-reduced, and
     optax's `max / max(norm, max)`;
  4. runs AdamW on this rank's slice only: the moments exist for 1/N of the
     parameters on each rank;
  5. all-gathers the updated slices back into every rank's parameters.

AdamW is elementwise and the norm global, so the update is the single-device
`ClippedAdamW`'s (`training/vae_step.py`). `offload=True` keeps the moments in
pinned host memory between steps and copies them to the device
(`non_blocking`) for the update and back after it, as the JAX package's
`optimizer_offload` parks them in `pinned_host`.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ragb_vae_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce, reduce_scatter
from ragb_vae_tpu_torch.parallel.sharding import FlatLayout

Tensor = torch.Tensor
MOMENTS = ("exp_avg", "exp_avg_sq")

# collectives made by `ZeroAdamW.step` over a data axis above size 1 since the last reset
COUNTS = {"reduce_scatter": 0, "all_gather": 0, "all_reduce": 0}


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


class ZeroAdamW:
    """AdamW over this rank's slice of the flat parameter buffer.

    Built from the single-device optimizer it replaces (`ClippedAdamW`, or
    any one-group `torch.optim.AdamW` with a `max_grad_norm` attribute): its
    hyperparameters, its parameters, any state it already holds, and the
    layout of its `state_dict()`, which `state_dict` / `load_state_dict`
    keep. `param_groups` and `state` are the inner optimizer's, so a
    schedule sets the learning rate as it would on the single-device one."""

    def __init__(self, optimizer: torch.optim.Optimizer, mesh: Mesh, *, offload: bool = False):
        if len(optimizer.param_groups) != 1:
            raise ValueError("ZeroAdamW takes an optimizer with one parameter group")
        group = optimizer.param_groups[0]
        self.template = optimizer
        self.mesh = mesh
        self.offload = bool(offload)
        self.max_grad_norm = getattr(optimizer, "max_grad_norm", None)
        self.params = list(group["params"])
        self.layout = FlatLayout.of(self.params, mesh.size)
        self.shard = self._param_slice().requires_grad_(True)
        self.inner = torch.optim.AdamW([self.shard], lr=group["lr"], betas=group["betas"], eps=group["eps"],
                                       weight_decay=group["weight_decay"])
        self._host: Dict[str, Tensor] = {}
        if any(optimizer.state.get(p) for p in self.params):
            self._take_template_state()
        else:
            self.inner.state[self.shard] = {
                "step": torch.tensor(0.0, dtype=torch.float32),
                "exp_avg": torch.zeros_like(self.shard),
                "exp_avg_sq": torch.zeros_like(self.shard),
            }
            self._park()

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        """The inner optimizer's state: {slice: {"step", "exp_avg", "exp_avg_sq"}}."""
        return self.inner.state

    @property
    def device(self) -> torch.device:
        return self.shard.device

    def _param_slice(self) -> Tensor:
        return self.layout.slice_of([p.detach() for p in self.params], self.mesh.rank, like=self.params[0])

    # -- the moments between steps ----------------------------------------
    def moments(self) -> Dict[str, Tensor]:
        """The slice's AdamW moments as they lie between steps."""
        state = self.inner.state[self.shard]
        return {k: state[k] for k in MOMENTS}

    def _park(self) -> None:
        """With offload: moments -> (pinned, on the card) host buffers."""
        if not self.offload:
            return
        state = self.inner.state[self.shard]
        for k in MOMENTS:
            if state[k].device.type == "cpu" and k in self._host:
                continue
            host = self._host.get(k)
            if host is None:
                host = self._host[k] = torch.empty(state[k].shape, dtype=state[k].dtype, device="cpu",
                                                   pin_memory=state[k].is_cuda)
            host.copy_(state[k], non_blocking=True)
            state[k] = host

    def _unpark(self) -> None:
        if not self.offload:
            return
        state = self.inner.state[self.shard]
        for k in MOMENTS:
            state[k] = state[k].to(self.device, non_blocking=True)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # -- the update ---------------------------------------------------------
    def step(self, w_local: Optional[Tensor] = None) -> Tensor:
        """Steps 1-5 of the module docstring over the gradients in `.grad`
        (a weighted mean over this rank's rows, whose weights sum to
        `w_local`; None counts every rank the same). Leaves `.grad` None and
        returns the global gradient norm before the clip."""
        mesh = self.mesh
        self.shard.data.copy_(self._param_slice())     # the parameters may have been loaded since
        flat = self.layout.flatten([p.grad for p in self.params], like=self.shard)
        for p in self.params:
            p.grad = None
        if mesh.size > 1:
            w = torch.ones((), device=self.device) if w_local is None else w_local.detach().float().reshape(())
            w_global = torch.clamp(all_reduce(w.clone(), mesh), min=1e-8)
            grad = reduce_scatter(flat.mul_(w), mesh).div_(w_global)
            COUNTS["reduce_scatter"] += 1
            COUNTS["all_reduce"] += 2
            COUNTS["all_gather"] += 1
        else:
            grad = flat
        grad_norm = torch.sqrt(all_reduce(torch.sum(grad * grad), mesh))
        if self.max_grad_norm is not None:
            grad.mul_(self.max_grad_norm / torch.clamp(grad_norm, min=self.max_grad_norm))
        self.shard.grad = grad
        self._unpark()
        self.inner.step()
        self._park()
        self.shard.grad = None
        full = all_gather(self.shard.detach(), mesh)
        self.layout.unflatten_into(full, [p.detach() for p in self.params])
        return grad_norm

    # -- checkpoints: the single-device layout ------------------------------
    def state_dict(self) -> dict:
        """The state dict the single-device optimizer would write: the
        moments gathered from every rank into per-parameter tensors (views of
        one gathered buffer, or at one rank of the live state, as
        `torch.optim` hands out its live state). A collective: every rank
        must call it."""
        self._sync()
        state = self.inner.state[self.shard]
        full = {k: state[k] if self.mesh.size == 1 else all_gather(state[k].to(self.device), self.mesh)
                for k in MOMENTS}
        sd = self.template.state_dict()
        sd["param_groups"][0]["lr"] = self.param_groups[0]["lr"]
        sd["state"] = {
            i: {"step": state["step"].clone(), **{k: full[k][off : off + n].view(p.shape) for k in MOMENTS}}
            for i, (p, off, n) in enumerate(zip(self.params, self.layout.offsets, self.layout.sizes))
        }
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        """Take this rank's slice of a single-device state dict (one written
        by `state_dict` over any number of ranks, or by `ClippedAdamW`)."""
        self.template.load_state_dict(state_dict)
        self._take_template_state()

    def _take_template_state(self) -> None:
        """The wrapped optimizer's state as this rank's slice. A parameter
        without state (`torch.optim.AdamW` makes it at the parameter's first
        gradient, so a single-device state dict may lack it) contributes zero
        moments. The flat shard keeps ONE step count, as optax and the JAX
        package's `zero_step.py` do: the largest of the entries that exist (0
        when none does)."""
        states = [self.template.state.get(p, {}) for p in self.params]
        group = self.template.param_groups[0]
        for key in ("lr", "betas", "eps", "weight_decay"):
            self.inner.param_groups[0][key] = group[key]
        steps = [float(s["step"]) for s in states if "step" in s]
        self.inner.state[self.shard] = {
            "step": torch.tensor(max(steps, default=0.0), dtype=torch.float32),
            **{k: self.layout.slice_of([s[k] if k in s else torch.zeros_like(p, dtype=torch.float32)
                                        for s, p in zip(states, self.params)], self.mesh.rank, like=self.shard)
               for k in MOMENTS},
        }
        self.template.state.clear()
        self._park()


def weighted_mean_over_ranks(metrics: Dict[str, Tensor], w_local: Optional[Tensor], mesh: Mesh) -> Dict[str, Tensor]:
    """Each scalar metric (a weighted mean over this rank's rows, weights
    summing to `w_local`) as the weighted mean over every rank's rows, in one
    all-reduce."""
    if mesh.size == 1 or not metrics:
        return metrics
    names = list(metrics)
    values = torch.stack([metrics[k].detach().float().reshape(()) for k in names])
    w = torch.ones((), device=values.device) if w_local is None else w_local.detach().float().reshape(())
    packed = all_reduce(torch.cat([values * w, w.reshape(1)]), mesh)
    mean = packed[:-1] / torch.clamp(packed[-1], min=1e-8)
    return {k: mean[i] for i, k in enumerate(names)}
