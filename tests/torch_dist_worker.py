"""Run a function of this module on N gloo ranks, for the port's parallel
tests (`tests/test_torch_zero_step.py`, `tests/test_torch_parallel_loop.py`,
`tests/test_torch_tensor_parallel.py`, `tests/test_torch_parallel_axes.py`).

`spawn(name, world, tmp_path, payload)` saves `payload` with torch.save,
starts `world` spawned processes that join one gloo group through a
`file://` rendezvous in `tmp_path` (with a timeout), each running
`name(rank, world, payload, tmp_path)` with one torch thread, and returns
each rank's result (and what `meanwhile()` returned, which runs here while
the ranks do). A rank that fails passes its traceback on; a rank that has
not ended 60 s after that (or after the start) is killed and the call
fails, so a hung rendezvous never holds the suite. This module imports torch and the port
only: the children never load JAX.
"""
from __future__ import annotations

import datetime
import multiprocessing
import time
import traceback
from pathlib import Path

import numpy as np
import torch

JOIN_SECONDS = 60


def noise_decides(name) -> bool:
    """The attention key bias: its true gradient is zero (softmax ignores a
    constant key shift), so rounding noise decides AdamW's update there."""
    return "to_k" in str(name) and "bias" in str(name)


def assert_close_after_adamw(got: dict, want: dict, what: str, *, lr: float, rtol: float = 1e-5) -> None:
    """Each tensor's mean error within `rtol` of its largest entry plus 1e-3
    of one update (lr), and no entry beyond one update: AdamW divides by
    sqrt(v), so where a gradient is near zero (a cancellation) its rounding
    noise in another summation order decides a visible part of the update of
    that entry, and a tensor that started at zero holds nothing but updates."""
    assert set(got) == set(want), what
    for k in want:
        if noise_decides(k):
            continue
        w, g = want[k].double(), got[k].double()
        err = (g - w).abs()
        bound = rtol * float(w.abs().max()) + 1e-3 * lr
        assert float(err.mean()) <= bound and float(err.max()) <= lr, (
            f"{what} {k}: mean error {float(err.mean()):.3g} against {bound:.3g}, max error "
            f"{float(err.max()):.3g} against {lr}")


def _entry(name: str, rank: int, world: int, tmp: str) -> None:
    tmp_path = Path(tmp)
    try:
        torch.set_num_threads(1)
        from ragb_vae_tpu_torch.parallel.mesh import maybe_init_distributed

        maybe_init_distributed("cpu", init_method=f"file://{tmp_path / 'rendezvous'}", world_size=world,
                               rank=rank, timeout=datetime.timedelta(seconds=JOIN_SECONDS))
        payload = torch.load(tmp_path / "payload.pt", weights_only=False)
        result = globals()[name](rank, world, payload, tmp_path)
        torch.save(result, tmp_path / f"result_{rank}.pt")
        torch.distributed.destroy_process_group()
    except BaseException:
        (tmp_path / f"error_{rank}.txt").write_text(traceback.format_exc())
        raise


def spawn(name: str, world: int, tmp_path: Path, payload, meanwhile=None):
    """-> each rank's result; with `meanwhile`, (those, `meanwhile()`), which
    runs in this process while the ranks do."""
    tmp_path = Path(tmp_path)
    tmp_path.mkdir(parents=True, exist_ok=True)
    torch.save(payload, tmp_path / "payload.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(name, r, world, str(tmp_path)), daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    try:
        local = meanwhile() if meanwhile is not None else None
    finally:
        deadline = time.monotonic() + JOIN_SECONDS
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [(tmp_path / f"error_{r}.txt") for r in range(world)]
    messages = [f"rank {r}:\n{e.read_text()}" for r, e in enumerate(errors) if e.exists()]
    if hung or messages or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"ranks {hung} still running {JOIN_SECONDS} s into the join; exit codes "
                             f"{[p.exitcode for p in procs]}\n" + "\n".join(messages))
    results = [torch.load(tmp_path / f"result_{r}.pt", weights_only=False) for r in range(world)]
    return results if meanwhile is None else (results, local)


# ---------------------------------------------------------------------------
# The ZeRO-2 step on the tiny RgbaVAE
# ---------------------------------------------------------------------------
def zero_steps(rank: int, world: int, payload: dict, tmp_path: Path, *, mesh=None) -> dict:
    """Each case of `payload["cases"]`: a fresh tiny RgbaVAE from
    `payload["state"]`, two ZeRO-2 steps over this rank's rows of the global
    batches (images, weights, injected eps), -> per step the metrics, then
    the parameters and the gathered optimizer state dict."""
    from ragb_vae_tpu_torch.models.losses import AlphaVaeLossConfig
    from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
    from ragb_vae_tpu_torch.parallel.mesh import create_mesh, local_rows
    from ragb_vae_tpu_torch.training import vae_step as tvs

    mesh = mesh or create_mesh()
    out = {}
    for case in payload["cases"]:
        model = RgbaVAE(payload["config"])
        model.module.load_state_dict(payload["state"], strict=True)
        optimizer = tvs.make_optimizer(tvs.trainable_parameters(model), payload["lr"],
                                       max_grad_norm=payload["max_grad_norm"])
        zero = tvs.init_train_state(model, optimizer, mesh=mesh, offload=case["offload"])
        step = tvs.make_train_step(
            model, zero, AlphaVaeLossConfig(reduce_mean=True),
            tvs.VaeStepConfig(kl_scale=payload["kl_scale"], gradient_accumulation_steps=case["accum"]),
            mesh=mesh, offload_opt_state=case["offload"])
        metrics = []
        for images, eps in zip(payload["images"], payload["eps"]):
            batch = {"images": local_rows(torch.from_numpy(images), mesh)}
            if case["weights"] is not None:
                batch["weights"] = local_rows(torch.from_numpy(np.asarray(case["weights"], np.float32)), mesh)
            got = step(batch, eps=local_rows(torch.from_numpy(eps), mesh))
            metrics.append({k: float(v) for k, v in got.items()})
        out[case["name"]] = {
            "metrics": metrics,
            "params": {k: v.clone() for k, v in model.module.state_dict().items()},
            "optimizer": zero.state_dict(),
            "moments_on_cpu": all(t.device.type == "cpu" for t in zero.moments().values()),
        }
    if "partial" in payload:
        out["partial"] = partial_state_loads(payload["partial"], mesh)
    return out


def partial_state_loads(partial: dict, mesh) -> dict:
    """A `ClippedAdamW` state dict in which one of two parameters has no
    state, taken by `ZeroAdamW` over `mesh` both ways: from the wrapped
    optimizer's state and through `load_state_dict` -> each way's slice
    (step, moments) and its gathered state dict."""
    from ragb_vae_tpu_torch.parallel.zero_step import ZeroAdamW
    from ragb_vae_tpu_torch.training.vae_step import ClippedAdamW

    def fresh():
        params = [torch.nn.Parameter(t.clone()) for t in partial["params"]]
        return params, ClippedAdamW(params, 1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.01, max_grad_norm=1.0)

    out = {}
    _, opt = fresh()
    opt.load_state_dict(partial["state_dict"])
    ways = {"wrapped": lambda: ZeroAdamW(opt, mesh)}

    def through_load():
        zero = ZeroAdamW(fresh()[1], mesh)
        zero.load_state_dict(partial["state_dict"])
        return zero

    ways["load_state_dict"] = through_load
    for name, make in ways.items():
        zero = make()
        state = zero.state[zero.shard]
        out[name] = {"step": float(state["step"]), **{k: v.clone() for k, v in zero.moments().items()},
                     "state_dict": zero.state_dict()}
    return out


# ---------------------------------------------------------------------------
# The stage-1 loop, the preemption flag and the LoRA stage
# ---------------------------------------------------------------------------
def tiny_lora_model():
    """The LoRA stage tests' tiny FLUX-Kontext model (`tests/test_torch_lora_stage.py::_tiny_model`)."""
    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel
    from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig
    from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig

    vcfg = AutoencoderConfig.tiny()
    vcfg.in_channels = vcfg.out_channels = 4
    return FluxTextAlphaModel.random(FluxTransformerConfig.tiny(), vcfg, seed=0, device="cpu", prompt_len=4)


def loop_runs(rank: int, world: int, payload: dict, tmp_path: Path) -> dict:
    """Three polls of a guard that rank 1 flags before the second; the
    stage-1 configs of `payload["stages"]` in order; one LoRA run of
    `payload["lora"]` -> the polls, each run's metrics and the adapters."""
    from ragb_vae_tpu_torch.models.flux_weights import lora_state
    from ragb_vae_tpu_torch.training import flux_kontext_textalpha_lora as lora
    from ragb_vae_tpu_torch.training.rgba_vae_stage import train_rgba_vae
    from ragb_vae_tpu_torch.utils.preemption import PreemptionGuard

    guard, polls = PreemptionGuard(enabled=False), []
    for i in range(3):
        if rank == 1 and i == 1:
            guard.request_stop()
        polls.append(guard.should_stop(sync=True))
    stages = [train_rgba_vae(cfg, device="cpu") for cfg in payload["stages"]]
    model = tiny_lora_model()
    lora_metrics = lora.train_from_config(payload["lora"], model=model, device="cpu")
    return {"polls": polls, "stages": stages, "lora": lora_metrics,
            "adapters": {k: v.clone() for k, v in lora_state(model.transformer).items()}}


# ---------------------------------------------------------------------------
# Tensor parallel: the sample, the int8 shards and the LoRA gradients
# ---------------------------------------------------------------------------
TP_RANK, TP_ALPHA = 4, 6.0


def tp_model(payload: dict, dtype=torch.float32):
    """The payload's tiny FLUX-Kontext model, whole (rank-4 fp32 adapters
    from the payload's state, per-block recompute; the base and the VAE in
    `dtype`, the AdaLN modulation fp32)."""
    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel
    from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformer2D, freeze_base_parameters
    from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
    from ragb_vae_tpu_torch.models.scheduler import FlowMatchEulerScheduler

    transformer = FluxTransformer2D(payload["config"], lora_rank=TP_RANK, lora_alpha=TP_ALPHA, remat=True,
                                    dtype=dtype)
    transformer.load_state_dict(payload["state"], strict=True)
    freeze_base_parameters(transformer)
    vae = RgbaVAE(payload["vae_config"], fused=True, dtype=dtype)
    vae.module.load_state_dict(payload["vae_state"], strict=True)
    return FluxTextAlphaModel(transformer.eval(), vae, FlowMatchEulerScheduler(),
                              *(torch.from_numpy(payload[k]) for k in ("prompt", "pooled", "text_ids")),
                              lora_rank=TP_RANK, lora_alpha=TP_ALPHA, dtype=dtype)


def _tp_sample(model, payload: dict) -> dict:
    t = {k: torch.from_numpy(payload[k]) for k in ("gt", "eps", "init", "noises")}
    with torch.no_grad():
        cond = model.encode_latents(t["gt"], t["eps"])
        final, traj = model.sample_latents_from_noise(cond, t["init"], t["noises"], return_trajectory=True)
        return {"traj": traj, "image": model.decode_latents(final)}


def tp_case(model, payload: dict, tp) -> dict:
    """On a whole model (`tp` of size 1) or this rank's shard: the sample
    with injected noise, the LoRA loss and its adapter-gradient tree (summed
    over the model group), the bytes of each shard, then the same sample over
    the int8 transformer and the int8 entries."""
    from ragb_vae_tpu_torch.models.flux_weights import lora_grads_to_flax, lora_parameters
    from ragb_vae_tpu_torch.models.quantize import quantize_module_
    from ragb_vae_tpu_torch.parallel.tensor_parallel import COUNTS, reset_counts, sum_grads_over

    out = {"sample": _tp_sample(model, payload)}
    reset_counts()
    lat = [torch.from_numpy(a) for a in payload["latents"]]
    loss, _ = model.compute_loss_from_latents(*lat, torch.from_numpy(payload["u"]))
    loss.backward()
    sum_grads_over(list(lora_parameters(model.transformer).values()), tp)
    out["lora"] = {"loss": loss.item(), "grads": lora_grads_to_flax(model.transformer), "counts": dict(COUNTS)}
    out["bytes"] = {k: v.numel() * v.element_size() for k, v in model.transformer.state_dict().items()}
    quantize_module_(model.transformer)
    out["int8"] = {"sample": _tp_sample(model, payload),
                   "entries": {k: v.clone() for k, v in model.transformer.state_dict().items()
                               if k.endswith(("weight_q", "weight_scale"))}}
    return out


def tp_loads(payload: dict, tp) -> dict:
    """The transformer state of `from_pretrained(tp=)` from each checkpoint
    of `payload["checkpoints"]` ((label, model dir, weight_quant))."""
    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel

    out = {}
    for label, path, quant in payload["checkpoints"]:
        model = FluxTextAlphaModel.from_pretrained(path, vae_path=payload["vae_dir"], device="cpu",
                                                   weight_quant=quant, tp=tp)
        out[label] = {k: v.clone() for k, v in model.transformer.state_dict().items()}
    return out


IDLE_TIMEOUT_S = 2.0           # the serving group's timeout in `tp_idle_serving`
IDLE_S = 5.0                   # how long its server waits for a request


def tp_served(model, mesh, payload: dict, idle_s: float = 0.0) -> dict:
    """One request (`payload["serve_image"]`, seed 3) through a started
    `InferenceServer(tp_group=mesh)` on rank 0 after `idle_s` seconds without
    any, the other ranks in `serve_worker`: rank 0's answer, or a worker's
    batch count."""
    from ragb_vae_tpu_torch.serving import InferenceServer, ServeConfig

    server = InferenceServer(model, ServeConfig(max_batch=1, steps=2, auto_batch=False), tp_group=mesh)
    if mesh.rank > 0:
        return {"batches": server.serve_worker()}
    with server:
        time.sleep(idle_s)
        answer = server.submit(payload["serve_image"], seed=3).result(timeout=JOIN_SECONDS)
    return {"answer": answer}


def tp_idle_serving(model, rank: int, world: int, payload: dict) -> dict:
    """`tp_served` over a group of the whole world whose collectives time
    out after IDLE_TIMEOUT_S, left idle for IDLE_S first: the workers wait
    through 2.5 timeouts for the request's header."""
    from ragb_vae_tpu_torch.parallel.mesh import Mesh

    group = torch.distributed.new_group(list(range(world)), timeout=datetime.timedelta(seconds=IDLE_TIMEOUT_S))
    return tp_served(model, Mesh(world, rank, group), payload, IDLE_S)


def tp_runs(rank: int, world: int, payload: dict, tmp_path: Path) -> dict:
    """`tp_idle_serving` and `tp_case` on this rank's shard over a model axis
    of the whole world, and `tp_loads`."""
    from ragb_vae_tpu_torch.parallel.mesh import create_training_mesh
    from ragb_vae_tpu_torch.parallel.tensor_parallel import shard_transformer_

    _, tp, _ = create_training_mesh(tp=world)
    model = tp_model(payload)
    shard_transformer_(model.transformer, tp)
    idle = tp_idle_serving(model, rank, world, payload)
    return {**tp_case(model, payload, tp), "loads": tp_loads(payload, tp), "idle": idle}


def tp_train_steps(rank: int, world: int, payload: dict, tmp_path: Path, *, tp: int = 2, sp: int = 1,
                   fsdp: bool = False) -> dict:
    """Two steps of `make_lora_train_step` at (data world / (tp sp), model
    tp, sequence sp), the base FSDP-split over the data group with `fsdp`:
    this rank's data rows of each global batch, ZeroAdamW over the data
    group -> the losses, gradient norms and adapters after each step."""
    from ragb_vae_tpu_torch.models.flux_weights import lora_parameters, lora_state
    from ragb_vae_tpu_torch.parallel.fsdp import shard_base_
    from ragb_vae_tpu_torch.parallel.mesh import create_training_mesh, local_rows
    from ragb_vae_tpu_torch.parallel.tensor_parallel import shard_transformer_
    from ragb_vae_tpu_torch.parallel.zero_step import ZeroAdamW
    from ragb_vae_tpu_torch.training.flux_kontext_textalpha_lora import make_lora_optimizer, make_lora_train_step

    data, model_mesh, seq = create_training_mesh(tp=tp, sp=sp)
    model = tp_model(payload)
    shard_transformer_(model.transformer, model_mesh)
    if fsdp:
        shard_base_(model.transformer, data)
    model.seq = seq
    optimizer = ZeroAdamW(make_lora_optimizer(list(lora_parameters(model.transformer).values()),
                                              payload["lr"]), data)
    step = make_lora_train_step(model, optimizer, 1, mesh=data, model_mesh=model_mesh, seq_mesh=seq)
    generator = torch.Generator().manual_seed(payload["seed"])
    out = []
    for gt, ta in payload["batches"]:
        batch = {"gt": local_rows(torch.from_numpy(gt), data), "text_alpha": local_rows(torch.from_numpy(ta), data)}
        loss, _, grad_norm = step(batch, generator)
        out.append({"loss": float(loss), "grad_norm": float(grad_norm),
                    "adapters": {k: v.clone() for k, v in lora_state(model.transformer).items()}})
    return {"steps": out}


def tp_stage(cfg: dict) -> dict:
    """The LoRA stage's own loop on the tiny model -> its result and adapters."""
    from ragb_vae_tpu_torch.models.flux_weights import lora_state
    from ragb_vae_tpu_torch.training import flux_kontext_textalpha_lora as lora

    model = tiny_lora_model()
    result = lora.train_from_config(cfg, model=model, device="cpu")
    return {"result": result, "adapters": {k: v.clone() for k, v in lora_state(model.transformer).items()}}


def tp_world4(rank: int, world: int, payload: dict, tmp_path: Path) -> dict:
    """`tp_train_steps` at (data 2, model 2), then the LoRA stage through
    `train_from_config` with `tensor_parallel: 2`."""
    return {**tp_train_steps(rank, world, payload, tmp_path), "stage": tp_stage(payload["stage"])}


# ---------------------------------------------------------------------------
# FSDP of the base and sequence parallelism
# ---------------------------------------------------------------------------
def _segments_local(t: torch.Tensor, segments, mesh, dim: int = 2) -> torch.Tensor:
    """This rank's part of each stream of `t` (streams of `segments` lengths
    end to end along `dim`), end to end: the local tokens of a joint stream."""
    from ragb_vae_tpu_torch.parallel.sequence_parallel import local_part

    parts, start = [], 0
    for n in segments:
        parts.append(local_part(t.narrow(dim, start, n), mesh, dim))
        start += n
    return torch.cat(parts, dim=dim)


def sp_attention(payload: dict, seq) -> dict:
    """`attention(seq=)` on this rank's tokens of each case of
    `payload["attention"]` (q, k, v, dO and the streams' lengths) -> this
    rank's output and q, k, v gradients."""
    from ragb_vae_tpu_torch.ops.kernels.flash_attention import attention

    out = {}
    for label, case in payload["attention"].items():
        segments = case["segments"]
        q, k, v = (_segments_local(torch.from_numpy(case[n]), segments, seq).requires_grad_(True) for n in "qkv")
        local = tuple(n // seq.size for n in segments)
        o = attention(q, k, v, seq=seq, segments=local if seq.size > 1 else None)
        o.backward(_segments_local(torch.from_numpy(case["g"]), segments, seq))
        out[label] = {"out": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    return out


def sp_case(payload: dict, seq) -> dict:
    """On the whole model over a sequence axis `seq` (size 1: one process):
    the LoRA loss and its adapter-gradient tree (summed over the group) with
    the collectives it made, the sample with injected noise in fp32, bf16
    and over the int8 transformer with the all-gathers of each, and over a
    prompt of 3 tokens (a stream sp 2 does not divide) the loss and one step
    of `make_lora_train_step`."""
    from ragb_vae_tpu_torch.models.flux_weights import lora_grads_to_flax, lora_parameters
    from ragb_vae_tpu_torch.models.quantize import quantize_module_
    from ragb_vae_tpu_torch.parallel import sequence_parallel as spm
    from ragb_vae_tpu_torch.parallel.mesh import Mesh
    from ragb_vae_tpu_torch.parallel.tensor_parallel import sum_grads_over
    from ragb_vae_tpu_torch.parallel.zero_step import ZeroAdamW
    from ragb_vae_tpu_torch.training.flux_kontext_textalpha_lora import make_lora_optimizer, make_lora_train_step

    def lora(model):
        spm.reset_counts()
        lat = [torch.from_numpy(a) for a in payload["latents"]]
        loss, _ = model.compute_loss_from_latents(*lat, torch.from_numpy(payload["u"]))
        loss.backward()
        if model.sequence_sharded(32, 32):      # the latents' images: 32^2
            sum_grads_over(list(lora_parameters(model.transformer).values()), seq)
        return {"loss": loss.item(), "grads": lora_grads_to_flax(model.transformer), "counts": dict(spm.COUNTS)}

    def sample(model):
        spm.reset_counts()
        return {**_tp_sample(model, payload), "counts": dict(spm.COUNTS)}

    out = {}
    model = tp_model(payload)
    model.seq = seq
    out["lora"] = lora(model)
    out["sample"] = sample(model)
    quantize_module_(model.transformer)
    out["int8"] = sample(model)
    bf16 = tp_model(payload, torch.bfloat16)
    bf16.seq = seq
    out["bf16"] = sample(bf16)
    def odd_model():
        odd = tp_model(payload)
        odd.seq = seq
        odd.prompt_embeds, odd.text_ids = odd.prompt_embeds[:, :3], odd.text_ids[:3]
        return odd

    out["odd"] = lora(odd_model())
    # the stage's own step on it: no sum over the group where nothing was split
    odd = odd_model()
    params = list(lora_parameters(odd.transformer).values())
    step = make_lora_train_step(odd, ZeroAdamW(make_lora_optimizer(params, payload["lr"]), Mesh()), 1,
                                mesh=Mesh(), seq_mesh=seq)
    gt, ta = (torch.from_numpy(a[:1]) for a in payload["batches"][0])
    loss, _, grad_norm = step({"gt": gt, "text_alpha": ta}, torch.Generator().manual_seed(payload["seed"]))
    out["odd_step"] = {"loss": float(loss), "grad_norm": float(grad_norm)}
    return out


def fsdp_case(payload: dict, data) -> dict:
    """At the data axis `data`: this rank's rows of the LoRA loss with the
    base whole and FSDP-split, in bf16 and over int8 -> both runs' loss and
    adapter gradients, the bytes each holds and the FSDP run's gathers."""
    from ragb_vae_tpu_torch.models.flux_weights import lora_parameters
    from ragb_vae_tpu_torch.models.quantize import quantize_module_
    from ragb_vae_tpu_torch.parallel import fsdp
    from ragb_vae_tpu_torch.parallel.mesh import local_rows

    lat = [local_rows(torch.from_numpy(a), data) for a in payload["latents"]]
    u = local_rows(torch.from_numpy(payload["u"]), data)
    out = {}
    for label, dtype, int8 in (("bf16", torch.bfloat16, False), ("int8", torch.float32, True)):
        runs = {}
        for split in (False, True):
            model = tp_model(payload, dtype)
            if split:
                fsdp.shard_base_(model.transformer, data)
            if int8:
                quantize_module_(model.transformer)
            fsdp.reset_counts()
            loss, _ = model.compute_loss_from_latents(*lat, u)
            loss.backward()
            runs["fsdp" if split else "whole"] = {
                "loss": loss.detach(), "counts": dict(fsdp.COUNTS), "bytes": fsdp.shard_bytes(model.transformer),
                "grads": {k: p.grad.clone() for k, p in lora_parameters(model.transformer).items()}}
        out[label] = runs
    return out


def fsdp_loads(payload: dict, data) -> dict:
    """`from_pretrained(fsdp=)` from each checkpoint of `payload["checkpoints"]`."""
    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel

    out = {}
    for label, path, quant in payload["checkpoints"]:
        model = FluxTextAlphaModel.from_pretrained(path, vae_path=payload["vae_dir"], device="cpu",
                                                   weight_quant=quant, fsdp=data)
        out[label] = {k: v.clone() for k, v in model.transformer.state_dict().items()}
    return out


def axes_stage(cfg: dict) -> dict:
    """The LoRA stage's own loop on the tiny model -> its result, adapters,
    the bytes of the base the process held and its sequence collectives."""
    from ragb_vae_tpu_torch.models.flux_weights import lora_state
    from ragb_vae_tpu_torch.parallel import sequence_parallel as spm
    from ragb_vae_tpu_torch.parallel.fsdp import shard_bytes
    from ragb_vae_tpu_torch.training import flux_kontext_textalpha_lora as lora

    model = tiny_lora_model()
    spm.reset_counts()
    result = lora.train_from_config(cfg, model=model, device="cpu")
    return {"result": result, "adapters": {k: v.clone() for k, v in lora_state(model.transformer).items()},
            "bytes": shard_bytes(model.transformer), "seq_counts": dict(spm.COUNTS)}


def _small_leaves_split(payload: dict) -> None:
    """Split leaves down to `payload["min_size"]` elements: JAX's 2**16 would
    leave every leaf of the tiny model whole."""
    from ragb_vae_tpu_torch.parallel import sharding

    sharding.DEFAULT_MIN_SHARD_SIZE = payload["min_size"]


def axes_world2(rank: int, world: int, payload: dict, tmp_path: Path) -> dict:
    """Sequence axis 2: `sp_attention` and `sp_case`; data axis 2: `fsdp_case`,
    `fsdp_loads` and the LoRA stage with `shard_base_params`."""
    from ragb_vae_tpu_torch.parallel.mesh import create_training_mesh

    _small_leaves_split(payload)
    data, _, _ = create_training_mesh()
    _, _, seq = create_training_mesh(sp=world)
    return {"attention": sp_attention(payload, seq), "sp": sp_case(payload, seq),
            "fsdp": fsdp_case(payload, data), "loads": fsdp_loads(payload, data),
            "stage": axes_stage(payload["stage"])}


def axes_world4(rank: int, world: int, payload: dict, tmp_path: Path) -> dict:
    """Two LoRA steps at (data 2, sequence 2) with the base FSDP-split, then
    at (model 2, sequence 2); the LoRA stage with `sequence_parallel: 2` and
    `shard_base_params`."""
    _small_leaves_split(payload)
    return {"dp2_sp2_fsdp": tp_train_steps(rank, world, payload, tmp_path, tp=1, sp=2, fsdp=True),
            "tp2_sp2": tp_train_steps(rank, world, payload, tmp_path, tp=2, sp=2),
            "stage": axes_stage(payload["stage_sp"])}
