#!/usr/bin/env python
"""The weight-drop rehearsal of the port at the published geometry.

The counterpart of `scripts/rehearse_real_geometry.py` for the PyTorch
package: the same flags, plus `--device` (default `cuda`; a missing card
raises, `--device cpu` runs on the host). It writes a synthetic checkpoint
directory in the published FLUX.1-Kontext-dev layout, with the key names and
shapes the port's own modules declare (`FluxTransformer2D` and
`AutoencoderKL` built on the meta device: 1160 transformer tensors, 11.90 B
parameters, 22.2 GiB of bf16 in 3 shards plus
`diffusion_pytorch_model.safetensors.index.json`; the RGB Flux `ae`, 244
tensors, 83.8 M), `scheduler/scheduler_config.json` and the empty prompt's
`empty_prompt_embeds.npz` (so no text encoder is needed), and pushes it
through the port's loaders onto `--device`:

  1. vae: the RGB `ae` (one safetensors file, random values from a seed)
     through `RgbaVAE.from_pretrained_rgb`, keys and shapes against the
     widened module's, a 256^2 encode and decode (the fused kernels on the
     card); the quant-conv variant through `load_autoencoder_params(...,
     adapt_to_rgba=True)` and a forward;
  2. goldens: `record_goldens_torch.record_vae` on that checkpoint (its
     manifest held against `tests/fixtures/flux_ae_keys.txt` at the
     published geometry), its model on `--device` held against the goldens,
     and the widened model of step 1 too;
  3. transformer: bf16 shards of zeros carrying an 8-value fingerprint a key
     (seeded by the key's sha256, as the JAX script's), read back through
     `load_flux_transformer_params` (keys, shapes, every fingerprint), the
     round trip `params_to_flux_state` -> `save_flux_transformer_params` ->
     reload, and `FluxTextAlphaModel.from_pretrained` in bf16 with every
     fingerprint found in its own parameter;
  4. LoRA: rank-16 adapters on every target (342 at the published
     geometry), peft export and reload, exact;
  5. int8: `from_pretrained(weight_quant="int8")` quantising at load, one
     forward (K10 on the card), and the output of
     `scripts/quantize_flux_checkpoint_torch.py` reloaded, bit-equal to it.

Each step prints its seconds, the GiB on disk, the host's peak resident set
while it ran (sampled) beside the process's (`resource.getrusage`), and the
device's peak. `--small` (2 + 4 blocks of 2 heads of 128, a 2-level `ae`
of 128 channels: widths the kernels take) keeps every path for the CPU
tests; the published geometry needs about 45 GiB of free disk.

    python scripts/rehearse_real_geometry_torch.py [--small] [--device cpu] [--workdir DIR --keep]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import resource
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import safetensors
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from ragb_vae_tpu_torch.device import resolve_device  # noqa: E402
from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformer2D, FluxTransformerConfig  # noqa: E402
from ragb_vae_tpu_torch.models.vae import AutoencoderKL  # noqa: E402
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig  # noqa: E402

KeyShapes = List[Tuple[str, Tuple[int, ...]]]
FIXTURES = REPO / "tests" / "fixtures"
LORA_RANK = 16
FINGERPRINT_LEN = 8


# ---------------------------------------------------------------------------
# The published geometry, from the port's own modules
# ---------------------------------------------------------------------------
def transformer_config(small: bool) -> FluxTransformerConfig:
    if small:
        return FluxTransformerConfig(
            num_layers=2, num_single_layers=4, num_attention_heads=2, joint_attention_dim=512,
            pooled_projection_dim=128)
    return FluxTransformerConfig()      # FLUX.1-Kontext-dev


def vae_config(small: bool, *, quant: bool = False) -> AutoencoderConfig:
    """The RGB Flux `ae` (`quant`: the SD / Qwen-style variant, latent 4 and quant convs)."""
    cfg = AutoencoderConfig.flux()
    if small:
        cfg = dataclasses.replace(cfg, block_out_channels=(128, 128), down_block_types=("DownEncoderBlock2D",) * 2,
                                  up_block_types=("UpDecoderBlock2D",) * 2, layers_per_block=1)
    if quant:
        cfg = dataclasses.replace(cfg, latent_channels=4, use_quant_conv=True, use_post_quant_conv=True)
    return cfg


def inventory(module: torch.nn.Module) -> KeyShapes:
    """(key, shape) of every entry of a module's state dict, in module order."""
    return [(k, tuple(v.shape)) for k, v in module.state_dict().items()]


def transformer_inventory(config: FluxTransformerConfig) -> KeyShapes:
    return inventory(FluxTransformer2D(config, device="meta"))


def vae_inventory(config: AutoencoderConfig) -> KeyShapes:
    return inventory(AutoencoderKL(config, device="meta"))


# ---------------------------------------------------------------------------
# Writers
# ---------------------------------------------------------------------------
def fingerprint(key: str, shape: Sequence[int], n: int = FINGERPRINT_LEN) -> np.ndarray:
    """The key's probe values, seeded by its sha256 (the JAX script's): the
    first `n` elements of the tensor, which pin its layout and transpose."""
    seed = int.from_bytes(hashlib.sha256(key.encode()).digest()[:4], "little")
    rng = np.random.default_rng(seed)
    k = min(n, int(np.prod(shape)))
    return (rng.standard_normal(k) * 0.02).astype(np.float32)


def fingerprinted(key: str, shape: Sequence[int]) -> torch.Tensor:
    """bf16 zeros of `shape` with the key's fingerprint at the front."""
    t = torch.zeros(tuple(shape), dtype=torch.bfloat16)
    fp = fingerprint(key, shape)
    t.view(-1)[: fp.size] = torch.from_numpy(fp).to(torch.bfloat16)
    return t


def write_sharded_transformer(keys: KeyShapes, out_dir: Path, make: Optional[Callable] = None,
                              n_shards: int = 3) -> int:
    """`make(key, shape)` of every entry (default `fingerprinted`) as bf16
    safetensors in `n_shards` files of about equal bytes, in order, and the
    index that names each entry's shard: the published layout. Only one
    shard is in host memory at a time. -> the bytes written."""
    from safetensors.torch import save_file

    make = make or fingerprinted
    out_dir.mkdir(parents=True, exist_ok=True)
    total = sum(2 * int(np.prod(s)) for _, s in keys)
    weight_map: Dict[str, str] = {}
    shard: Dict[str, torch.Tensor] = {}
    shard_bytes, index = 0, 1

    def flush() -> None:
        name = f"diffusion_pytorch_model-{index:05d}-of-{n_shards:05d}.safetensors"
        save_file(shard, str(out_dir / name))
        weight_map.update({k: name for k in shard})
        shard.clear()

    for key, shape in keys:
        shard[key] = make(key, shape).to(torch.bfloat16).contiguous()
        shard_bytes += 2 * int(np.prod(shape))
        if shard_bytes >= total * index / n_shards and index < n_shards:
            flush()
            index += 1
    flush()
    (out_dir / "diffusion_pytorch_model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}, indent=2))
    return total


def write_transformer_config(config: FluxTransformerConfig, out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = {"_class_name": "FluxTransformer2DModel",
           **{k: (list(v) if isinstance(v, tuple) else v) for k, v in config.__dict__.items()}}
    (out_dir / "config.json").write_text(json.dumps(cfg, indent=2))


def write_random_vae(config: AutoencoderConfig, out_dir: Path, seed: int) -> None:
    """config.json and one safetensors file of the VAE, fp32, drawn from `seed`
    at lecun-normal scale (norm scales 1, biases 0)."""
    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import init_random_
    from ragb_vae_tpu_torch.models.weights import save_autoencoder_params

    module = AutoencoderKL(config, device="meta").to_empty(device="cpu")
    init_random_(module, torch.Generator().manual_seed(seed))
    save_autoencoder_params(config, module.state_dict(), out_dir)


def write_model_dir(root: Path, prompt_embeds, pooled_prompt_embeds, text_ids) -> None:
    """scheduler/scheduler_config.json (the port's defaults, FLUX's) and
    empty_prompt_embeds.npz: what `from_pretrained` reads beside
    `transformer/`, with no text encoder."""
    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import save_empty_prompt_embeds
    from ragb_vae_tpu_torch.models.scheduler import FlowMatchEulerConfig

    (root / "scheduler").mkdir(parents=True, exist_ok=True)
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps(
        {"_class_name": "FlowMatchEulerDiscreteScheduler", **dataclasses.asdict(FlowMatchEulerConfig())}, indent=2))
    save_empty_prompt_embeds(root, prompt_embeds, pooled_prompt_embeds, text_ids)


def random_prompt(config: FluxTransformerConfig, seed: int, prompt_len: int = 512):
    """(prompt, pooled, text_ids) of the published shapes, drawn from `seed`."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, prompt_len, config.joint_attention_dim)),
            rng.standard_normal((1, config.pooled_projection_dim)), np.zeros((prompt_len, 3), np.float32))


# ---------------------------------------------------------------------------
# What each step costs
# ---------------------------------------------------------------------------
def rss_bytes() -> int:
    """This process's resident set now (Linux: /proc/self/statm)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def process_peak_bytes() -> int:
    """This process's peak resident set since it started (`resource.getrusage`; KiB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class HostPeak:
    """The resident set's peak while the block runs, sampled every 10 ms on a thread."""

    def __enter__(self) -> "HostPeak":
        self.peak = rss_bytes()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, name="host-peak", daemon=True)
        self._thread.start()
        return self

    def _sample(self) -> None:
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, rss_bytes())

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes())


def disk_bytes(root: Path) -> int:
    return sum(p.stat().st_size for p in Path(root).rglob("*") if p.is_file() and not p.is_symlink())


@contextlib.contextmanager
def step(name: str, root: Path, device: torch.device):
    """Run a step; print its seconds, the GiB under `root`, the host's peak
    resident set (the step's, sampled, and the process's) and the device's
    peak."""
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with HostPeak() as host:
        yield
        if on_card:
            torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    device_peak = f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB" if on_card else "none (CPU run)"
    print(f"[rehearse] step {name}: {seconds:.1f} s, {disk_bytes(root) / 2**30:.2f} GiB on disk, host peak RSS "
          f"{host.peak / 2**30:.2f} GiB (process {process_peak_bytes() / 2**30:.2f} GiB), device peak "
          f"{device_peak}", flush=True)


def _fail(msg: str) -> None:
    raise SystemExit(f"[rehearse] FAIL: {msg}")


def _check_inventory(what: str, got: KeyShapes, want: KeyShapes) -> None:
    got_d, want_d = dict(got), dict(want)
    missing, extra = sorted(set(want_d) - set(got_d)), sorted(set(got_d) - set(want_d))
    bad = [(k, got_d[k], want_d[k]) for k in want_d if k in got_d and got_d[k] != want_d[k]]
    if missing or extra or bad:
        _fail(f"{what}: {len(missing)} missing {missing[:3]}, {len(extra)} unexpected {extra[:3]}, "
              f"{len(bad)} shapes differ {bad[:3]}")


def check_fingerprints(what: str, state: Dict[str, torch.Tensor], keys: KeyShapes) -> int:
    """Every key's first values in `state` must be its bf16 fingerprint, bit for bit."""
    wrong = []
    for key, shape in keys:
        want = torch.from_numpy(fingerprint(key, shape)).to(torch.bfloat16).float()
        got = state[key].detach().reshape(-1)[: want.numel()].float().cpu()
        if not torch.equal(got, want):
            wrong.append(key)
    if wrong:
        _fail(f"{what}: {len(wrong)} fingerprints not in their own tensor, e.g. {wrong[:3]}")
    return len(keys)


def _hardware(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------
def rehearse_vae(root: Path, small: bool, device: torch.device):
    """-> the widened RGBA VAE on `device`."""
    from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
    from ragb_vae_tpu_torch.models.weights import load_autoencoder_params
    from ragb_vae_tpu_torch.ops.kernels import resnet_block as rb

    on_card = device.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    cfg = vae_config(small)
    with step("vae", root, device):
        write_random_vae(cfg, root / "vae", seed=1)
        vae = RgbaVAE.from_pretrained_rgb(root, subfolder="vae", dtype=dtype, device=device)
        if on_card:
            vae.enable_fused()
        if vae.config.in_channels != 4 or vae.config.out_channels != 4:
            _fail(f"the VAE was not widened to RGBA: {vae.config.in_channels} -> {vae.config.out_channels}")
        rgba = dataclasses.replace(cfg, in_channels=4, out_channels=4)
        _check_inventory("VAE", inventory(vae.module), vae_inventory(rgba))
        px = 64 if small else 256
        x = torch.rand((1, px, px, 4), generator=torch.Generator().manual_seed(0)).to(device)
        rb.reset_launch_counts()
        with torch.no_grad():
            posterior = vae.encode(x * 2.0 - 1.0)
            recon = vae.decode(posterior.mean)
        if not (torch.isfinite(recon).all() and torch.isfinite(posterior.mean).all()):
            _fail("the VAE's encode and decode are not finite")
        print(f"[rehearse] VAE: {len(inventory(vae.module))} tensors, RGB -> RGBA widened, {px}^2 encode and decode "
              f"finite on {device} (recon {tuple(recon.shape)}; K1 launches {rb.CONV_LAUNCHES}, K2 "
              f"{rb.UPSAMPLE_LAUNCHES})", flush=True)

        qcfg = vae_config(small, quant=True)
        write_random_vae(qcfg, root / "vae_quant", seed=2)
        qcfg2, qstate = load_autoencoder_params(root, "vae_quant", adapt_to_rgba=True)
        if not (qcfg2.use_quant_conv and qcfg2.use_post_quant_conv and qcfg2.in_channels == 4):
            _fail(f"the quant-conv variant loaded as {qcfg2}")
        qvae = RgbaVAE(qcfg2, dtype=dtype, fused=on_card, device="meta")
        qvae.module.load_state_dict({k: v.to(device, dtype) for k, v in qstate.items()}, strict=True, assign=True)
        with torch.no_grad():
            out = qvae.decode(qvae.encode(x * 2.0 - 1.0).mean)
        if not torch.isfinite(out).all():
            _fail("the quant-conv variant's forward is not finite")
        print("[rehearse] VAE quant-conv variant: loaded and forward finite", flush=True)
    return vae


def rehearse_goldens(root: Path, small: bool, device: torch.device, vae) -> None:
    import record_goldens_torch as rg

    out = root / "goldens"
    out.mkdir(parents=True, exist_ok=True)
    assert_fixtures = not small and (FIXTURES / "flux_ae_keys.txt").exists()
    if assert_fixtures:
        shutil.copy(FIXTURES / "flux_ae_keys.txt", out / "flux_ae_keys.txt")
    with step("goldens", root, device):
        rg.record_vae(root, "vae", out, assert_fixtures, device)
        hold_widened_vae(vae, out / "vae_goldens.npz", device)
    print("[rehearse] record_goldens_torch (vae) ran clean", flush=True)


def hold_widened_vae(vae, goldens: Path, device: torch.device) -> dict:
    """The RGBA-widened VAE against an RGB checkpoint's goldens: its alpha
    input weighs nothing and its first three outputs are the RGB decoder's,
    so its encode of the probes (alpha 0) and the RGB part of its decode
    must give the goldens (`record_goldens_torch.HOLD_REL_TOL`)."""
    import record_goldens_torch as rg

    data = np.load(goldens)
    probes = data["probes"] * 2.0 - 1.0
    rgba = np.concatenate([probes, np.zeros_like(probes[..., :1])], axis=-1)
    zc = data["moments"].shape[-1] // 2
    with torch.no_grad():
        posterior = vae.encode(torch.from_numpy(rgba).to(device))
        decoded = vae.decode(torch.from_numpy(data["moments"][..., :zc]).to(device))
    return rg._hold("widened RGBA vae", {
        "mean": rg._rel(posterior.mean.float().cpu().numpy(), data["moments"][..., :zc]),
        "decoded rgb": rg._rel(decoded[..., :3].float().cpu().numpy(), data["decoded"]),
    }, device)


def rehearse_transformer(root: Path, small: bool, device: torch.device) -> None:
    import record_goldens_torch as rg

    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel
    from ragb_vae_tpu_torch.models.flux_weights import (
        load_flux_transformer_params,
        lora_parameters,
        lora_state,
        params_to_flux_state,
        save_flux_transformer_params,
    )

    cfg = transformer_config(small)
    keys = transformer_inventory(cfg)
    n_params = sum(int(np.prod(s)) for _, s in keys)
    tdir = root / "transformer"
    need = 2.1 * 2 * n_params
    free = shutil.disk_usage(root).free
    if free < need:
        _fail(f"{free / 2**30:.1f} GiB free under {root}; the transformer steps need {need / 2**30:.1f} GiB")
    with step("transformer write", root, device):
        write_transformer_config(cfg, tdir)
        total = write_sharded_transformer(keys, tdir)
        write_model_dir(root, *random_prompt(cfg, seed=3))
    print(f"[rehearse] wrote {len(keys)} tensors ({n_params / 1e9:.2f} B params, {total / 2**30:.1f} GiB bf16) in 3 "
          f"shards + index -> {tdir}", flush=True)
    if not small and (FIXTURES / "flux_transformer_keys.txt").exists():
        (root / "goldens").mkdir(exist_ok=True)
        shutil.copy(FIXTURES / "flux_transformer_keys.txt", root / "goldens" / "flux_transformer_keys.txt")
        recorded = root / "goldens" / "transformer_keys_recorded.txt"
        rg.dump_manifest(dict(keys), recorded)
        rg.assert_fixture_match(recorded, root / "goldens" / "flux_transformer_keys.txt")

    with step("transformer load", root, device):
        loaded_cfg, state = load_flux_transformer_params(root, dtype=None)
        if loaded_cfg != cfg:
            _fail(f"config read back as {loaded_cfg}")
        _check_inventory("transformer", inventory_of(state), keys)
        n = check_fingerprints("transformer load", state, keys)
    print(f"[rehearse] transformer: {len(state)} tensors match the module's inventory exactly; {n} value "
          "fingerprints verified", flush=True)

    with step("transformer round trip", root, device):
        save_flux_transformer_params(cfg, params_to_flux_state(state), root / "roundtrip")
        del state
        _, back = load_flux_transformer_params(root / "roundtrip", None, dtype=None)
        _check_inventory("round trip", inventory_of(back), keys)
        check_fingerprints("round trip", back, keys)
        del back
        shutil.rmtree(root / "roundtrip")
    print(f"[rehearse] transformer: torch round trip keys, shapes and fingerprints exact ({len(keys)})", flush=True)

    with step("from_pretrained bf16", root, device):
        model = FluxTextAlphaModel.from_pretrained(root, vae_path=root, vae_subfolder="vae", dtype=torch.bfloat16,
                                                   device=device)
        check_fingerprints("from_pretrained", model.transformer.state_dict(), keys)
    print(f"[rehearse] from_pretrained: {len(keys)} fingerprints each in its own parameter on {device}", flush=True)

    with step("lora", root, device):
        model.lora_rank, model.lora_alpha = LORA_RANK, float(LORA_RANK)
        gen = torch.Generator(device).manual_seed(4)
        model.init_lora(gen)
        with torch.no_grad():
            for p in lora_parameters(model.transformer).values():
                p.normal_(0.0, 0.02, generator=gen)
        want = lora_state(model.transformer)
        n_targets = len(want) // 2
        expect = cfg.num_layers * 12 + cfg.num_single_layers * 3
        if n_targets != expect:
            _fail(f"{n_targets} LoRA targets, expected {expect}")
        model.save_lora_weights(root / "lora")
        with torch.no_grad():
            for p in lora_parameters(model.transformer).values():
                p.zero_()
        model.load_lora(root / "lora")
        got = lora_state(model.transformer)
        if set(got) != set(want) or not all(torch.equal(got[k], want[k]) for k in want):
            _fail("the peft export did not reload exactly")
    print(f"[rehearse] LoRA: {n_targets} target modules at rank {LORA_RANK}, peft export -> reload exact", flush=True)
    del model, got, want
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rehearse_int8(root, cfg, device)


def inventory_of(state: Dict[str, torch.Tensor]) -> KeyShapes:
    return [(k, tuple(v.shape)) for k, v in state.items()]


def _int8_forward(model, config: FluxTransformerConfig, device: torch.device) -> torch.Tensor:
    """One transformer forward on seeded inputs: 64 image and 8 prompt tokens."""
    gen = torch.Generator().manual_seed(5)
    args = dict(
        hidden_states=torch.randn((1, 64, config.in_channels), generator=gen),
        encoder_hidden_states=torch.randn((1, 8, config.joint_attention_dim), generator=gen),
        pooled_projections=torch.randn((1, config.pooled_projection_dim), generator=gen),
    )
    args = {k: v.to(device, torch.bfloat16) for k, v in args.items()}
    with torch.no_grad():
        return model.transformer(**args, timestep=torch.full((1,), 0.5, device=device),
                                 img_ids=torch.zeros((64, 3), device=device), txt_ids=torch.zeros((8, 3), device=device),
                                 guidance=torch.full((1,), 3.5, device=device)).float()


def rehearse_int8(root: Path, cfg: FluxTransformerConfig, device: torch.device) -> None:
    import quantize_flux_checkpoint_torch

    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import EMPTY_PROMPT_FILE, FluxTextAlphaModel
    from ragb_vae_tpu_torch.ops.kernels import int8_matmul as i8

    def load(model_path: Path):
        return FluxTextAlphaModel.from_pretrained(model_path, vae_path=root, vae_subfolder="vae",
                                                  dtype=torch.bfloat16, device=device, weight_quant="int8")

    with step("int8 at load", root, device):
        at_load = load(root)
        i8.reset_launch_counts()
        out = _int8_forward(at_load, cfg, device)
        launches = i8.LAUNCHES
        if not torch.isfinite(out).all():
            _fail("the int8 forward is not finite")
    print(f"[rehearse] int8 at load: one forward finite, {launches} int8 matmul launches", flush=True)
    with step("int8 script + reload", root, device):
        qroot = root / "int8"
        quantize_flux_checkpoint_torch.main(["--model_path", str(root), "--output_dir", str(qroot / "transformer"),
                                             "--device", str(device)])
        shutil.copy(root / EMPTY_PROMPT_FILE, qroot / EMPTY_PROMPT_FILE)
        reloaded = load(qroot)
        a, b = at_load.transformer.state_dict(), reloaded.transformer.state_dict()
        differ = sorted(k for k in a if k not in b or a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k]))
        if differ or set(a) != set(b):
            _fail(f"the quantised checkpoint reloads other weights than quantising at load: {differ[:3]}")
        if not torch.equal(_int8_forward(reloaded, cfg, device), out):
            _fail("the reloaded int8 checkpoint's forward differs from the one quantised at load")
    print(f"[rehearse] int8: quantize_flux_checkpoint_torch.py's output reloaded bit-equal to quantising at load "
          f"({len(a)} tensors; the forward bit-equal)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default=None, help="checkpoint scratch dir (default: mkdtemp, removed)")
    ap.add_argument("--small", action="store_true", help="reduced widths, every code path (CPU tests)")
    ap.add_argument("--keep", action="store_true", help="keep the workdir")
    ap.add_argument("--skip-goldens", action="store_true", help="skip the record_goldens_torch step")
    ap.add_argument("--device", default="cuda", help="where the models load and run (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    workdir = Path(args.workdir) if args.workdir else Path(tempfile.mkdtemp(prefix="real_geometry_torch_"))
    workdir.mkdir(parents=True, exist_ok=True)
    print(f"[rehearse] workdir {workdir} (small={args.small}, device {device}: {_hardware(device)}, "
          f"{shutil.disk_usage(workdir).free / 2**30:.1f} GiB free; torch {torch.__version__}, safetensors "
          f"{safetensors.__version__})", flush=True)
    try:
        vae = rehearse_vae(workdir, args.small, device)
        if not args.skip_goldens:
            rehearse_goldens(workdir, args.small, device, vae)
        del vae
        rehearse_transformer(workdir, args.small, device)
        print("[rehearse] ALL REHEARSALS PASSED at " + ("small" if args.small else "REAL") + " geometry", flush=True)
        return 0
    finally:
        if not args.keep and args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
