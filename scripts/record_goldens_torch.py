#!/usr/bin/env python
"""Record a checkpoint's key manifests and golden activations with the port,
and hold the port's model on the card against them.

The counterpart of `scripts/record_goldens.py` for the PyTorch package: the
same flags, plus `--device` (default `cuda`; a missing card raises, `--device
cpu` runs on the host). It needs torch, numpy and safetensors, nothing else:

    python scripts/record_goldens_torch.py --checkpoint /path/to/flux --kind vae \\
        --vae-subfolder vae --output tests/fixtures --assert-fixtures
    python scripts/record_goldens_torch.py --checkpoint /path/to/flux \\
        --kind transformer --output tests/fixtures

For each kind it writes, as the JAX script does:
  (a) `<kind>_keys_recorded.txt`: every key and shape of the checkpoint's
      safetensors files as `iter_torch_state` reads them, one `key\\tshape`
      line a key, sorted (the JAX script's format, byte for byte). With
      `--assert-fixtures` it is diffed against `flux_ae_keys.txt` /
      `flux_transformer_keys.txt` in the output directory, and any missing
      key, extra key or other shape fails the run.
  (b) `<kind>_goldens.npz`: the JAX script's fields on the same probes
      (`PROBE_SEED`, `N_PROBES`, drawn with numpy), so either package reads
      the other's file. The source is diffusers when it imports, else the
      port's plain route on the CPU in fp32; `source` says which.
Then (c) it loads the checkpoint on `--device` as the port serves it (on the
card: bf16 parameters, the fused kernels) and holds it against the goldens
it just wrote: the relative error of each output, which fails the run above
`HOLD_REL_TOL`. On the CPU that is the golden route itself.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from ragb_vae_tpu_torch.device import resolve_device  # noqa: E402
from ragb_vae_tpu_torch.models.weights import iter_torch_state  # noqa: E402

PROBE_SEED = 2024
N_PROBES = 3
# The card's bf16 model against the fp32 goldens: ||card - golden|| / ||golden||
# of each output. bf16 parameters and activations round every layer by up to
# 2^-9 relative; over the ~30 convolutions of the FLUX `ae` or the blocks of
# the transformer the roundings add up to about 1e-2. A transposed or
# misplaced weight decorrelates what follows it: errors of order 1.
HOLD_REL_TOL = 5e-2


def checkpoint_shapes(files: Iterable[Path]) -> Dict[str, Tuple[int, ...]]:
    """key -> shape of every entry of the files, as `iter_torch_state` reads them."""
    return {key: tuple(value.shape) for path in files for key, value in iter_torch_state(path)}


def dump_manifest(shapes: Dict[str, Tuple[int, ...]], path: Path) -> None:
    lines = [f"{key}\t{','.join(str(int(d)) for d in shape)}" for key, shape in sorted(shapes.items())]
    path.write_text("\n".join(lines) + "\n")
    print(f"[record_goldens] wrote {len(lines)} keys -> {path}")


def assert_fixture_match(recorded: Path, fixture: Path) -> None:
    if not fixture.exists():
        print(f"[record_goldens] no fixture at {fixture}; skipping assert")
        return
    rec = dict(line.split("\t") for line in recorded.read_text().splitlines() if line)
    fix = dict(line.split("\t") for line in fixture.read_text().splitlines() if line)
    missing = sorted(set(fix) - set(rec))
    extra = sorted(set(rec) - set(fix))
    shape_diff = sorted(k for k in set(rec) & set(fix) if rec[k] != fix[k])
    if missing or extra or shape_diff:
        for k in missing[:20]:
            print(f"  fixture-only key: {k}")
        for k in extra[:20]:
            print(f"  checkpoint-only key: {k}")
        for k in shape_diff[:20]:
            print(f"  shape mismatch: {k}: fixture {fix[k]} vs checkpoint {rec[k]}")
        raise SystemExit(
            f"fixture mismatch vs {fixture.name}: {len(missing)} missing, "
            f"{len(extra)} extra, {len(shape_diff)} shape diffs"
        )
    print(f"[record_goldens] fixture {fixture.name} matches the checkpoint")


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _hold(kind: str, errors: Dict[str, float], device: torch.device) -> Dict[str, float]:
    line = ", ".join(f"{name} {err:.3e}" for name, err in errors.items())
    print(f"[record_goldens] {kind} on {device} against the goldens (relative error, bound {HOLD_REL_TOL:g}): {line}")
    if not all(np.isfinite(e) and e <= HOLD_REL_TOL for e in errors.values()):
        raise SystemExit(f"[record_goldens] the port's {kind} on {device} does not reproduce the goldens: {line}")
    return errors


# ---------------------------------------------------------------------------
# VAE goldens
# ---------------------------------------------------------------------------
def vae_on(ckpt_dir: Path, device: torch.device, dtype: torch.dtype, fused: bool):
    """The checkpoint's AutoencoderKL as it is stored (no RGBA widening), in
    `dtype` on `device`."""
    from ragb_vae_tpu_torch.models.vae import AutoencoderKL
    from ragb_vae_tpu_torch.models.weights import load_autoencoder_params

    config, state = load_autoencoder_params(ckpt_dir)
    model = AutoencoderKL(config, fused=fused, device="meta", dtype=dtype)
    model.load_state_dict({k: v.to(device=device, dtype=dtype) for k, v in state.items()}, strict=True, assign=True)
    return model.eval()


def vae_outputs(model, probes_vae: np.ndarray, z: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(moments (mean | logvar), decoded) NHWC of `model` on [-1, 1] NHWC
    probes; the decoder takes `z` when given, else the posterior mean."""
    device = next(model.parameters()).device
    dtype = next(model.parameters()).dtype
    with torch.no_grad():
        posterior = model.encode(torch.from_numpy(probes_vae).to(device, dtype))
        moments = torch.cat([posterior.mean, posterior.logvar], dim=-1).float().cpu().numpy()
        z_in = posterior.mean if z is None else torch.from_numpy(z).to(device, dtype)
        decoded = model.decode(z_in).float().cpu().numpy()
    return moments, decoded


def record_vae(ckpt: Path, subfolder: str, out_dir: Path, assert_fixtures: bool,
               device="cuda") -> Dict[str, float]:
    """Manifest, goldens and the hold of the checkpoint's VAE; -> the hold's errors."""
    from ragb_vae_tpu_torch.models.weights import _locate_weight_file

    device = resolve_device(device)
    ckpt_dir = Path(ckpt) / subfolder if subfolder else Path(ckpt)
    if not ckpt_dir.exists():
        raise FileNotFoundError(f"Checkpoint directory not found: {ckpt_dir}")
    shapes = checkpoint_shapes([_locate_weight_file(ckpt_dir)])
    recorded = out_dir / "vae_keys_recorded.txt"
    dump_manifest(shapes, recorded)
    if assert_fixtures:
        assert_fixture_match(recorded, out_dir / "flux_ae_keys.txt")

    in_ch = int(shapes["encoder.conv_in.weight"][1])
    size = 64
    rng = np.random.default_rng(PROBE_SEED)
    probes = rng.uniform(0.0, 1.0, (N_PROBES, size, size, in_ch)).astype(np.float32)
    probes_vae = probes * 2.0 - 1.0  # [-1, 1] VAE range, NHWC

    try:
        from diffusers import AutoencoderKL  # the published model, preferred

        model = AutoencoderKL.from_pretrained(str(ckpt_dir)).eval()
        with torch.no_grad():
            posterior = model.encode(torch.from_numpy(probes_vae.transpose(0, 3, 1, 2))).latent_dist
            moments = torch.cat([posterior.mean, posterior.logvar], dim=1).numpy().transpose(0, 2, 3, 1)
            decoded = model.decode(posterior.mean).sample.numpy().transpose(0, 2, 3, 1)
        source = "diffusers.AutoencoderKL"
    except ImportError:
        moments, decoded = vae_outputs(vae_on(ckpt_dir, torch.device("cpu"), torch.float32, fused=False), probes_vae)
        source = "ragb_vae_tpu_torch AutoencoderKL (plain route, CPU, fp32)"

    np.savez(
        out_dir / "vae_goldens.npz",
        probes=probes,  # NHWC in [0, 1]
        moments=moments,  # NHWC (mean|logvar)
        decoded=decoded,  # NHWC in VAE range
        source=np.asarray(source),
        checkpoint=np.asarray(str(ckpt_dir)),
    )
    print(f"[record_goldens] wrote vae_goldens.npz (source: {source})")

    on_card = device.type == "cuda"
    model = vae_on(ckpt_dir, device, torch.bfloat16 if on_card else torch.float32, fused=on_card)
    zc = moments.shape[-1] // 2
    got_moments, got_decoded = vae_outputs(model, probes_vae, z=moments[..., :zc])
    return _hold("vae", {
        "mean": _rel(got_moments[..., :zc], moments[..., :zc]),
        "logvar": _rel(got_moments[..., zc:], np.clip(moments[..., zc:], -30.0, 20.0)),
        "decoded": _rel(got_decoded, decoded),
    }, device)


# ---------------------------------------------------------------------------
# Transformer goldens
# ---------------------------------------------------------------------------
def transformer_on(directory: Path, device: torch.device, dtype: torch.dtype):
    """The checkpoint's FluxTransformer2D in `dtype` (the AdaLN modulation in
    fp32, as the port builds it) on `device`, cast as it is read."""
    from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformer2D, FluxTransformerConfig
    from ragb_vae_tpu_torch.models.flux_weights import load_flux_transformer_params

    model = FluxTransformer2D(FluxTransformerConfig.from_json(directory / "config.json"), remat=False,
                              device="meta", dtype=dtype)
    want = {k: p.dtype for k, p in model.state_dict().items()}
    _, state = load_flux_transformer_params(directory, None, dtype=want)
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(device).eval()


def transformer_output(model, inputs: Dict[str, Optional[np.ndarray]], dtype: torch.dtype) -> np.ndarray:
    device = next(model.parameters()).device
    args = {k: None if v is None else torch.from_numpy(v).to(device) for k, v in inputs.items()}
    for k in ("hidden_states", "encoder_hidden_states", "pooled_projections"):
        args[k] = args[k].to(dtype)
    with torch.no_grad():
        return model(**args).float().cpu().numpy()


def record_transformer(ckpt: Path, out_dir: Path, assert_fixtures: bool, device="cuda") -> Dict[str, float]:
    """Manifest, goldens and the hold of the checkpoint's transformer; -> the hold's errors."""
    from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig
    from ragb_vae_tpu_torch.models.flux_weights import _weight_files

    device = resolve_device(device)
    directory = Path(ckpt)
    if (directory / "transformer").exists():
        directory = directory / "transformer"
    recorded = out_dir / "transformer_keys_recorded.txt"
    dump_manifest(checkpoint_shapes(_weight_files(directory)[0]), recorded)
    if assert_fixtures:
        assert_fixture_match(recorded, out_dir / "flux_transformer_keys.txt")

    config = FluxTransformerConfig.from_json(directory / "config.json")
    rng = np.random.default_rng(PROBE_SEED)
    seq, txt_seq, bsz = 16, 8, 2
    inputs = dict(
        hidden_states=rng.standard_normal((bsz, seq, config.in_channels)).astype(np.float32),
        encoder_hidden_states=rng.standard_normal(
            (bsz, txt_seq, config.joint_attention_dim)
        ).astype(np.float32),
        pooled_projections=rng.standard_normal(
            (bsz, config.pooled_projection_dim)
        ).astype(np.float32),
        timestep=np.asarray([0.5, 0.25], np.float32),
        img_ids=rng.integers(0, 8, (seq, 3)).astype(np.float32),
        txt_ids=np.zeros((txt_seq, 3), np.float32),
        guidance=np.full((bsz,), 3.5, np.float32) if config.guidance_embeds else None,
    )

    try:
        from diffusers import FluxTransformer2DModel

        reference = FluxTransformer2DModel.from_pretrained(str(directory)).eval()
        with torch.no_grad():
            out = reference(**{k: None if v is None else torch.from_numpy(v) for k, v in inputs.items()},
                            return_dict=False)[0].numpy()
        source = "diffusers.FluxTransformer2DModel"
    except ImportError:
        # the fp32 model is freed before the device's is read
        out = transformer_output(transformer_on(directory, torch.device("cpu"), torch.float32), inputs,
                                 torch.float32)
        source = "ragb_vae_tpu_torch FluxTransformer2D (plain route, CPU, fp32)"
    reference = None
    arrays = {k: v for k, v in inputs.items() if v is not None}
    np.savez(
        out_dir / "transformer_goldens.npz",
        output=out,
        source=np.asarray(source),
        checkpoint=np.asarray(str(directory)),
        **arrays,
    )
    print(f"[record_goldens] wrote transformer_goldens.npz (source: {source})")

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    got = transformer_output(transformer_on(directory, device, dtype), inputs, dtype)
    return _hold("transformer", {"output": _rel(got, out)}, device)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--checkpoint", required=True, help="HF-format checkpoint dir")
    parser.add_argument("--kind", choices=("vae", "transformer"), required=True)
    parser.add_argument("--vae-subfolder", default="", help="e.g. 'ae' or 'vae'")
    parser.add_argument("--output", default=str(REPO / "tests" / "fixtures"))
    parser.add_argument(
        "--assert-fixtures",
        action="store_true",
        help="fail if the checked-in key manifests disagree with the checkpoint",
    )
    parser.add_argument("--device", default="cuda",
                        help="where the port's model is held against the goldens (default: the card)")
    args = parser.parse_args(argv)
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.kind == "vae":
        record_vae(Path(args.checkpoint), args.vae_subfolder, out_dir, args.assert_fixtures, args.device)
    else:
        record_transformer(Path(args.checkpoint), out_dir, args.assert_fixtures, args.device)


if __name__ == "__main__":
    main()
