#!/usr/bin/env python
"""Rehearse the two auxiliary weight-drop assets on the port, against
synthetic twins written by the port itself.

The counterpart of `scripts/rehearse_aux_assets.py` for the PyTorch package:
the same flags, plus `--device` (default `cuda`; a missing card raises,
`--device cpu` runs on the host). It needs torch, numpy and safetensors: no
`transformers`, no `tokenizers`, no `lpips`.

1. **LPIPS VGG16**: a synthetic state dict with the key inventory of
   `lpips.LPIPS(net="vgg").state_dict()` (`net.sliceK.N.weight/bias` at the
   VGG16 shapes, `linK.model.1.weight`, the `scaling_layer.shift/scale`
   buffers the importer skips), written as `.safetensors` and as `.pt`, and
   the same tensors under torchvision's bare `features.N.*` keys; each goes
   through `models/lpips.py::load_lpips_params` and `maybe_build_lpips` on
   `--device`, and the distances must be bit-identical.
2. **CLIP + T5 empty-prompt export**: a checkpoint directory in Hugging
   Face's layout written by the port (`tokenizer/`, `tokenizer_2/` as
   FLUX.1-Kontext-dev ships them, cut to the fields the port reads;
   `text_encoder/`, `text_encoder_2/` through `save_text_encoder` from a
   seed), driven through `scripts/export_empty_prompt_torch.py`'s command
   line twice: the export, then the npz read back without encoding again.
   The prompt is T5's stream alone (CLIP's width differs from T5's, as in
   FLUX), and `encode_empty_prompt` reads the npz.

`--small` narrows the encoders for the CPU tests; the published geometry
(CLIP-L, the T5-v1.1-XXL encoder: 4.9 B parameters, about 19 GiB of fp32
safetensors) needs that much free disk and host memory.

    python scripts/rehearse_aux_assets_torch.py [--small] [--device cpu] [--workdir DIR --keep]
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path
from typing import Dict

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from ragb_vae_tpu_torch.device import resolve_device  # noqa: E402

# torchvision vgg16.features: conv index -> (in, out) channels
VGG16_CONVS = {
    0: (3, 64), 2: (64, 64),
    5: (64, 128), 7: (128, 128),
    10: (128, 256), 12: (256, 256), 14: (256, 256),
    17: (256, 512), 19: (512, 512), 21: (512, 512),
    24: (512, 512), 26: (512, 512), 28: (512, 512),
}
SLICE_ENDS = (4, 9, 16, 23, 30)     # exclusive ends of the lpips slices 1..5 in vgg16.features
SLICE_CHANNELS = (64, 128, 256, 512, 512)

# FLUX.1-Kontext-dev's tokenizer files: CLIP pads with its eos
CLIP_SPECIALS = {"bos_token": ("<|startoftext|>", 49406), "eos_token": ("<|endoftext|>", 49407),
                 "pad_token": ("<|endoftext|>", 49407), "unk_token": ("<|endoftext|>", 49407)}
T5_SPECIALS = {"pad_token": ("<pad>", 0), "eos_token": ("</s>", 1), "unk_token": ("<unk>", 2)}


# ---------------------------------------------------------------------------
# 1. LPIPS
# ---------------------------------------------------------------------------
def lpips_state(seed: int = 7, scale: float = 0.05) -> Dict[str, torch.Tensor]:
    """Random values under the key names and shapes of
    `lpips.LPIPS(net="vgg").state_dict()`: the conv layers of each slice under
    their vgg16.features index, the non-negative lin heads, and the
    ScalingLayer buffers."""
    rng = np.random.default_rng(seed)
    state: Dict[str, np.ndarray] = {}
    start = 0
    for slice_idx, end in enumerate(SLICE_ENDS, start=1):
        for conv_idx in range(start, end):
            if conv_idx in VGG16_CONVS:
                cin, cout = VGG16_CONVS[conv_idx]
                state[f"net.slice{slice_idx}.{conv_idx}.weight"] = rng.normal(0, scale, (cout, cin, 3, 3))
                state[f"net.slice{slice_idx}.{conv_idx}.bias"] = rng.normal(0, scale, (cout,))
        start = end
    for k, c in enumerate(SLICE_CHANNELS):
        state[f"lin{k}.model.1.weight"] = np.abs(rng.normal(0, scale, (1, c, 1, 1)))
    state["scaling_layer.shift"] = np.array([-0.030, -0.088, -0.188]).reshape(1, 3, 1, 1)
    state["scaling_layer.scale"] = np.array([0.458, 0.448, 0.450]).reshape(1, 3, 1, 1)
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in state.items()}


def torchvision_features_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The same conv tensors under torchvision's bare `features.N.*` keys, with the lin heads."""
    out = {}
    for key, value in state.items():
        parts = key.split(".")
        if parts[0] == "net":
            out[f"features.{parts[2]}.{parts[3]}"] = value
        elif parts[0].startswith("lin"):
            out[key] = value
    return out


def write_lpips_files(workdir: Path, seed: int = 7) -> Dict[str, Path]:
    """The synthetic LPIPS weights as `.safetensors`, `.pt` and torchvision-keyed `.safetensors`."""
    from ragb_vae_tpu_torch.models.weights import save_torch_state

    state = lpips_state(seed)
    paths = {"safetensors": workdir / "lpips_vgg.safetensors", "pt": workdir / "lpips_vgg.pt",
             "features": workdir / "vgg16_features.safetensors"}
    save_torch_state(state, paths["safetensors"])
    torch.save(state, paths["pt"])
    save_torch_state(torchvision_features_state(state), paths["features"])
    return paths


def lpips_distances(paths: Dict[str, Path], device: torch.device) -> Dict[str, torch.Tensor]:
    """Each file's LPIPS distances on `device` over the same seeded pair of
    2 x 32^2 RGB batches; the importer's layout checked on the way."""
    from ragb_vae_tpu_torch.models.lpips import load_lpips_params, lpips_distance

    gen = torch.Generator().manual_seed(0)
    pred = (torch.rand((2, 32, 32, 3), generator=gen) * 2 - 1).to(device)
    target = (torch.rand((2, 32, 32, 3), generator=gen) * 2 - 1).to(device)
    dists = {}
    for tag, path in paths.items():
        model = load_lpips_params(path).to(device)
        for idx, (cin, cout) in VGG16_CONVS.items():
            if tuple(getattr(model, f"conv{idx}_weight").shape) != (cout, cin, 3, 3):
                raise SystemExit(f"[rehearse-aux] FAIL: {tag}: conv {idx} imported as "
                                 f"{tuple(getattr(model, f'conv{idx}_weight').shape)}")
        if not all(bool((getattr(model, f"lin{k}") >= 0).all()) for k in range(len(SLICE_CHANNELS))):
            raise SystemExit(f"[rehearse-aux] FAIL: {tag}: a negative lin weight")
        with torch.no_grad():
            dists[tag] = lpips_distance(pred, target, model)
        if not torch.isfinite(dists[tag]).all():
            raise SystemExit(f"[rehearse-aux] FAIL: {tag}: distances not finite")
    return dists


def rehearse_lpips(workdir: Path, device: torch.device) -> None:
    from ragb_vae_tpu_torch.models.lpips import maybe_build_lpips

    paths = write_lpips_files(workdir)
    dists = lpips_distances(paths, device)
    if not all(torch.equal(d, dists["safetensors"]) for d in dists.values()):
        raise SystemExit(f"[rehearse-aux] FAIL: the formats imported other values: "
                         f"{ {k: v.tolist() for k, v in dists.items()} }")
    # the training stage's entry point (training.lpips_weights)
    fn = maybe_build_lpips(paths["safetensors"], device=device)
    if fn is None:
        raise SystemExit("[rehearse-aux] FAIL: maybe_build_lpips found no weights")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        loss = float(fn((torch.rand((2, 32, 32, 4), generator=gen) * 2 - 1).to(device),
                        (torch.rand((2, 32, 32, 4), generator=gen) * 2 - 1).to(device)))
    if not np.isfinite(loss):
        raise SystemExit("[rehearse-aux] FAIL: the perceptual loss is not finite")
    print(f"[rehearse-aux] LPIPS: {len(VGG16_CONVS)} convs + {len(SLICE_CHANNELS)} lins imported from "
          f"safetensors/pt/features formats on {device}, identical distances "
          f"{[round(float(d), 6) for d in dists['safetensors']]}; perceptual_loss={loss:.4f}", flush=True)


# ---------------------------------------------------------------------------
# 2. Text encoders -> export_empty_prompt_torch.py
# ---------------------------------------------------------------------------
def write_flux_tokenizers(root: Path) -> None:
    """tokenizer/ and tokenizer_2/ as FLUX.1-Kontext-dev ships them, cut to
    the fields the port reads: the special tokens, their ids in
    `added_tokens_decoder` (and CLIP's vocab.json), `model_max_length`."""
    for sub, specials, length in (("tokenizer", CLIP_SPECIALS, 77), ("tokenizer_2", T5_SPECIALS, 512)):
        (root / sub).mkdir(parents=True)
        decoder = {str(i): {"content": text, "special": True} for text, i in specials.values()}
        (root / sub / "tokenizer_config.json").write_text(json.dumps(
            {"model_max_length": length, "added_tokens_decoder": decoder,
             **{field: text for field, (text, _) in specials.items()}}))
    (root / "tokenizer" / "vocab.json").write_text(json.dumps({t: i for t, i in CLIP_SPECIALS.values()}))


def text_encoder_configs(small: bool):
    from ragb_vae_tpu_torch.models import text_encoders as te

    if small:
        return (te.CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2),
                te.T5EncoderConfig(d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=4,
                                   feed_forward_proj="gated-gelu"))
    return te.CLIPTextConfig.clip_l(), te.T5EncoderConfig.t5_xxl()


def write_text_encoders(root: Path, small: bool, device: torch.device, seed: int = 0) -> int:
    """text_encoder/ and text_encoder_2/ drawn from `seed` on `device` (built
    on the meta device, one encoder at a time) -> T5's parameter count."""
    from ragb_vae_tpu_torch.models import text_encoders as te

    gen = torch.Generator(device).manual_seed(seed)
    n_t5 = 0
    for cls, cfg, sub in zip((te.CLIPTextEncoder, te.T5Encoder), text_encoder_configs(small),
                             ("text_encoder", "text_encoder_2")):
        module = cls(cfg, device="meta").to_empty(device=device)
        te.init_text_encoder_(module, gen)
        te.save_text_encoder(module, root / sub)
        n_t5 = sum(p.numel() for p in module.parameters())
        del module
    return n_t5


def rehearse_text_encoders(workdir: Path, small: bool, device: torch.device) -> None:
    import export_empty_prompt_torch

    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import EMPTY_PROMPT_FILE, encode_empty_prompt

    root = workdir / "flux_hf_layout"
    write_flux_tokenizers(root)
    n_t5 = write_text_encoders(root, small, device)
    clip_cfg, t5_cfg = text_encoder_configs(small)
    print(f"[rehearse-aux] wrote the HF layout at {root} (T5 {n_t5 / 1e9:.2f} B params, CLIP hidden "
          f"{clip_cfg.hidden_size}, T5 hidden {t5_cfg.d_model})", flush=True)

    npz = root / EMPTY_PROMPT_FILE
    stamps = []
    for run in ("export", "cache"):
        export_empty_prompt_torch.main(["--model-path", str(root), "--device", str(device)])
        stamps.append(npz.stat().st_mtime_ns)
        print(f"[rehearse-aux] export_empty_prompt_torch ({run}) done", flush=True)
    if stamps[0] != stamps[1]:
        raise SystemExit("[rehearse-aux] FAIL: the second export wrote the npz again instead of reading it")

    with np.load(npz) as data:
        prompt, pooled, text_ids = data["prompt_embeds"], data["pooled_prompt_embeds"], data["text_ids"]
    # CLIP's width differs from T5's: the prompt is T5's stream alone, the branch FLUX takes (768 vs 4096)
    if not (prompt.shape == (1, 512, t5_cfg.d_model) and pooled.shape == (1, clip_cfg.hidden_size)
            and text_ids.shape == (512, 3)):
        raise SystemExit(f"[rehearse-aux] FAIL: npz shapes {prompt.shape}, {pooled.shape}, {text_ids.shape}")
    if not (np.isfinite(prompt).all() and np.isfinite(pooled).all()):
        raise SystemExit("[rehearse-aux] FAIL: the empty prompt's embeddings are not finite")
    p2, q2, t2 = encode_empty_prompt(root, device=device)
    if not (np.array_equal(p2, prompt) and np.array_equal(q2, pooled) and np.array_equal(t2, text_ids)):
        raise SystemExit("[rehearse-aux] FAIL: encode_empty_prompt did not return the npz")
    print("[rehearse-aux] empty-prompt npz: shapes/branch/cache all OK", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--small", action="store_true",
                    help="narrow encoders (CPU tests); the default is the published CLIP-L + T5-XXL geometry "
                         "(~19 GiB on disk)")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--skip-lpips", action="store_true")
    ap.add_argument("--skip-encoders", action="store_true")
    ap.add_argument("--device", default="cuda", help="where the assets load and run (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    workdir = Path(args.workdir) if args.workdir else Path(tempfile.mkdtemp(prefix="aux_assets_torch_"))
    workdir.mkdir(parents=True, exist_ok=True)
    print(f"[rehearse-aux] workdir {workdir} (small={args.small}, device {device})", flush=True)
    try:
        if not args.skip_lpips:
            rehearse_lpips(workdir, device)
        if not args.skip_encoders:
            rehearse_text_encoders(workdir, args.small, device)
        print("[rehearse-aux] ALL AUX-ASSET REHEARSALS PASSED at " + ("small" if args.small else "REAL")
              + " geometry", flush=True)
        return 0
    finally:
        if not args.keep and args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
