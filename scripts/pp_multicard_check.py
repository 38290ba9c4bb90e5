"""`--pp N` across cards: the full-width FLUX.1-Kontext transformer drawn from
a seed with its stages on `cuda:0` .. `cuda:N-1`, held against the same
model drawn whole on `cuda:0`.

    python3 scripts/pp_multicard_check.py [--stages 4] [--device cuda] [--out chiprun_out/pp_multicard.json]

One process drives every card (`parallel/pipeline.py`). The script

1. draws the monolithic model on `cuda:0` and the staged one (each tensor
   drawn on `cuda:0` from the same stream and copied to its stage's card),
   prints each card's allocated memory beside its stage's bytes, and checks
   every weight bit for bit;
2. runs one 512^2 transformer forward at batch 1 through the pipeline and
   through the monolithic model (the same kernels on the same shapes: the
   same bits), and a batch-2 forward at microbatch 1 against each row's
   monolithic forward, with every kernel launch recorded by the card that was
   current when it ran (each stage's launches must land on its own card);
3. samples one 512^2 image through `pipelined_sample` and through
   `FluxTextAlphaModel.sample` with the same seed: the same bits;
4. writes `scripts/tp_torchrun_check.py`'s narrow seeded checkpoint (2 + 2
   blocks, the RGBA `ae` at full width) and runs the inference CLI on it at
   `--pp min(N, 4)` and `--pp 1`, in bf16 and with `--quant int8`
   (`from_pretrained(pipeline=)`, each stage quantised on its own card):
   the same PNG.

`--device cpu` runs steps 1-3 on the tiny config with N stages on the CPU
(no kernels; the CLI at `--pp` on the CPU is `tests/test_torch_serving.py`'s).
Prints one JSON object and writes it to `--out`.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SEED = 0
STEPS = 4


class _LaunchRecorder:
    """Stands in for the kernel library: each export called records the CUDA
    device current at the call, then runs."""

    def __init__(self, lib, torch):
        self.lib, self.torch, self.by_device = lib, torch, {}

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if not name.startswith("ragb_") or name.endswith(("tile_shape", "error_string")):
            return fn

        def call(*args):
            dev = self.torch.cuda.current_device()
            per = self.by_device.setdefault(dev, {})
            per[name] = per.get(name, 0) + 1
            return fn(*args)

        return call


def _entry_points(root: Path, pp: int) -> dict:
    """The inference CLI at `--pp pp` and `--pp 1` on a narrow seeded
    checkpoint, bf16 and int8 quantised at load: whether the PNGs are equal."""
    from PIL import Image

    from ragb_vae_tpu_torch import inference

    sys.path.insert(0, str(ROOT / "scripts"))
    from tp_torchrun_check import write_tree

    write_tree(root, "cuda")
    out: dict = {}
    for quant in ("none", "int8"):
        pngs = []
        for stages in (pp, 1):
            path = root / f"out_pp{stages}_{quant}.png"
            t0 = time.perf_counter()
            inference.main(["--pretrained_model_name_or_path", str(root / "model"), "--rgba_vae_path",
                            str(root / "vae"), "--input_image", str(root / "in.png"), "--output_path", str(path),
                            "--steps", str(STEPS), "--seed", "3", "--quant", quant, "--precision", "bf16",
                            "--pp", str(stages)])
            out[f"cli_pp{stages}_{quant}_s"] = time.perf_counter() - t0
            pngs.append(np.asarray(Image.open(path)))
        out[f"cli_{quant}_equal"] = bool(np.array_equal(*pngs))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--stages", type=int, default=0, help="pipeline stages (default: every visible card)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=str(ROOT / "chiprun_out" / "pp_multicard.json"))
    args = parser.parse_args(argv)

    import torch

    from ragb_vae_tpu_torch.device import resolve_device
    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel
    from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig
    from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
    from ragb_vae_tpu_torch.ops.kernels import _build
    from ragb_vae_tpu_torch.ops.packing import prepare_latent_image_ids
    from ragb_vae_tpu_torch.parallel.pipeline import PipelinedFluxTransformer, pipelined_sample, stage_bytes

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    n = args.stages or (torch.cuda.device_count() if cuda else 4)
    if cuda and torch.cuda.device_count() < n:
        raise SystemExit(f"--stages {n} needs {n} cards, found {torch.cuda.device_count()}")
    first = torch.device("cuda", 0) if cuda else device
    devices = [torch.device("cuda", i) for i in range(n)] if cuda else [device] * n
    t_cfg = FluxTransformerConfig() if cuda else FluxTransformerConfig.tiny()
    v_cfg = AutoencoderConfig.flux() if cuda else AutoencoderConfig.tiny()
    v_cfg.in_channels = v_cfg.out_channels = 4
    size = 512 if cuda else 32
    kw = dict(seed=SEED, dtype=torch.bfloat16 if cuda else torch.float32, fused=cuda,
              prompt_len=512 if cuda else 4)
    out: dict = {"stages": n, "devices": [str(d) for d in devices]}
    if cuda:
        out["cards"] = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        torch.backends.cuda.matmul.allow_tf32 = False
        _build._lib = _LaunchRecorder(_build.library(), torch)

    t0 = time.perf_counter()
    mono = FluxTextAlphaModel.random(t_cfg, v_cfg, device=first, **kw)
    pipe = PipelinedFluxTransformer(t_cfg, devices)
    staged = FluxTextAlphaModel.random(t_cfg, v_cfg, pipeline=pipe, **kw)
    out["build_s"] = time.perf_counter() - t0
    out["stage_bytes"] = stage_bytes(staged.transformer, n)
    out["ranges"] = [[len(d), len(s)] for d, s in pipe.ranges]
    if cuda:
        out["allocated"] = [torch.cuda.memory_allocated(i) for i in range(n)]
    want, got = mono.transformer.state_dict(), staged.transformer.state_dict()
    out["weights_equal"] = set(want) == set(got) and all(torch.equal(got[k].to(first), want[k]) for k in want)
    out["weights_on_their_stage"] = all(
        all(t.device == dev for m in pipe.stage_modules(staged.transformer, s) for t in m.parameters())
        for s, dev in enumerate(devices))

    gen = torch.Generator(first).manual_seed(SEED + 1)
    h = size // 16
    packed = torch.randn((2, 2 * h * h, t_cfg.in_channels), generator=gen, device=first).to(kw["dtype"])
    ids = prepare_latent_image_ids(h, h, device=first)
    ids = torch.cat([ids, ids], dim=0)
    t = torch.full((2,), 0.5, device=first)

    def forward(model, rows, transformer=None):
        with torch.no_grad():
            return model._transformer_pred(packed[rows], t[rows], ids, packed[rows].shape[0], transformer)

    def timed(fn):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fn()
        if cuda:
            torch.cuda.synchronize()
        return y, 1e3 * (time.perf_counter() - t0)

    def launches():
        """The launches recorded by card since the last call."""
        if not cuda:
            return {}
        got = {dev: dict(per) for dev, per in _build._lib.by_device.items()}
        _build._lib.by_device.clear()
        return got

    gt = torch.from_numpy(np.random.default_rng(SEED + 2).uniform(size=(1, size, size, 4)).astype(np.float32))
    # settle: every kernel's first launch on each card (its shared-memory opt-in)
    forward(mono, slice(0, 1))
    forward(staged, slice(0, 1), pipe)
    mono.sample(gt, num_inference_steps=1, generator=torch.Generator(first).manual_seed(SEED))
    launches()
    ref, out["mono_forward_ms"] = timed(lambda: forward(mono, slice(0, 1)))
    out["launches_by_card_mono"] = launches()
    y, out["pp_forward_ms"] = timed(lambda: forward(staged, slice(0, 1), pipe))
    out["launches_by_card_pp"] = launches()
    if cuda:
        k3 = [out["launches_by_card_pp"].get(i, {}).get("ragb_flash_attention_fwd", 0) for i in range(n)]
        out["k3_on_its_card"] = k3 == [len(d) + len(s) for d, s in pipe.ranges]
    out["forward_b1_equal"] = torch.equal(y, ref)
    out["forward_b1_max_abs"] = float((y.float() - ref.float()).abs().max())
    rows = torch.cat([forward(mono, slice(r, r + 1)) for r in range(2)])
    y2 = forward(staged, slice(None), lambda **k: pipe(**k, microbatch=1))
    out["forward_b2_mb1_equal_rows"] = torch.equal(y2, rows)

    launches()
    a, out["mono_sample_ms"] = timed(lambda: mono.sample(
        gt, num_inference_steps=STEPS, generator=torch.Generator(first).manual_seed(SEED + 3)))
    b, out["pp_sample_ms"] = timed(lambda: pipelined_sample(
        staged, pipe, gt, num_inference_steps=STEPS, generator=torch.Generator(first).manual_seed(SEED + 3)))
    out["launches_by_card_samples"] = launches()
    out["sample_equal"] = torch.equal(a, b)
    out["sample_max_abs"] = float((a - b).abs().max())
    checks = ["weights_equal", "weights_on_their_stage", "forward_b1_equal", "forward_b2_mb1_equal_rows",
              "sample_equal"]
    if cuda:
        del mono, staged, pipe, ref, y, y2, rows, a, b
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            out.update(_entry_points(Path(tmp), min(n, 4)))
        checks += ["k3_on_its_card", "cli_none_equal", "cli_int8_equal"]
    out["ok"] = all(out[k] for k in checks)
    text = json.dumps(out, default=str)
    print(text, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(text)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
