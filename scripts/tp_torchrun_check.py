"""`--tp N` through the port's own entry points under torchrun, one process a
card: the inference CLI (bf16, and int8 quantised at load) and the serving
daemon, each held against the same entry point on one process.

    python3 scripts/tp_torchrun_check.py [--nproc 4] [--device cuda] [--out chiprun_out/tp_torchrun.json]

It writes a seeded checkpoint tree into a temporary directory: a narrow
FLUX-Kontext transformer (2 + 2 blocks, 8 heads of 128, so every degree
that divides 8 fits the kernels) and the RGBA FLUX `ae` at its published
width, then runs

1. `python -m ragb_vae_tpu_torch.inference` on one process and under
   `torchrun --nproc-per-node N ... --tp N` on the same 512^2 image and seed,
   in bf16 and with `--quant int8`, and compares the PNGs they write (the
   sharded sum differs from the whole one in its rounding only: `MAX_ERR`,
   `IMAGE_TOL`);
2. `torchrun --nproc-per-node N -m ragb_vae_tpu_torch.serving_daemon --tp N`
   with its process groups' timeout cut to `--group-timeout` seconds
   (`RAGB_DIST_TIMEOUT_S`), waits `--idle` seconds (2.5 timeouts) with no
   request, so that the worker ranks wait through their broadcast's timeout
   unless rank 0's keep-alive headers reach them, then
   posts the image with the same seed, reads /healthz, sends SIGTERM to
   torchrun (which passes it to every rank: rank 0 drains and broadcasts the
   stop message, the other ranks wait for it) and checks that every rank
   drained and that torchrun ended.

On the CPU (`--device cpu`) the ranks join a gloo group; on the card, NCCL.
Prints one JSON object and writes it to `--out`.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SEED = 0
STEPS = 4
# A PNG written at --tp N against the one-process PNG: no pixel more than 8
# levels off, and the whole image within the relative error and cosine that
# chip_smoke's tp phase and `dist_multicard_check.py`'s TP serving run hold
# the same arithmetic to. In bf16 each of the N ranks' partial sums is
# rounded before the all-reduce (N + 1 roundings where one process makes
# one), so at N = 4 a mean error below half a level does not hold: on four
# H100s the mean error read 0.68-0.71 levels.
MAX_ERR = 8 / 255
IMAGE_TOL = (0.02, 0.999)          # relative L2 error, cosine


def _compare(got: np.ndarray, want: np.ndarray) -> dict:
    diff = got - want
    rel = float(np.linalg.norm(diff) / np.linalg.norm(want))
    cos = float(np.dot(got.ravel(), want.ravel()) / (np.linalg.norm(got) * np.linalg.norm(want)))
    return {"max_abs_err": float(np.abs(diff).max()), "mean_abs_err": float(np.abs(diff).mean()),
            "rel_err": rel, "cosine": cos,
            "within": float(np.abs(diff).max()) <= MAX_ERR and rel <= IMAGE_TOL[0] and cos >= IMAGE_TOL[1]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_tree(root: Path, device: str) -> None:
    """model/transformer, model/empty_prompt_embeds.npz and vae/ae from seed 0."""
    import torch

    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import EMPTY_PROMPT_FILE, FluxTextAlphaModel
    from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig
    from ragb_vae_tpu_torch.models.flux_weights import save_flux_transformer_params
    from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
    from ragb_vae_tpu_torch.models.weights import save_autoencoder_params

    t_cfg = FluxTransformerConfig(num_layers=2, num_single_layers=2, num_attention_heads=8,
                                  joint_attention_dim=512, pooled_projection_dim=256)
    v_cfg = AutoencoderConfig.flux()
    v_cfg.in_channels = v_cfg.out_channels = 4
    model = FluxTextAlphaModel.random(t_cfg, v_cfg, seed=SEED, device=device, prompt_len=64)
    save_flux_transformer_params(t_cfg, model.transformer.state_dict(), root / "model" / "transformer")
    save_autoencoder_params(v_cfg, model.vae.module.state_dict(), root / "vae" / "ae")
    np.savez(root / "model" / EMPTY_PROMPT_FILE, prompt_embeds=model.prompt_embeds.cpu().numpy(),
             pooled_prompt_embeds=model.pooled_prompt_embeds.cpu().numpy(), text_ids=model.text_ids.cpu().numpy())
    from PIL import Image

    rgba = (np.random.default_rng(SEED).uniform(size=(8, 8, 4)) * 255).astype(np.uint8)
    Image.fromarray(rgba, "RGBA").resize((512, 512), resample=3).save(root / "in.png")
    del model
    if device != "cpu":
        torch.cuda.empty_cache()


def _precision(args) -> str:
    return "fp32" if args.device == "cpu" else "bf16"


def _torchrun(nproc: int) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
            "--master-addr", "127.0.0.1", "--master-port", str(_free_port())]


def _load(path: Path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGBA"), np.float32) / 255.0


def run_inference(root: Path, args, tp: int, quant: str) -> dict:
    out = root / f"out_tp{tp}_{quant}.png"
    cli = ["-m", "ragb_vae_tpu_torch.inference", "--pretrained_model_name_or_path", str(root / "model"),
           "--rgba_vae_path", str(root / "vae"), "--input_image", str(root / "in.png"), "--output_path", str(out),
           "--steps", str(STEPS), "--seed", "3", "--quant", quant, "--device", args.device,
           "--precision", _precision(args)]
    cmd = (_torchrun(tp) + cli + ["--tp", str(tp)]) if tp > 1 else [sys.executable] + cli
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=args.timeout)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"inference tp={tp} quant={quant} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return {"path": out, "seconds": seconds}


def run_daemon(root: Path, args) -> dict:
    port = _free_port()
    log = root / "daemon.log"
    env = {**os.environ, "RAGB_DIST_TIMEOUT_S": str(args.group_timeout)}
    cmd = _torchrun(args.nproc) + [
        "-m", "ragb_vae_tpu_torch.serving_daemon", "--tp", str(args.nproc), "--device", args.device,
        "--pretrained_model_name_or_path", str(root / "model"), "--rgba_vae_path", str(root / "vae"),
        "--port", str(port), "--steps", str(STEPS), "--max-batch", "1", "--no-auto-batch",
        "--precision", _precision(args)]
    with open(log, "w") as sink:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=sink, stderr=subprocess.STDOUT, env=env)
    try:
        deadline = time.monotonic() + args.timeout
        while "listening on" not in log.read_text():
            if proc.poll() is not None or time.monotonic() > deadline:
                raise SystemExit(f"the daemon did not start:\n{log.read_text()[-4000:]}")
            time.sleep(0.5)
        base = f"http://127.0.0.1:{port}"
        time.sleep(args.idle)
        if proc.poll() is not None:
            raise SystemExit(f"the daemon died while idle:\n{log.read_text()[-4000:]}")
        t0 = time.perf_counter()
        req = urllib.request.Request(f"{base}/predict?seed=3", data=(root / "in.png").read_bytes(), method="POST")
        with urllib.request.urlopen(req, timeout=args.timeout) as resp:
            (root / "daemon_out.png").write_bytes(resp.read())
        seconds = time.perf_counter() - t0
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = log.read_text()
    return {"seconds": seconds, "idle_s": args.idle, "group_timeout_s": args.group_timeout, "health": health,
            "torchrun_exit": proc.returncode,
            "rank0_drained": "drained cleanly" in text,
            "workers_stopped": sum(f"rank {r}: ran" in text for r in range(1, args.nproc)),
            "path": root / "daemon_out.png"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nproc", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--timeout", type=float, default=600.0)
    parser.add_argument("--group-timeout", type=float, default=12.0,
                        help="the daemon's process-group timeout in seconds")
    parser.add_argument("--idle", type=float, default=30.0,
                        help="seconds the daemon waits for its first request")
    parser.add_argument("--out", default=str(ROOT / "chiprun_out" / "tp_torchrun.json"))
    args = parser.parse_args(argv)
    result: dict = {"nproc": args.nproc, "device": args.device}
    if args.device != "cpu":
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < args.nproc:
            raise SystemExit(f"needs {args.nproc} CUDA devices")
        result["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                        capture_output=True, text=True).stdout.strip().splitlines()
        from ragb_vae_tpu_torch.ops.kernels import _build

        _build.build()      # once, before the ranks: none of them waits in a collective while another compiles
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_tree(root, args.device)
        for quant in ("none", "int8"):
            one, tp = run_inference(root, args, 1, quant), run_inference(root, args, args.nproc, quant)
            cmp = _compare(_load(tp["path"]), _load(one["path"]))
            fine = cmp.pop("within")
            ok &= fine
            result[f"inference_{quant}"] = {"one_process_s": one["seconds"], "tp_s": tp["seconds"], **cmp, "ok": fine}
        daemon = run_daemon(root, args)
        cmp = _compare(_load(daemon.pop("path")), _load(root / "out_tp1_none.png"))
        fine = (cmp.pop("within") and daemon["rank0_drained"] and daemon["workers_stopped"] == args.nproc - 1
                and daemon["health"].get("served") == 1)
        ok &= fine
        result["daemon"] = {**daemon, "vs_one_process": cmp, "ok": fine}
    result["ok"] = bool(ok)
    text = json.dumps(result)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(text)
    print(text, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
