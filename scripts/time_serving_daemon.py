#!/usr/bin/env python3
"""Serving latency in-process and through the HTTP daemon, in turns, on one card.

    python3 scripts/time_serving_daemon.py [--rounds 2] [--steps 4]

Builds FluxTextAlphaModel once at full published width (FLUX.1-Kontext
transformer and FLUX `ae` RGBA VAE, random weights from seed 0, bf16, fused
kernels) and serves chip_smoke's serving phase's three requests (512², 512²,
600x400, seeds 0-2, uint8-quantised images) in rounds, in the order
P H H P (`--rounds` times):

- P: the three submitted at once to an `InferenceServer` (max_batch 2,
  `--steps` sampler steps), as chip_smoke's int8 phase serves them;
- H: the same three sent at once as PNGs to `/predict` of the daemon's own
  HTTP server (`serving_daemon.make_httpd`, 127.0.0.1) over a fresh server.

Each request's latency is split on the host clock: for H, the upload and PNG
decode before `submit`, the server (submit to the future's result, the
batch and its resize included) and the PNG encode and download after it; for
P, the server part alone. A first P round (cold) is reported apart. Also: the
host time of one PNG decode and encode of a 512² request and answer with the
card idle, and one request at a time (512², b1) each way. Prints the card's
name and power limit first and the rounds as JSON last; writes the JSON to
`chiprun_out/time_serving_daemon.json`.
"""
from __future__ import annotations

import argparse
import io
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ragb_vae_tpu_torch import serving_daemon  # noqa: E402
from ragb_vae_tpu_torch.serving import InferenceServer, ServeConfig  # noqa: E402

SIZES = ((512, 512), (512, 512), (600, 400))


class _Timed:
    """Stands in for the server behind the daemon's handler and records, per
    request, when `submit` was called and when its future was answered."""

    def __init__(self, server: InferenceServer):
        self.server = server
        self.config = server.config
        self.events: dict = {}

    @property
    def stats(self):
        return self.server.stats

    def submit(self, image, *, seed=None):
        record = self.events.setdefault(seed, {})
        record["submitted"] = time.perf_counter()
        fut = self.server.submit(image, seed=seed)
        fut.add_done_callback(lambda _: record.__setitem__("answered", time.perf_counter()))
        return fut


def _png(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, "RGBA").save(buf, format="PNG")
    return buf.getvalue()


def _in_process(model, images, seeds, steps):
    """All requests submitted at once -> ({seed: server seconds}, stats)."""
    server = InferenceServer(model, ServeConfig(max_batch=2, steps=steps, auto_batch=False)).start()
    timed = _Timed(server)
    try:
        futures = [timed.submit(img.astype(np.float32) / 255.0, seed=s) for img, s in zip(images, seeds)]
        for fut in futures:
            fut.result(timeout=900)
        stats = server.stats
    finally:
        server.drain(timeout=60)
    return {s: {"server_s": e["answered"] - e["submitted"]} for s, e in timed.events.items()}, stats


def _over_http(model, images, seeds, steps):
    """All requests sent at once as PNGs through the daemon ->
    ({seed: {client_s, before_s, server_s, after_s}}, stats)."""
    bodies = [_png(img) for img in images]
    server = InferenceServer(model, ServeConfig(max_batch=2, steps=steps, auto_batch=False)).start()
    timed = _Timed(server)
    httpd = serving_daemon.make_httpd(timed, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05}, daemon=True)
    thread.start()

    def post(i):
        t0 = time.perf_counter()
        req = urllib.request.Request(f"{base}/predict?seed={seeds[i]}", data=bodies[i], method="POST")
        with urllib.request.urlopen(req, timeout=900) as resp:
            body = resp.read()
        if Image.open(io.BytesIO(body)).size != (images[i].shape[1], images[i].shape[0]):
            raise SystemExit("[time_serving_daemon] an answer has the wrong size")
        return t0, time.perf_counter()

    try:
        with ThreadPoolExecutor(len(bodies)) as pool:
            spans = list(pool.map(post, range(len(bodies))))
        stats = server.stats
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
        server.drain(timeout=60)
    out = {}
    for s, (t0, t1) in zip(seeds, spans):
        e = timed.events[s]
        out[s] = {"client_s": t1 - t0, "before_s": e["submitted"] - t0,
                  "server_s": e["answered"] - e["submitted"], "after_s": t1 - e["answered"]}
    return out, stats


def _codec_ms(image: np.ndarray, answer: np.ndarray, reps: int = 5) -> dict:
    """Host ms of the daemon's PNG work for one request with the card idle."""
    body = _png(image)

    def decode():
        return np.asarray(Image.open(io.BytesIO(body)).convert("RGBA"), dtype=np.float32) / 255.0

    def encode():
        return _png((np.clip(answer, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8))

    out = {}
    for name, fn in (("decode", decode), ("encode", encode)):
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            times.append(1000.0 * (time.perf_counter() - t))
        out[f"{name}_ms"] = statistics.median(times)
    out["request_png_bytes"] = len(body)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=2, help="P H H P repetitions")
    parser.add_argument("--steps", type=int, default=4, help="sampler steps a request")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("[time_serving_daemon] no CUDA device: this script times the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)

    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel
    from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig
    from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig

    vae_cfg = AutoencoderConfig.flux()
    vae_cfg.in_channels = vae_cfg.out_channels = 4
    model = FluxTextAlphaModel.random(FluxTransformerConfig(), vae_cfg, seed=0, device="cuda",
                                      dtype=torch.bfloat16, fused=True)
    rng = np.random.default_rng(0)
    images = [(rng.uniform(size=(*size, 4)) * 255.0 + 0.5).astype(np.uint8) for size in SIZES]
    seeds = list(range(len(images)))

    result = {"card": smi, "steps": args.steps, "sizes": SIZES, "rounds": []}
    cold, _ = _in_process(model, images, seeds, args.steps)
    result["cold_in_process"] = cold
    print(f"[time] cold P: {json.dumps(cold)}", flush=True)
    for r in range(args.rounds):
        for kind in ("P", "H", "H", "P"):
            run = _in_process if kind == "P" else _over_http
            lat, stats = run(model, images, seeds, args.steps)
            result["rounds"].append({"kind": kind, "requests": lat, "stats": stats})
            line = ", ".join(f"seed {s}: " + " ".join(f"{k} {v:.3f}" for k, v in d.items()) for s, d in lat.items())
            print(f"[time] round {r} {kind}: {line}; batches {stats['batches']}", flush=True)
    one = [images[0]], [0]
    for kind, run in (("P", _in_process), ("H", _over_http), ("H", _over_http), ("P", _in_process)):
        lat, _ = run(model, *one, args.steps)
        result.setdefault("single_512", []).append({"kind": kind, **lat[0]})
        print(f"[time] one 512^2 request {kind}: " + " ".join(f"{k} {v:.3f}" for k, v in lat[0].items()), flush=True)
    answer = rng.uniform(size=(512, 512, 4)).astype(np.float32)
    result["codec_idle"] = _codec_ms(images[0], answer)
    print(f"[time] PNG work of one 512^2 request with the card idle: {result['codec_idle']}", flush=True)
    out = ROOT / "chiprun_out" / "time_serving_daemon.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
