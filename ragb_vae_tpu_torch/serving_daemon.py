"""HTTP serving daemon for text-alpha inference (CLI core).

Counterpart of `ragb_vae_tpu/serving_daemon.py`: one resident process
holding the model and a dynamic batcher (`serving.py`), the same flags, the
same endpoints and the same answers. `scripts/serve_torch.py` is a thin shim
over this module; the installed `ragb-serve-torch` entry point calls it
directly.

    ragb-serve-torch \
        --pretrained_model_name_or_path ... --rgba_vae_path ... \
        [--lora_path ...] [--port 8418] [--max-batch 4] [--steps 20] \
        [--quant int8] [--warmup 512x512,1024x1024] [--device cuda]

Endpoints:
    POST /predict[?seed=N]   body: RGBA PNG  ->  200, predicted RGBA PNG
    GET  /healthz            -> {"status": "ok", "served": N, "pending": N,
                                 "batches": N, "latency_avg_ms": x,
                                 "latency_max_ms": x}
    GET  /metrics            -> utils/profiling.py::counters(): {name: {"count",
                                 "total", "max"}} of the batcher's counters
                                 and `http.png`

`--device` names where it runs (default `cuda`; a missing card raises). On a
CUDA device the RGBA VAE runs its fused kernels. `--tp N` serves the
transformer tensor-parallel over N processes, one per device:

    torchrun --nproc-per-node N -m ragb_vae_tpu_torch.serving_daemon --tp N ...

(N must equal the world size). Rank 0 binds the HTTP port and runs the
batcher; every batch is broadcast to the other ranks, which follow in
`InferenceServer.serve_worker` until rank 0's SIGTERM drain broadcasts the
stop message, so all ranks exit. `--pp N` serves the transformer as an
N-stage pipeline from this one process (`parallel/pipeline.py`; on the card
over `cuda:0` .. `cuda:N-1`, with `--device cpu` on the CPU), with the same
answers as `--pp 1`; `--tp` and `--pp` exclude each other.
`--compilation-cache` is accepted so that a
command line of the JAX daemon runs unchanged, and has no effect (the CUDA
kernels are built once into `build/kernels/` and kept there).

The HTTP handler threads only decode and encode PNGs and wait on a future:
every tensor is made and used on the batcher thread, which runs in
inference mode. A handler opens a `request_scope`, whose identifier the
request keeps in the batcher, and the spans `http.decode#<request>` (read
the body, decode the PNG, convert to float), `http.wait#<request>` and
`http.encode#<request>` (clip, encode the PNG, write); its counter
`http.png` adds up a request's decode and encode.
"""
from __future__ import annotations

import argparse
import io
import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ragb_vae_tpu_torch.inference import _DTYPES
from ragb_vae_tpu_torch.utils.profiling import Counter, annotate, counters, request_scope


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Batched text-alpha inference daemon (PyTorch).")
    p.add_argument("--pretrained_model_name_or_path", type=str, required=True)
    p.add_argument("--rgba_vae_path", type=str, required=True)
    p.add_argument("--vae_subfolder", type=str, default="ae")
    p.add_argument("--lora_path", type=str, default=None)
    p.add_argument("--rank", type=int, default=96)
    p.add_argument("--lora_alpha", type=int, default=128)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8418)
    p.add_argument("--max-batch", type=int, default=4,
                   help="Upper bound on the serving batch. With auto-batch (default) warmup "
                        "times batch 1 and this bound per bucket and serves at the smallest "
                        "batch within 5%% of the best throughput.")
    p.add_argument("--no-auto-batch", action="store_true",
                   help="Always serve at --max-batch (skip the measured per-bucket batch policy).")
    p.add_argument("--max-delay-ms", type=float, default=30.0)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--precision", type=str, default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--tp", type=int, default=1,
                   help="Tensor parallelism over N processes under torchrun --nproc-per-node N.")
    p.add_argument("--pp", type=int, default=1,
                   help="Pipeline parallelism: the transformer in N stages on cuda:0..N-1 (N stages on the "
                        "CPU with --device cpu), driven by this one process.")
    p.add_argument("--quant", type=str, default="none", choices=["none", "int8"],
                   help="Weight-only int8 transformer: a quantised checkpoint "
                        "(scripts/quantize_flux_checkpoint_torch.py) loads as it is, a plain one "
                        "is quantised at load.")
    p.add_argument("--warmup", type=str, default="",
                   help="Comma-separated HxW sizes to run once at startup (e.g. "
                        "'512x512,1024x1024'), so the kernel build and the batch choice do not "
                        "land on the first request.")
    p.add_argument("--compilation-cache", type=str, default="auto",
                   help="Accepted for the JAX daemon's command line; no effect here.")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to serve on. 'cuda' without a CUDA device is an error.")
    return p.parse_args(argv)


def build_server(args: argparse.Namespace):
    """The model of `args` on its device, behind an `InferenceServer` that
    is not started yet."""
    from ragb_vae_tpu_torch.device import resolve_device
    from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel, read_lora_metadata
    from ragb_vae_tpu_torch.serving import InferenceServer, ServeConfig

    from ragb_vae_tpu_torch.parallel.bootstrap import build_pipelined_transformer, build_tp_group, validate_tp_pp
    from ragb_vae_tpu_torch.parallel.mesh import local_device

    validate_tp_pp(args.tp, args.pp)
    device = local_device(resolve_device(args.device))
    tp = build_tp_group(args.tp, device)
    pipe = build_pipelined_transformer(args.pp, device, args.pretrained_model_name_or_path)
    if getattr(args, "compilation_cache", "off") != "off":
        print("[serve] --compilation-cache has no effect in the PyTorch port", flush=True)
    if args.lora_path:
        meta = read_lora_metadata(args.lora_path)
        if meta:
            args.rank = int(meta.get("rank", args.rank))
            args.lora_alpha = int(meta.get("lora_alpha", meta.get("alpha", args.lora_alpha)))
    model = FluxTextAlphaModel.from_pretrained(
        args.pretrained_model_name_or_path,
        vae_path=args.rgba_vae_path,
        vae_subfolder=args.vae_subfolder,
        dtype=_DTYPES[args.precision],
        device=device,
        fused=device.type == "cuda",
        lora_rank=args.rank if args.lora_path else 0,
        lora_alpha=float(args.lora_alpha) if args.lora_path else 0.0,
        weight_quant=args.quant,
        tp=tp,
        pipeline=pipe,
    )
    if args.lora_path:
        model.load_lora(args.lora_path)
    cfg = ServeConfig(
        max_batch=args.max_batch, max_delay_ms=args.max_delay_ms, steps=args.steps,
        auto_batch=not getattr(args, "no_auto_batch", False),
    )
    return InferenceServer(model, cfg, tp_group=tp, pipeline=pipe)


def make_handler(server) -> type:
    """The request handler class over `server` (anything with `submit`,
    `stats` and `config.request_timeout_s`)."""
    from PIL import Image

    png = Counter("http.png")

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet by default
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {"status": "ok", **server.stats})
            elif path == "/metrics":
                self._json(200, counters())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/predict":
                self._json(404, {"error": "unknown path"})
                return
            with request_scope() as rid:
                try:
                    t0 = time.perf_counter()
                    with annotate("http.decode", request=rid):
                        length = int(self.headers.get("Content-Length", 0))
                        img = Image.open(io.BytesIO(self.rfile.read(length))).convert("RGBA")
                        arr = np.asarray(img, dtype=np.float32) / 255.0
                    decode_s = time.perf_counter() - t0
                    qs = parse_qs(url.query)
                    seed = int(qs["seed"][0]) if "seed" in qs else None
                    with annotate("http.wait", request=rid):
                        pred = server.submit(arr, seed=seed).result(timeout=server.config.request_timeout_s)
                    t1 = time.perf_counter()
                    with annotate("http.encode", request=rid):
                        out = Image.fromarray((np.clip(pred, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8), "RGBA")
                        buf = io.BytesIO()
                        out.save(buf, format="PNG")
                        data = buf.getvalue()
                        self.send_response(200)
                        self.send_header("Content-Type", "image/png")
                        self.send_header("Content-Length", str(len(data)))
                        self.end_headers()
                        self.wfile.write(data)
                    png.add(decode_s + time.perf_counter() - t1)
                except Exception as exc:  # the daemon answers every request
                    self._json(500, {"error": f"{type(exc).__name__}: {exc}"})

    return Handler


def make_httpd(server, host: str, port: int) -> ThreadingHTTPServer:
    """A bound, not yet serving HTTP server over `server`; port 0 picks a
    free one (`httpd.server_address[1]`)."""
    return ThreadingHTTPServer((host, port), make_handler(server))


def _parse_sizes(spec: str):
    sizes = []
    for part in spec.split(","):
        h, w = part.lower().split("x")
        sizes.append((int(h), int(w)))
    return sizes


def main(argv=None) -> None:
    args = parse_args(argv)
    server = build_server(args)
    if server.tp.rank > 0:
        # a worker rank: follow rank 0's batches until its drain stops us.
        # torchrun passes a SIGTERM to every rank; this one waits for rank
        # 0's stop message instead, so rank 0 can finish the queued batches.
        try:
            signal.signal(signal.SIGTERM, lambda signum, frame: print(
                f"[serve] rank {server.tp.rank}: SIGTERM - waiting for rank 0's drain", flush=True))
        except ValueError:
            pass  # not the main thread (embedded use)
        n = server.serve_worker()
        print(f"[serve] rank {server.tp.rank}: ran {n} batches, stopped by rank 0", flush=True)
        return
    if args.warmup:
        sizes = _parse_sizes(args.warmup)
        print(f"[serve] warming up {sizes} ...", flush=True)
        server.warmup(sizes)
        print("[serve] warmup done", flush=True)
    server.start()
    httpd = make_httpd(server, args.host, args.port)
    host, port = httpd.server_address[:2]
    print(f"[serve] listening on http://{host}:{port} "
          f"(max_batch={args.max_batch}, steps={args.steps}, device={args.device})", flush=True)

    # SIGTERM (preemption, orchestrator shutdown): stop accepting, answer
    # everything already queued, exit 0. httpd.shutdown() must run off the
    # serve_forever thread, and a signal handler must not block.
    def _on_sigterm(signum, frame):
        print("[serve] SIGTERM - draining and shutting down", flush=True)
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        pass  # not the main thread (embedded use)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        clean = server.drain()
        print(f"[serve] drained {'cleanly' if clean else 'with queued work failed'}; "
              f"served {server.stats['served']}", flush=True)


if __name__ == "__main__":
    main()
