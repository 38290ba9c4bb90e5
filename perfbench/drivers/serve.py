"""Served text-alpha requests through the program's HTTP daemon.

Set-up builds the program's `FluxTextAlphaModel` over weights drawn from
the seed, an `InferenceServer` at the traffic's `ServeConfig` and the
daemon's `make_httpd` on 127.0.0.1 (a port the OS picks), and warms the one
batch shape the traffic uses. The window: `clients` closed-loop clients,
each POSTing its own seeded RGBA PNGs (with a seed a request) and waiting
for the answer before sending the next, until `--seconds` have passed;
requests still in flight are then answered and waited for. The end-to-end
metrics are taken over the answers received in the window; the correctness
check runs the plain reference over a sample of them once the server is
freed.

The traced run profiles `trace_steps` whole transformer steps of the
window's batch `trace_batch`, on the batcher's own thread.
"""
from __future__ import annotations

import http.client
import io
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import harness, program
from perfbench.reference import flux as RF
from perfbench.reference import vae as RV
from perfbench.reference.numerics import Numerics, exact_fp32
from perfbench.yardstick import flops as FL


def make_images(traffic: dict, seed: int, device) -> np.ndarray:
    """(n, H, W, 4) uint8: smooth seeded RGBA images (low-resolution noise
    upsampled, alpha sharpened so each has opaque, clear and edge pixels)."""
    n, h, w = traffic["distinct_images"], traffic["height"], traffic["width"]
    from perfbench.reference.weights import draw_like

    low = draw_like(seed, program.STREAM["images"], (n, 4, 12, 12), device, kind="uniform")
    img = F.interpolate(low, size=(h, w), mode="bicubic", align_corners=False)
    alpha = torch.clamp((img[:, 3:] - 0.5) * 4.0 + 0.5, 0.0, 1.0)
    img = torch.cat([torch.clamp(img[:, :3], 0.0, 1.0), alpha], dim=1)
    return (img.permute(0, 2, 3, 1) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()


def encode_png(arr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, "RGBA").save(buf, format="PNG", compress_level=1)
    return buf.getvalue()


def decode_png(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


class _Client(threading.Thread):
    """One closed-loop caller: send, wait for the whole answer, send the next."""

    def __init__(self, port: int, requests: List[dict], start: threading.Event, deadline: List[float]):
        super().__init__(daemon=True)
        self.port, self.requests, self.start_evt, self.deadline = port, requests, start, deadline
        self.results: List[dict] = []

    def run(self) -> None:
        self.start_evt.wait()
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=600)
        try:
            for req in self.requests:
                t_send = time.perf_counter()
                if t_send >= self.deadline[0]:
                    break
                try:
                    conn.request("POST", f"/predict?seed={req['seed']}", body=req["png"],
                                 headers={"Content-Type": "image/png"})
                    resp = conn.getresponse()
                    body = resp.read()
                    status = resp.status
                except (OSError, http.client.HTTPException) as exc:
                    body, status = repr(exc).encode(), -1
                    conn.close()
                    conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=600)
                self.results.append({**req, "t_send": t_send, "t_recv": time.perf_counter(), "status": status,
                                     "body": body})
        finally:
            conn.close()


def _instrument(model, tracer, record: harness.RunRecord, counters: Dict[str, int]):
    """Count batches and transformer forwards; with a tracer, trace
    `trace_steps` whole transformer forwards of window batch `trace_batch`
    from step `trace_step` on, starting and stopping at forward boundaries on
    the batcher's thread (a short stretch: stopping the profiler is
    expensive on the host)."""
    encode = model.encode_latents
    traffic = record.traffic

    def encode_latents(x, eps):
        counters["batches"] += 1
        counters["step_in_batch"] = 0
        return encode(x, eps)

    def forward_hook(module, args, kwargs):
        hidden = kwargs.get("hidden_states", args[0] if args else None)
        counters["forwards"] += 1
        counters["step_in_batch"] += 1
        if tracer is None:
            return
        if counters.get("tracing") and counters["traced_forwards"] == traffic["trace_steps"]:
            tracer.stop()
            counters["tracing"] = 0
        elif (not counters.get("tracing") and not counters["traced_forwards"]
              and counters["batches"] == traffic["trace_batch"] and counters["step_in_batch"] == traffic["trace_step"]):
            tracer.start()
            counters["tracing"] = 1
        if counters.get("tracing"):
            counters["traced_forwards"] += 1
            counters["traced_forward_rows"] += hidden.shape[0]
            counters["img_seq"] = hidden.shape[1]

    model.encode_latents = encode_latents
    model.transformer.register_forward_pre_hook(forward_hook, with_kwargs=True)


def run(record: harness.RunRecord, *, seed: int, device: torch.device) -> None:
    from ragb_vae_tpu_torch.serving import InferenceServer, ServeConfig
    from ragb_vae_tpu_torch.serving_daemon import make_httpd

    cfg, traffic = record.config, record.traffic
    torch.set_num_threads(traffic.get("torch_threads", 4))
    dtype = program.DTYPES[traffic["dtype"]]
    model = program.build_textalpha_model(cfg, seed, device, dtype=dtype)
    server = InferenceServer(model, ServeConfig(
        max_batch=traffic["max_batch"], max_delay_ms=traffic["max_delay_ms"], steps=traffic["steps"],
        auto_batch=traffic["auto_batch"]))

    images = make_images(traffic, seed, device)
    pngs = [encode_png(a) for a in images]
    rng = np.random.default_rng(seed % 2**63)
    clients_requests = []
    for c in range(traffic["clients"]):
        reqs = []
        for k in range(traffic["requests_per_client"]):
            i = int(rng.integers(len(pngs)))
            reqs.append({"client": c, "index": k, "image": i, "png": pngs[i],
                         "seed": int(rng.integers(0, 2**31 - 1))})
        clients_requests.append(reqs)

    server.warmup([(traffic["height"], traffic["width"])])
    harness.synchronize(device)
    counters = {"batches": 0, "forwards": 0, "traced_forwards": 0, "traced_forward_rows": 0, "step_in_batch": 0}
    tracer = harness.Tracer(device) if record.trace_on else None
    _instrument(model, tracer, record, counters)
    server.start()
    httpd = make_httpd(server, "127.0.0.1", 0)
    port = httpd.server_address[1]
    serving = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05}, daemon=True)
    serving.start()

    go, deadline = threading.Event(), [float("inf")]
    clients = [_Client(port, reqs, go, deadline) for reqs in clients_requests]
    for cl in clients:
        cl.start()
    t0 = time.perf_counter()
    record.setup_s = time.time() - record.counters["process_start"]
    deadline[0] = t0 + record.seconds
    go.set()
    for cl in clients:
        cl.join(timeout=record.seconds + 900)
    if any(cl.is_alive() for cl in clients):
        raise harness.BenchmarkError("a client did not finish")
    if tracer is not None and tracer.running:
        tracer.stop()           # the window closed inside the traced stretch
        counters["tracing"] = 0
    stats = server.stats
    httpd.shutdown()
    httpd.server_close()
    server.drain(timeout=60)
    serving.join(timeout=30)
    record.device_kind, record.memory_peak_bytes = harness.device_facts(device)

    results = [r for cl in clients for r in cl.results]
    ok = [r for r in results if r["status"] == 200]
    in_window = [r for r in ok if r["t_recv"] <= deadline[0]]
    record.attempted = len(results)
    record.failed = len(results) - len(ok)
    if in_window:
        last = max(r["t_recv"] for r in in_window)
        record.e2e["serve_img_per_s"] = len(in_window) / (last - t0)
        record.e2e["serve_latency_p90_s"] = harness.percentile([r["t_recv"] - r["t_send"] for r in in_window], 90)
    record.notes.append(f"set-up {record.setup_s:.2f} s; {len(in_window)} requests answered in the window of {record.seconds} s "
                        f"({len(ok)} in all, {record.failed} failed); {stats}")
    record.trace = tracer.collect() if tracer is not None else None
    t = cfg["transformer"]
    record.counters.update(counters)
    record.counters.update({
        "client_latency_mean_ms": 1000.0 * float(np.mean([r["t_recv"] - r["t_send"] for r in ok])) if ok else None,
        "server_latency_mean_ms": stats.get("latency_avg_ms"),
        "served": stats.get("served"), "server_batches": stats.get("batches"),
        "flops_per_image": FL.textalpha_sample_flops(FL.as_config(t), FL.as_config(cfg["vae"]), traffic["height"],
                                                     traffic["steps"], cfg["prompt_len"]),
        "txt_seq": cfg["prompt_len"], "image_size": traffic["height"],
    })

    # -- correctness, once the program's state is freed -------------------
    del server, model, httpd
    harness.free_device_memory(device)
    sample = _sample(in_window, traffic["check_requests"], seed)
    t_ref = time.time()
    record.checks.extend(check_answers(cfg, traffic, seed, device, sample, images, record.counters))
    record.notes.append(f"reference over {len(sample)} answers: {time.time() - t_ref:.1f} s")


def _sample(answers: List[dict], k: int, seed: int) -> List[dict]:
    if not answers:
        return []
    rng = np.random.default_rng((seed + 17) % 2**63)
    order = rng.permutation(len(answers))[:k]
    return [answers[i] for i in sorted(order)]


def reference_images(cfg: dict, traffic: dict, seed: int, device, requests: List[dict], images: np.ndarray,
                     precision: str = "fp32") -> List[torch.Tensor]:
    """The plain reference's (H, W, 4) answer in [0, 1] to each request."""
    t = cfg["transformer"]
    num = Numerics(precision)
    P = program.flux_state(cfg, seed, device, program.DTYPES[traffic["dtype"]])
    Pv = program.vae_state(cfg, seed, device, program.DTYPES[traffic["dtype"]])
    prompt, pooled = program.prompt_embeddings(cfg, seed, device)
    flux = RF.FluxReference(P, t, num)
    vae = RV.VaeReference(Pv, cfg["vae"], num)
    v = cfg["vae"]
    scale = 2 ** (len(v["block_out_channels"]) - 1)
    mu = RF.schedule_mu(cfg["scheduler"], (v["sample_size"] // scale) ** 2)
    out = []
    with torch.no_grad(), exact_fp32():
        for req in requests:
            x = torch.from_numpy(images[req["image"]]).to(device).float()[None] / 255.0
            h, w = x.shape[1] // scale, x.shape[2] // scale
            gen = torch.Generator(device).manual_seed(req["seed"] & 0xFFFFFFFF)
            kw = {"generator": gen, "device": device, "dtype": torch.float32}
            eps = torch.randn((h, w, v["latent_channels"]), **kw)[None]
            init = torch.randn((h, w, v["latent_channels"]), **kw)[None]
            steps = torch.randn((traffic["steps"], h, w, v["latent_channels"]), **kw)[:, None]
            mean, logvar = vae.encode(x * 2.0 - 1.0)
            cond = (RV.sample(mean, logvar, eps) - v["shift_factor"]) * v["scaling_factor"]
            lat = RF.sample_latents(flux, cfg["scheduler"], mu, cond, init, steps, prompt, pooled,
                                    cfg["guidance_scale"])
            dec = vae.decode(lat / v["scaling_factor"] + v["shift_factor"])
            out.append(torch.clamp((dec[0] + 1.0) * 0.5, 0.0, 1.0))
    del P, Pv, flux, vae
    harness.free_device_memory(device)
    return out


def check_answers(cfg: dict, traffic: dict, seed: int, device, sample: List[dict], images: np.ndarray,
                  keep: Optional[dict] = None) -> List[harness.Check]:
    """The sampled answers against the reference's; `keep` gets both (for the control)."""
    limits = traffic["limits"]
    if not sample:
        return [harness.Check("answers_checked", 0.0, -1.0)]
    refs = reference_images(cfg, traffic, seed, device, sample, images)
    got = [torch.from_numpy(decode_png(req["body"]).copy()).to(device).float() / 255.0 for req in sample]
    if keep is not None:
        keep.update({"checked": sample, "images": images, "reference_images": refs})
    return compare_images(got, refs, limits)


def compare_images(got: List[torch.Tensor], refs: List[torch.Tensor], limits: dict) -> List[harness.Check]:
    """The RMS and the largest gap of every pixel and channel, in [0, 1]."""
    if any(g.shape != r.shape for g, r in zip(got, refs)):
        return [harness.Check("answer_shape", float("inf"), 0.0)]
    d = torch.cat([(g - r).flatten() for g, r in zip(got, refs)])
    rms = float(torch.sqrt(torch.mean(d * d)))
    worst = float(d.abs().max())
    return [harness.Check("image_rms", rms, limits["image_rms"]),
            harness.Check("image_max", worst, limits["image_max"])]
