"""Where the port's device time goes, function by function: each kernel of a
profiled stretch charged to the aten op that launched it and to the
function of the port's model code that called that op.

    python3 scripts/attribute_elementwise.py [--what serve,lora] [--out chiprun_out/attribute.json]

`serve`: two sampler steps of a batch of 4 at 512x512 (2,048 image and 512
text tokens, the serve cell's shape) through the full-width FLUX.1-Kontext
transformer in bf16 with random weights. `lora`: one step of rank-128
adapters on that frozen bf16 base, 8 pairs at 512x512 in one micro-batch,
per-block recompute (the LoRA cell's shape). Each is profiled once after
one untraced call.

The functions of `SPANS` (those that exist in the checkout) are wrapped for
the run in a `record_function` span of their name. A kernel is charged to
the innermost host op that launched it (past CUDA runtime events) and that
op to the innermost span above it; a backward op, which runs on autograd's
thread, to the span of the forward op of the same autograd sequence number,
marked `bwd`. Kernels fall in classes by name (GEMM, K3-K5, the attention
prologue K13, everything else "elementwise"); the prologue chain is the
plain code K13 replaces: `RMSNorm`, `apply_rotary_emb`, `_split_heads`, the
`torch.cat` of the streams in `JointAttention` and the `.contiguous()` in
K3's wrapper.

Prints the device time by class, the chain's share of the elementwise time
and the largest elementwise rows, and writes every row to `--out`.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ragb_vae_tpu_torch.models import flux_transformer as FT  # noqa: E402
from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel  # noqa: E402
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig  # noqa: E402
from ragb_vae_tpu_torch.ops.kernels import flash_attention as FA  # noqa: E402

SEED = 0
BATCH, SIZE, STEPS = 4, 512, 2
LORA_BATCH, LORA_RANK, LORA_ALPHA, LORA_LR = 8, 128, 192.0, 3e-5

KERNEL_CLASSES = [
    ("attn prologue (K13)", re.compile(r"attn_prologue", re.I)),
    ("attention fwd (K3)", re.compile(r"flash_fwd|flash_merge", re.I)),
    ("attention bwd (K4, K5)", re.compile(r"flash_dq|flash_dkv", re.I)),
    ("GEMM", re.compile(r"gemm|gemv|xmma|cutlass|nvjet|cublas", re.I)),
    ("elementwise", re.compile(r".")),
]


def kernel_class(name: str) -> str:
    return next(label for label, pattern in KERNEL_CLASSES if pattern.search(name))


# (owner, attribute) of each function wrapped in a span; missing ones are skipped
SPANS = [
    (FT.RMSNorm, "forward"), (FT, "apply_rotary_emb"), (FT, "_split_heads"), (FT, "_merge_heads"),
    (FT, "_layer_norm"), (FT.JointAttention, "forward"), (FT.SingleAttention, "forward"),
    (FT.AdaLayerNormZero, "forward"), (FT._GeluProj, "forward"), (FT.FeedForward, "forward"),
    (FT.LoraDense, "forward"), (FT.FluxTransformerBlock, "forward"), (FT.FluxSingleTransformerBlock, "forward"),
    (FT.AdaLayerNormContinuous, "forward"), (FA, "flash_attention_cuda"), (FA, "flash_attention_bwd_cuda"),
    (FT, "attn_prologue"), (FT, "merge_heads"),
]
CHAIN = {"RMSNorm.forward", "apply_rotary_emb", "_split_heads", "flash_attention_cuda"}
CHAIN_CAT = {"JointAttention.forward"}
SPAN_PREFIX = "src:"


def _spanned(name, fn):
    from torch.profiler import record_function

    def wrapped(*args, **kwargs):
        with record_function(SPAN_PREFIX + name):
            return fn(*args, **kwargs)
    return wrapped


def wrap_spans():
    """Wrap each function of `SPANS` that exists in a span of its name."""
    for owner, attr in SPANS:
        fn = getattr(owner, attr, None)
        if fn is not None:
            name = attr if isinstance(owner, type(FT)) else f"{owner.__name__}.{attr}"
            setattr(owner, attr, _spanned(name, fn))


RUNTIME = re.compile(r"^(cuda[A-Z]|cu[A-Z]|Command Buffer|Activity Buffer)")


def port_function(node):
    """The name of the innermost span of `SPANS` above `node`, or None."""
    while node is not None:
        if node.name.startswith(SPAN_PREFIX):
            return node.name[len(SPAN_PREFIX):]
        node = node.cpu_parent
    return None


def attribute(events):
    """[(class, aten op, source, ms, launches)] for every kernel of the
    profiled stretch, each counted once (by its correlation to the host event
    that launched it)."""
    from torch.autograd import DeviceType

    host = {e.id: e for e in events if e.device_type == DeviceType.CPU}
    fwd_src = {}
    for e in host.values():
        if e.sequence_nr >= 0 and "Backward" not in e.name and not e.name.startswith("autograd::"):
            src = port_function(e)
            if src:
                fwd_src[e.sequence_nr] = (src, e.name)
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    if device and hasattr(device[0], "linked_correlation_id"):
        launches = [(host.get(k.linked_correlation_id), k.name, k.time_range.elapsed_us()) for k in device]
    else:   # a torch whose device events do not name their host event: the kernels each host event holds
        launches = [(e, k.name, k.duration) for e in host.values() for k in e.kernels]
    print(f"[attribute] {len(device)} device events, {sum(k.time_range.elapsed_us() for k in device) / 1e3} ms; "
          f"{len(launches)} attributed, {sum(us for _, _, us in launches) / 1e3} ms", flush=True)
    rows = defaultdict(lambda: [0.0, 0])
    for node, name, us in launches:
        while node is not None and RUNTIME.match(node.name):     # the op above a runtime call
            node = node.cpu_parent
        src, op = port_function(node), node.name if node is not None else "(no host op)"
        up = node
        while src is None and up is not None:
            if "Backward" in up.name and up.sequence_nr in fwd_src:
                fsrc, fop = fwd_src[up.sequence_nr]
                src, op = "bwd " + fsrc, f"{op} ({fop})"
            up = up.cpu_parent
        row = rows[(kernel_class(name), op, src or "(outside the spans)")]
        row[0] += us / 1e3
        row[1] += 1
    return sorted(([c, op, src, ms, n] for (c, op, src), (ms, n) in rows.items()), key=lambda r: -r[3])


def in_chain(op, src) -> bool:
    key = (src or "").removeprefix("bwd ")
    return key in CHAIN or (key in CHAIN_CAT and "aten::cat" in op)


def report(label, rows):
    by_class = defaultdict(float)
    for c, _, _, ms, _ in rows:
        by_class[c] += ms
    elem = [r for r in rows if r[0] == "elementwise"]
    elem_ms = sum(r[3] for r in elem)
    chain_ms = sum(r[3] for r in elem if in_chain(r[1], r[2]))
    print(f"[attribute] {label}: kernels {sum(by_class.values())} ms", flush=True)
    for c, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"[attribute] {label}   class {c}: {ms} ms", flush=True)
    print(f"[attribute] {label}: prologue chain {chain_ms} ms of elementwise {elem_ms} ms "
          f"({100.0 * chain_ms / elem_ms if elem_ms else float('nan')}%)", flush=True)
    for _, op, src, ms, n in elem[:50]:
        mark = "chain" if in_chain(op, src) else "     "
        print(f"[attribute] {label}   {mark} {ms:10.3f} ms {n:6d} launches  {src}  {op}", flush=True)
    return {"cell": label, "classes": dict(by_class), "elementwise_ms": elem_ms, "chain_ms": chain_ms,
            "rows": rows}


def profile(label, fn):
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    events = prof.events()
    if not any(e.device_type == DeviceType.CUDA for e in events):
        print(f"[attribute] {label}: the profiler recorded no device kernels: not measured", flush=True)
        return None
    return report(label, attribute(events))


def build_model(lora: bool):
    vae_cfg = AutoencoderConfig.flux()
    vae_cfg.in_channels = vae_cfg.out_channels = 4
    kw = {"lora_rank": LORA_RANK, "lora_alpha": LORA_ALPHA} if lora else {}
    t0 = time.perf_counter()
    model = FluxTextAlphaModel.random(FT.FluxTransformerConfig(), vae_cfg, seed=SEED, device="cuda",
                                      dtype=torch.bfloat16, fused=True, **kw)
    torch.cuda.synchronize()
    print(f"[build] model ready in {time.perf_counter() - t0} s", flush=True)
    return model


def serve_cell():
    model = build_model(lora=False)
    gen = torch.Generator("cuda").manual_seed(SEED)
    x = torch.rand((BATCH, SIZE, SIZE, 4), generator=gen, device="cuda")
    lat = (BATCH,) + model.latent_shape(SIZE, SIZE)
    with torch.inference_mode():
        cond = model.encode_latents(x, torch.randn(lat, generator=gen, device="cuda"))
        init = torch.randn(lat, generator=gen, device="cuda")
        noises = torch.randn((STEPS,) + lat, generator=gen, device="cuda")
        out = profile(f"serve b{BATCH} {SIZE}x{SIZE}, {STEPS} sampler steps",
                      lambda: model.sample_latents_from_noise(cond, init, noises))
    del model
    torch.cuda.empty_cache()
    return out


def lora_cell():
    from ragb_vae_tpu_torch.models.flux_weights import lora_parameters
    from ragb_vae_tpu_torch.training.flux_kontext_textalpha_lora import (
        cosine_decay_schedule, make_lora_optimizer, make_lora_train_step)

    model = build_model(lora=True)
    gen = torch.Generator("cuda").manual_seed(SEED)
    lora = lora_parameters(model.transformer)
    with torch.no_grad():
        for name, p in lora.items():      # B = 0 would leave A without a gradient
            if name.endswith("lora_B"):
                p.normal_(0.0, 0.01, generator=gen)
    optimizer = make_lora_optimizer(list(lora.values()), LORA_LR)
    step = make_lora_train_step(model, optimizer, 1, cosine_decay_schedule(LORA_LR, 100000))
    batch = {k: torch.rand((LORA_BATCH, SIZE, SIZE, 4), generator=gen, device="cuda") for k in ("gt", "text_alpha")}
    out = profile(f"lora b{LORA_BATCH} {SIZE}x{SIZE}, one step", lambda: step(batch, gen, 0))
    del model, optimizer, step
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", default="serve,lora", help="comma-separated subset of serve,lora")
    ap.add_argument("--out", default="chiprun_out/attribute.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attribute_elementwise.py needs a CUDA device")
    what = args.what.split(",")
    wrap_spans()
    result = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__}
    print(f"[attribute] {result['device']}, torch {result['torch']}", flush=True)
    if "serve" in what:
        result["serve"] = serve_cell()
    if "lora" in what:
        result["lora"] = lora_cell()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
