"""Tiny configurations of the benchmark's cells, for the CPU tests: the same
files and drivers, at widths a test process holds, in fp32."""
from __future__ import annotations

import copy
import json
import time

import torch

from perfbench import harness

TINY_FLUX = dict(in_channels=16, num_layers=2, num_single_layers=2, attention_head_dim=32, num_attention_heads=2,
                 joint_attention_dim=32, pooled_projection_dim=16, axes_dims_rope=[8, 12, 12])
TINY_VAE = dict(block_out_channels=[32, 64], layers_per_block=1, latent_channels=4, norm_num_groups=4,
                sample_size=64, scaling_factor=1.0, shift_factor=0.0)
TRAFFIC = {
    "serve-512-bf16": dict(height=64, width=64, steps=3, dtype="fp32", clients=3, requests_per_client=3,
                           max_batch=2, distinct_images=4, max_delay_ms=50.0, check_requests=2),
    "vae-stage1-512": dict(height=32, width=32, pool_pairs=6, batch_size=2, trace_step=1, trace_steps=1),
    "lora-512-b8": dict(height=32, width=32, pool_pairs=6, batch_size=4, trace_step=1, trace_steps=1),
}


# A cell whose files stay under perfbench/ while BENCHMARK.json leaves it out
# (its fp8 control passes its checks: PERF.md, open questions).
UNLISTED = {"vae-stage1-512": {"name": "vae-stage1-512", "config": "flux-ae-rgba", "traffic": "vae-stage1-512",
                               "chips": 1}}


def cell(name: str):
    """(cell, config, traffic) of a cell of BENCHMARK.json, or of an unlisted
    one, cut to tiny sizes."""
    manifest = harness.load_manifest()
    if name in UNLISTED:
        c = UNLISTED[name]
        cfg = json.loads((harness.HERE / "configs" / f"{c['config']}.json").read_text())
    else:
        c = harness.cell_of(manifest, name)
        cfg = copy.deepcopy(harness.config_of(manifest, c))
    traffic = copy.deepcopy(harness.traffic_of(c))
    if "transformer" in cfg:
        cfg["transformer"].update(TINY_FLUX)
        cfg["prompt_len"] = 4
        cfg["lora"].update(rank=4, lora_alpha=6)
    cfg["vae"].update(TINY_VAE)
    traffic.update(TRAFFIC[name])
    return c, cfg, traffic


def run(name: str, seed: int = 2**33 + 5, seconds: float = 1.5, **counters) -> harness.RunRecord:
    """One run of a tiny cell on the CPU, past the harness's look for a card."""
    c, cfg, traffic = cell(name)
    record = harness.RunRecord(cell=c, config=cfg, traffic=traffic, seconds=seconds, trace_on=False)
    record.counters.update(process_start=time.time(), **counters)
    harness.driver(traffic["driver"]).run(record, seed=seed, device=torch.device("cpu"))
    return record
