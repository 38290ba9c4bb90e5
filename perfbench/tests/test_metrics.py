"""The trace reduction and the per-layer readers on a synthetic trace."""
import math

import pytest

from perfbench import harness
from perfbench.yardstick import readers, work

KIND = "NVIDIA H100 80GB HBM3"


def _events():
    us = 1e6
    ev = [{"ph": "X", "name": harness.WINDOW_SPAN, "cat": "user_annotation", "ts": 1000.0, "dur": 1.0 * us}]
    kernels = [("flash_fwd_wgmma_kernel<128>", 0.0, 0.2), ("nvjet_tst_192x192", 0.1, 0.3),
               ("void conv_sm90_kernel<3>(x)", 0.5, 0.1), ("elementwise_kernel<add>", 0.7, 0.1),
               ("flash_dq_kernel", 0.85, 0.05), ("flash_dkv_kernel", 0.9, 0.05),
               ("outside", 1.5, 0.2)]
    for name, s, d in kernels:
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": 1000.0 + s * us, "dur": d * us})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1000.0 + 0.6 * us, "dur": 0.1 * us})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1000.0 + 0.62 * us, "dur": 0.05 * us})
    return ev


def _run(**counters):
    rec = harness.RunRecord(cell={}, config={}, traffic={}, seconds=1.0, trace_on=True, device_kind=KIND)
    rec.trace = harness.trace_from_chrome(_events())
    rec.counters.update(counters)
    return rec


def test_trace_window_and_busy():
    t = harness.trace_from_chrome(_events())
    assert t.window_s == pytest.approx(1.0)
    assert len(t.kernels) == 6                      # the one after the window is dropped
    assert t.busy_s() == pytest.approx(0.4 + 0.1 + 0.1 + 0.1)
    assert readers.device_idle_pct(_run()) == pytest.approx(30.0)


def test_idle_gaps_name_the_host_op():
    t = harness.trace_from_chrome(_events())
    gaps = t.idle_gaps()
    assert gaps[0] == ["host idle", pytest.approx(0.1)] or gaps[0][1] == pytest.approx(0.1)
    named = {n for n, _ in gaps}
    assert "aten::copy_" in named                   # the gap 0.6-0.7 at its middle 0.65
    assert sum(s for _, s in gaps) == pytest.approx(0.3)
    assert t.device_ops()[0] == ["nvjet_tst_192x192", pytest.approx(0.3)]


def test_kernel_classes():
    secs = work.class_seconds(harness.trace_from_chrome(_events()).kernels)
    assert secs["k3_attention"] == pytest.approx(0.2)
    assert secs["cublas_gemm"] == pytest.approx(0.3)
    assert secs["k1_resnet_conv"] == pytest.approx(0.1)
    assert secs[work.ELEMENTWISE] == pytest.approx(0.1)
    assert secs["k4_attention_dq"] == pytest.approx(0.05) and secs["k5_attention_dkv"] == pytest.approx(0.05)


def test_roofline_and_mfu_arithmetic():
    ops, nbytes = work.attention_fwd(1, 24, 2560, 128)
    assert ops == 4 * 24 * 2560 * 2560 * 128
    least = max(ops / 989e12, nbytes / 3.35e12)
    got = readers.roofline_pct(_run(), [(3, (ops, nbytes))], ("k3_attention",))
    assert got == pytest.approx(100 * 3 * least / 0.2)
    assert readers.roofline_pct(_run(), [(1, (ops, nbytes))], ("k8_wino_conv",)) is None
    run = _run()
    run.device_kind = "some other card"
    assert readers.roofline_pct(run, [(1, (ops, nbytes))], ("k3_attention",)) is None


@pytest.mark.parametrize("name, counters, expect", [
    ("device_idle_pct.serve", {}, 30.0),
    ("requests_per_batch.serve", {"served": 16, "server_batches": 4}, 4.0),
    ("daemon_ms.serve", {"client_latency_mean_ms": 120.0, "server_latency_mean_ms": 100.0}, 20.0),
    ("mfu.vae_train", {"traced_steps": 2, "images_per_step": 5, "flops_per_image": 9.89e12}, 10.0),
    ("mfu.lora", {"traced_steps": 1, "pairs_per_step": 2, "flops_per_pair": 98.9e12}, 20.0),
    ("elementwise_ms.vae_train", {"traced_steps": 2}, 50.0),
    ("loader_wait_ms.lora", {"loader_wait_ms": 3.5}, 3.5),
])
def test_readers(name, counters, expect):
    assert harness.metric_reader(name)(_run(**counters)) == pytest.approx(expect)


def test_readers_find_nothing_without_a_trace():
    run = _run()
    run.trace = None
    for name in ("device_idle_pct.serve", "k3_roofline.serve", "k1_roofline.vae_train", "attn_bwd_roofline.lora",
                 "elementwise_ms.vae_train"):
        assert harness.metric_reader(name)(run) is None


def test_serve_mfu_reader():
    from perfbench.yardstick import flops as FL
    cfg = {"transformer": {"num_layers": 1, "num_single_layers": 1, "num_attention_heads": 2, "attention_head_dim": 8,
                           "in_channels": 4, "joint_attention_dim": 8, "pooled_projection_dim": 4,
                           "guidance_embeds": True, "out_channels": None}}
    run = _run(traced_forward_rows=3, img_seq=32, txt_seq=4)
    run.config = cfg
    per_row = FL.flux_transformer_flops(FL.as_config(cfg["transformer"]), 32, 4)
    assert harness.metric_reader("mfu.serve")(run) == pytest.approx(100 * 3 * per_row / 1.0 / 989e12)


def test_attention_backward_roofline_reader():
    cfg = {"transformer": {"num_layers": 1, "num_single_layers": 0, "num_attention_heads": 24,
                           "attention_head_dim": 128}}
    run = _run(traced_steps=1, pairs_per_step=1, img_seq=2048, txt_seq=512)
    run.config = cfg
    ops, nbytes = work.attention_bwd(1, 24, 2560, 128)
    assert harness.metric_reader("attn_bwd_roofline.lora")(run) == pytest.approx(
        100 * max(ops / 989e12, nbytes / 3.35e12) / 0.1)


def test_result_line_leaves_out_silent_metrics():
    run = _run(served=0)
    run.checks = [harness.Check("image_rms", 0.01, 0.02)]
    line = harness.result_line(run, [{"name": "requests_per_batch.serve", "unit": "requests"},
                                     {"name": "device_idle_pct.serve", "unit": "%"}])
    assert list(line["metrics"]) == ["device_idle_pct.serve"]
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert line["device"]["busy_s"] == pytest.approx(0.7) and line["device"]["window_s"] == pytest.approx(1.0)
    assert len(line["breakdown"]["device_ops"]) <= 10 and len(line["breakdown"]["idle_gaps"]) <= 10


def test_percentile_and_spread():
    assert harness.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 90) == pytest.approx(9.1)
    assert math.isclose(harness.quartile_spread([1.0, 1.0, 1.0, 1.0]), 0.0)
