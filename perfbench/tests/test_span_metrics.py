"""The readers of the program's spans and counters, on a synthetic trace and
a synthetic registry, with the runs where they find nothing to read."""
import sys
import types

import pytest

from perfbench import harness
from ragb_vae_tpu_torch.utils import profiling

LORA = ("feed_ms.lora", "feed_idle_pct.lora", "model_idle_pct.lora")


def _run(host_ops, **counters):
    """A 1-s window with kernels over 0-0.2, 0.3-0.7 and 0.9-1.0 (idle 0.2-0.3, 0.7-0.9)."""
    rec = harness.RunRecord(cell={}, config={}, traffic={}, seconds=1.0, trace_on=True)
    rec.trace = harness.Trace(window_s=1.0, kernels=[("k", 0.0, 0.2), ("k", 0.3, 0.4), ("k", 0.9, 0.1)],
                              host_ops=sorted(host_ops, key=lambda h: (h[1], -h[2])))
    rec.counters.update(counters)
    return rec


HOST = [("data.next", 0.15, 0.2), ("data.wait", 0.16, 0.15), ("lora.step#0", 0.35, 0.6),
        ("lora.forward", 0.4, 0.5), ("data.fetch", 0.1, 0.8), ("data.next", 0.98, 0.1)]


@pytest.mark.parametrize("name, expect", [
    ("feed_ms.lora", 1000.0 * (0.2 + 0.02) / 2),    # the second span clipped to the window
    ("feed_idle_pct.lora", 10.0),                    # idle 0.2-0.3 under data.next
    ("model_idle_pct.lora", 20.0),                   # idle 0.7-0.9 under lora.step, its child not twice
])
def test_lora_readers_on_a_synthetic_trace(name, expect):
    run = _run(HOST, traced_steps=2)
    assert harness.metric_reader(name)(run) == pytest.approx(expect)
    assert harness.metric_reader("device_idle_pct.lora")(run) == pytest.approx(30.0)


@pytest.mark.parametrize("name", LORA)
def test_lora_readers_find_nothing(name):
    read = harness.metric_reader(name)
    no_trace = _run(HOST, traced_steps=2)
    no_trace.trace = None
    assert read(no_trace) is None
    assert read(_run([("aten::mm", 0.1, 0.1)], traced_steps=2)) is None     # a program without the spans
    if name == "feed_ms.lora":
        assert read(_run(HOST)) is None


@pytest.fixture
def registry(monkeypatch):
    monkeypatch.setattr(profiling, "_REGISTRY", {})
    return profiling


def test_png_reader_on_a_synthetic_registry(registry):
    read = harness.metric_reader("png_ms.serve")
    assert read(_run([])) is None                    # nothing registered
    c = registry.Counter("http.png")
    assert read(_run([])) is None                    # registered, nothing counted
    for seconds in (0.5, 1.5, 4.0):
        c.add(seconds)
    registry.Counter("serve.latency").add(99.0)      # another name
    assert read(_run([])) == pytest.approx(2000.0)
    registry.Counter("http.png").add(0.25)           # a newer owner of the name
    assert read(_run([])) == pytest.approx(250.0)


def test_png_reader_without_counters_in_the_program(monkeypatch):
    monkeypatch.setitem(sys.modules, "ragb_vae_tpu_torch.utils.profiling", types.ModuleType("profiling"))
    assert harness.metric_reader("png_ms.serve")(_run([])) is None
