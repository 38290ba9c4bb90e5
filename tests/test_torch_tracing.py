"""The port's spans and counters (`ragb_vae_tpu_torch/utils/profiling.py`) on the CPU.

A span enters no `record_function` while no profiler runs, lands in the
exported Chrome trace as a `user_annotation` nested as the layers nest
(the batcher's batch, its phases and steps, the daemon's handler joined to
it by the request's identifier; the LoRA step's phases; the feed), and
survives a profiler that starts or stops while it is open. `cuda_prefetch`
closes every span before it yields. On the tiny model the batcher's
counters add up to the server's latency, the warm-up counts nothing and
`stats` answers as before; `/metrics` serves `counters()`.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_tracing.py -q
"""
import gc
import io
import json
import threading
import urllib.request
import weakref
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from ragb_vae_tpu_torch import serving_daemon
from ragb_vae_tpu_torch.data.loader import DataLoader, cuda_prefetch
from ragb_vae_tpu_torch.data.text_alpha_dataset import TextAlphaBucketDataset
from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel
from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig
from ragb_vae_tpu_torch.models.flux_weights import lora_parameters
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
from ragb_vae_tpu_torch.serving import InferenceServer, ServeConfig
from ragb_vae_tpu_torch.training import flux_kontext_textalpha_lora as tstage
from ragb_vae_tpu_torch.utils import profiling
from tests.data_fixtures import make_text_alpha_tree

TIMEOUT_S = 60
STATS_KEYS = {"served", "pending", "batches", "latency_avg_ms", "latency_max_ms"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny_model():
    vae = AutoencoderConfig.tiny()
    vae.in_channels = vae.out_channels = 4
    return FluxTextAlphaModel.random(FluxTransformerConfig.tiny(), vae, seed=0, device="cpu", prompt_len=4,
                                     lora_rank=4, lora_alpha=8.0)


class _CountingRecord:
    """Stands in for `record_function`: counts entries, and the spans open
    on each thread (`depth()`: on the calling one)."""
    entered, names, open = 0, [], {}
    lock = threading.Lock()

    def __init__(self, name):
        with self.lock:
            type(self).entered += 1
            type(self).names.append(name)

    def __enter__(self):
        with self.lock:
            self.open[threading.get_ident()] = self.depth() + 1

    def __exit__(self, *exc):
        with self.lock:
            self.open[threading.get_ident()] = self.depth() - 1

    @classmethod
    def depth(cls):
        return cls.open.get(threading.get_ident(), 0)


@pytest.fixture
def counting(monkeypatch):
    """A fake `record_function`, with the profiler's flag forced on or left off."""
    rec = type("Rec", (_CountingRecord,), {"entered": 0, "names": [], "open": {}})
    monkeypatch.setattr(torch.profiler, "record_function", rec)

    def force_on():
        monkeypatch.setattr(profiling, "profiler_running", lambda: True)
    rec.force_on = staticmethod(force_on)
    return rec


def _trace(run, path):
    """Run `run()` under a CPU profiler that records every thread; ->
    [(name, tid, start, end)] of its user annotations, in microseconds."""
    with profile(activities=[ProfilerActivity.CPU], experimental_config=profiling._all_threads()) as prof:
        run()
    events = []
    prof.export_chrome_trace(str(path))
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            events.append((e["name"], e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return events


def _png(array_u8):
    buf = io.BytesIO()
    Image.fromarray(array_u8, "RGBA").save(buf, format="PNG")
    return buf.getvalue()


def _within(child, parents):
    """The parent span of `child` among `parents` (same thread, enclosing)."""
    found = [p for p in parents if p[1] == child[1] and p[2] <= child[2] and child[3] <= p[3]]
    assert found, f"{child[0]} lies in none of {[p[0] for p in parents]}"
    return found[0]


def _kind(events, kind):
    return [e for e in events if e[0].split("#")[0] == kind]


def test_a_span_without_a_profiler_enters_no_record_function(counting):
    assert profiling.profiler_running() is False
    for i in range(3):
        with profiling.annotate("serve.step", step=i):
            pass
    assert counting.entered == 0
    counting.force_on()
    with profiling.annotate("serve.step", step=7), profiling.annotate("serve.batch", batch=2):
        assert counting.depth() == 2
    assert counting.names == ["serve.step#7", "serve.batch#2"] and counting.depth() == 0


def test_the_gate_reads_the_profilers_flag():
    assert profiling.profiler_running() is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.profiler_running() is True
    assert profiling.profiler_running() is False


def test_a_span_across_the_profilers_start_or_stop_neither_raises_nor_leaks(tmp_path):
    before = profiling.annotate("opened.before")
    before.__enter__()
    held = []

    def run():
        with profiling.annotate("whole", step=1):
            pass
        before.__exit__(None, None, None)     # opened before the start
        span = profiling.annotate("open.at.stop")
        span.__enter__()
        held.append(span)

    events = _trace(run, tmp_path / "t.json")
    held[0].__exit__(None, None, None)        # closed after the stop
    assert held[0]._record is None and before._record is None
    names = [e[0] for e in events]
    assert "whole#1" in names and "opened.before" not in names
    again = _trace(lambda: profiling.annotate("next").__enter__().__exit__(None, None, None), tmp_path / "u.json")
    names = [e[0] for e in again]              # nothing of the earlier profiles
    assert "next" in names and not {"whole#1", "open.at.stop", "opened.before"} & set(names)


def test_serving_spans_nest_and_join_the_handler_to_its_batch(tiny_model, tmp_path):
    image = np.random.default_rng(2).integers(0, 256, (64, 48, 4), dtype=np.uint8)
    server = InferenceServer(tiny_model, ServeConfig(max_batch=1, steps=2, auto_batch=False)).start()
    httpd = serving_daemon.make_httpd(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.02}, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/predict?seed=3"
    try:
        events = _trace(lambda: urllib.request.urlopen(
            urllib.request.Request(url, data=_png(image), method="POST"), timeout=TIMEOUT_S).read(),
            tmp_path / "t.json")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=TIMEOUT_S)
        assert server.drain(timeout=TIMEOUT_S)
    assert not thread.is_alive()
    (batch,) = _kind(events, "serve.batch")
    for kind in ("serve.noise", "serve.encode", "serve.sample", "serve.decode", "serve.readback", "serve.answer"):
        (span,) = _kind(events, kind)
        assert _within(span, [batch]) is batch
    (sample,) = _kind(events, "serve.sample")
    steps = _kind(events, "serve.step")
    assert sorted(s[0] for s in steps) == ["serve.step#0", "serve.step#1"]
    assert all(_within(s, [sample]) for s in steps)
    (answer,) = _kind(events, "serve.answer")
    rid = answer[0].split("#")[1]
    handler = [e for e in events if e[0].split("#")[0] in ("http.decode", "http.wait", "http.encode")]
    assert sorted(e[0] for e in handler) == [f"http.decode#{rid}", f"http.encode#{rid}", f"http.wait#{rid}"]
    (wait,) = _kind(events, "http.wait")
    assert wait[1] != batch[1] and wait[2] <= batch[2] and answer[2] <= wait[3]


def test_lora_step_and_feed_spans_nest(tiny_model, tmp_path):
    make_text_alpha_tree(tmp_path / "data", n=2)
    ds = TextAlphaBucketDataset(tmp_path / "data", split="train")
    loader = DataLoader(ds, batch_size=2, num_workers=2)
    params = list(lora_parameters(tiny_model.transformer).values())
    step = tstage.make_lora_train_step(tiny_model, tstage.make_lora_optimizer(params, 1e-3), 1)
    gen = torch.Generator().manual_seed(0)

    def run():
        for i, batch in enumerate(cuda_prefetch(tstage._padded_batches(loader, 1), "cpu")):
            step(batch, gen, i)

    events = _trace(run, tmp_path / "t.json")
    (lora,) = _kind(events, "lora.step")
    assert lora[0] == "lora.step#0"
    for kind in ("lora.encode", "lora.forward", "lora.backward", "lora.optimizer"):
        (span,) = _kind(events, kind)
        assert _within(span, [lora]) is lora
    assert not _kind(events, "lora.grad_sum")     # one process: nothing to sum
    nexts = _kind(events, "data.next")
    assert len(nexts) == 2                          # the batch, then the end of the stream
    for kind in ("data.wait", "data.pad"):
        assert all(_within(s, nexts) for s in _kind(events, kind)), kind
    (fetch,) = _kind(events, "data.fetch")
    assert fetch[1] not in {n[1] for n in nexts}    # on the loader's thread
    assert not any(lora[2] < n[3] and n[2] < lora[3] for n in nexts)


def test_cuda_prefetch_closes_every_span_before_it_yields(counting, tmp_path):
    counting.force_on()
    make_text_alpha_tree(tmp_path / "data", n=4)
    ds = TextAlphaBucketDataset(tmp_path / "data", split="train")
    loader = DataLoader(ds, batch_size=1, num_workers=0)
    counter = profiling.Counter("data.next")
    seen = 0
    for batch in cuda_prefetch(tstage._padded_batches(loader, 1), "cpu", counter=counter):
        assert counting.depth() == 0 and isinstance(batch["gt"], torch.Tensor)
        seen += 1
    assert seen == 4 and counter.count == 4 and counter.total > 0
    assert {"data.next", "data.wait", "data.pad", "data.fetch"} <= set(counting.names)
    assert counting.names.count("data.next") == 5
    assert profiling.counters()["data.next"]["count"] == 4


def test_batcher_counters_add_up_to_the_servers_latency(tiny_model):
    server = InferenceServer(tiny_model, ServeConfig(max_batch=2, steps=1, auto_batch=False))
    server.warmup([(64, 48)])
    assert server.stats == {"served": 0, "pending": 0, "batches": 0}
    assert profiling.counters()["serve.queue_wait"]["count"] == 0          # the warm-up counts nothing
    images = np.random.default_rng(5).uniform(size=(3, 64, 48, 4)).astype(np.float32)
    with server:
        futures = [server.submit(im, seed=i) for i, im in enumerate(images)]
        for f in futures:
            assert f.result(timeout=TIMEOUT_S).shape == (64, 48, 4)
    c = profiling.counters()
    stats = server.stats
    assert set(stats) == STATS_KEYS
    assert stats["served"] == 3 and stats["pending"] == 0 and stats["batches"] == c["serve.rows"]["count"]
    assert c["serve.rows"]["total"] == 3 and c["serve.rows"]["total"] + c["serve.pad_rows"]["total"] == \
        2 * stats["batches"]
    assert c["serve.queue_wait"]["count"] == c["serve.service"]["count"] == 3
    lat = c["serve.latency"]
    assert c["serve.queue_wait"]["total"] + c["serve.service"]["total"] == pytest.approx(lat["total"], rel=1e-9)
    assert stats["latency_avg_ms"] == round(1000.0 * lat["total"] / 3, 1)
    assert stats["latency_max_ms"] == round(1000.0 * lat["max"], 1)
    # the registry keeps the counters, not the server
    ref = weakref.ref(server)
    del server
    gc.collect()
    assert ref() is None and profiling.counters()["serve.latency"]["count"] == 3


def test_metrics_endpoint_serves_the_counters():
    stub = SimpleNamespace(config=SimpleNamespace(request_timeout_s=TIMEOUT_S),
                           stats={"served": 0, "pending": 0, "batches": 0})

    def submit(image, *, seed=None):
        fut = Future()
        fut.set_result(image)
        return fut
    stub.submit = submit
    httpd = serving_daemon.make_httpd(stub, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.02}, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for _ in range(2):
            urllib.request.urlopen(urllib.request.Request(f"{base}/predict", data=_png(np.zeros((8, 8, 4), np.uint8)),
                                                          method="POST"), timeout=TIMEOUT_S).read()
        with urllib.request.urlopen(f"{base}/metrics", timeout=TIMEOUT_S) as resp:
            assert resp.headers["Content-Type"] == "application/json"
            got = json.loads(resp.read())
        with urllib.request.urlopen(f"{base}/healthz", timeout=TIMEOUT_S) as resp:
            assert json.loads(resp.read()) == {"status": "ok", **stub.stats}
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=TIMEOUT_S)
    assert not thread.is_alive()
    assert got == profiling.counters()
    assert got["http.png"]["count"] == 2 and 0 < got["http.png"]["max"] <= got["http.png"]["total"]


def test_request_scope_gives_submit_its_identifier():
    with profiling.request_scope() as rid:
        assert profiling.request_id() == rid
    other = profiling.request_id()
    assert other > rid and profiling.request_id() > other
