"""The port's serving daemon and console entry points on the CPU.

The daemon's HTTP handler against the JAX package's over one stub server
(the same PNG bytes, statuses and JSON keys), one loopback round trip through
`make_httpd` on the tiny random model (the answer equals `InferenceServer.submit`
of the same uint8-quantised image and seed, bit for bit), its flags against
the JAX daemon's, `--pp 2` on the CPU against `--pp 1`, and what raises:
`--tp` above 1 without torchrun, `--pp` above the cards there are, and
`--device cuda` without a card. The daemon's `main` is never called here: it installs a
SIGTERM handler and serves forever.
"""
import io
import json
import sys
import threading
import urllib.error
import urllib.request
from concurrent.futures import Future
from contextlib import contextmanager
from http.server import ThreadingHTTPServer
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from ragb_vae_tpu import serving_daemon as jdaemon
from ragb_vae_tpu_torch import _cli, inference, serving_daemon
from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel
from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
from ragb_vae_tpu_torch.serving import InferenceServer, ServeConfig

ROOT = Path(__file__).resolve().parent.parent
REQUIRED = ["--pretrained_model_name_or_path", "ckpt", "--rgba_vae_path", "vae"]
TIMEOUT_S = 60


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny model's ops are too small to split across threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@contextmanager
def _serving(httpd: ThreadingHTTPServer):
    """Serve `httpd` on a thread; yield its base URL; shut it down and close it."""
    # a short poll: shutdown() waits for the loop's next poll
    thread = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.02}, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=TIMEOUT_S)
    assert not thread.is_alive()


def _request(url, data=None):
    """-> (status, content type, body) of a GET (no data) or POST."""
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers["Content-Type"], err.read()


def _png(array_u8):
    buf = io.BytesIO()
    Image.fromarray(array_u8, "RGBA").save(buf, format="PNG")
    return buf.getvalue()


class _StubServer:
    """Answers every request with the same array (values outside [0, 1]
    included, so the clip is exercised) and records what it was given."""

    def __init__(self):
        self.answer = np.random.default_rng(0).uniform(-0.2, 1.2, size=(24, 40, 4)).astype(np.float32)
        self.config = SimpleNamespace(request_timeout_s=TIMEOUT_S)
        self.stats = {"served": 5, "pending": 0, "batches": 3, "latency_avg_ms": 1.5, "latency_max_ms": 2.0}
        self.seen = []

    def submit(self, image, *, seed=None):
        self.seen.append((image, seed))
        fut = Future()
        fut.set_result(self.answer)
        return fut


def _exchange(base):
    body = _png(np.random.default_rng(1).integers(0, 256, (24, 40, 4), dtype=np.uint8))
    return {
        "predict": _request(f"{base}/predict?seed=9", body),
        "predict-unseeded": _request(f"{base}/predict", body),
        "healthz": _request(f"{base}/healthz"),
        "get-unknown": _request(f"{base}/nope"),
        "post-unknown": _request(f"{base}/nope", body),
        "bad-body": _request(f"{base}/predict", b"not a png"),
    }


def test_handler_matches_the_jax_daemon():
    jstub, tstub = _StubServer(), _StubServer()
    with _serving(ThreadingHTTPServer(("127.0.0.1", 0), jdaemon.make_handler(jstub))) as base:
        want = _exchange(base)
    with _serving(serving_daemon.make_httpd(tstub, "127.0.0.1", 0)) as base:
        got = _exchange(base)
    for name in ("predict", "predict-unseeded"):
        assert got[name][:2] == want[name][:2] == (200, "image/png"), name
        assert got[name][2] == want[name][2], f"{name}: PNG bytes differ"
    for name in ("healthz", "get-unknown", "post-unknown", "bad-body"):
        assert got[name][:2] == want[name][:2], name
        assert got[name][1] == "application/json"
        assert json.loads(got[name][2]).keys() == json.loads(want[name][2]).keys(), name
    assert [got[k][0] for k in ("healthz", "get-unknown", "post-unknown", "bad-body")] == [200, 404, 404, 500]
    assert json.loads(got["healthz"][2]) == {"status": "ok", **tstub.stats}
    assert json.loads(got["bad-body"][2])["error"].startswith("UnidentifiedImageError")
    # both handlers gave their servers the same image and seed
    assert [s for _, s in tstub.seen] == [s for _, s in jstub.seen] == [9, None]
    for (a, _), (b, _) in zip(tstub.seen, jstub.seen):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def tiny_model():
    vae = AutoencoderConfig.tiny()
    vae.in_channels = vae.out_channels = 4
    return FluxTextAlphaModel.random(FluxTransformerConfig.tiny(), vae, seed=0, device="cpu", fused=True,
                                     prompt_len=4)


def test_loopback_round_trip_equals_submit(tiny_model):
    image = np.random.default_rng(2).integers(0, 256, (64, 48, 4), dtype=np.uint8)
    server = InferenceServer(tiny_model, ServeConfig(max_batch=1, steps=2, auto_batch=False)).start()
    try:
        with _serving(serving_daemon.make_httpd(server, "127.0.0.1", 0)) as base:
            before = json.loads(_request(f"{base}/healthz")[2])
            status, ctype, body = _request(f"{base}/predict?seed=7", _png(image))
            after = json.loads(_request(f"{base}/healthz")[2])
        assert (status, ctype) == (200, "image/png"), body[:200]
        got = Image.open(io.BytesIO(body))
        assert got.mode == "RGBA" and got.size == (48, 64)
        pred = server.submit(image.astype(np.float32) / 255.0, seed=7).result(timeout=TIMEOUT_S)
        want = (np.clip(pred, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        np.testing.assert_array_equal(np.asarray(got), want)
        assert (before["served"], after["served"]) == (0, 1) and after["status"] == "ok"
    finally:
        assert server.drain(timeout=TIMEOUT_S)


def test_flags_and_defaults_match_the_jax_daemon():
    got = vars(serving_daemon.parse_args(REQUIRED))
    assert got.pop("device") == "cuda"
    assert got == vars(jdaemon.parse_args(REQUIRED))


@pytest.mark.parametrize("flag", ["--tp", "--pp"])
def test_parallel_serving_is_not_ported(flag, tmp_path, monkeypatch):
    """Both are ported. --tp without torchrun's process group of that size
    exits naming torchrun. --pp 2 on the CPU serves through a 2-stage
    pipeline, the same answer as --pp 1 bit for bit; on the card with fewer
    cards than stages it exits naming the count."""
    if flag == "--tp":
        args = serving_daemon.parse_args(REQUIRED + [flag, "2", "--device", "cpu"])
        with pytest.raises(SystemExit, match="torchrun"):
            serving_daemon.build_server(args)
        return
    from tests.test_torch_serving import _write_jax_checkpoint

    _write_jax_checkpoint(tmp_path)
    paths = ["--pretrained_model_name_or_path", str(tmp_path / "flux"), "--rgba_vae_path", str(tmp_path / "vae"),
             "--steps", "1", "--max-batch", "1", "--no-auto-batch", "--precision", "fp32"]
    image = np.random.default_rng(3).uniform(size=(64, 48, 4)).astype(np.float32)
    answers = []
    for pp in ("2", "1"):
        server = serving_daemon.build_server(serving_daemon.parse_args(paths + [flag, pp, "--device", "cpu"]))
        assert (pp == "1" and server.pipeline is None) or len(server.pipeline.stages) == 2
        with server:
            answers.append(server.submit(image, seed=4).result(timeout=TIMEOUT_S))
    assert answers[0].shape == image.shape
    np.testing.assert_array_equal(answers[0], answers[1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--pp 2 needs 2 devices, found 1"):
        serving_daemon.build_server(serving_daemon.parse_args(paths + [flag, "2"]))


def test_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serving_daemon.build_server(serving_daemon.parse_args(REQUIRED))
    with pytest.raises(RuntimeError, match="is_available"):
        _cli.infer_main(REQUIRED + ["--input_image", "in.png", "--output_path", "out.png"])
    with pytest.raises(RuntimeError, match="is_available"):
        _cli.train_main(["--config", "missing.yaml"])


def test_console_and_script_entry_points_reach_the_daemon(monkeypatch):
    seen = []
    monkeypatch.setattr(serving_daemon, "main", seen.append)
    _cli.serve_main(["--port", "0"])
    assert seen == [["--port", "0"]]
    monkeypatch.undo()
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import serve_torch
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    for name in ("build_server", "main", "make_handler", "make_httpd", "parse_args"):
        assert getattr(serve_torch, name) is getattr(serving_daemon, name)
    import inference_rgba_flux_torch

    assert inference_rgba_flux_torch.main is inference.main
