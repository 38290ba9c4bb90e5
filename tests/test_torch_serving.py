"""The port's serving entry points on the CPU with the tiny model:
`InferenceServer` (batcher thread, buckets, per-request determinism) and
`inference.run` on a checkpoint directory written by the JAX package's savers.
"""
import numpy as np
import pytest
import torch

from ragb_vae_tpu_torch import inference
from ragb_vae_tpu_torch.models.flux_kontext_textalpha import FluxTextAlphaModel
from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig
from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
from ragb_vae_tpu_torch.serving import InferenceServer, ServeConfig, resize_rgba, snap_size

TIMEOUT_S = 60


def _vae_config():
    cfg = AutoencoderConfig.tiny()
    cfg.in_channels = cfg.out_channels = 4
    return cfg


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny model's ops are too small to split: with the suite's parallel
    workers, torch's intra-op threads only contend (a 1 s test took 20-30 s)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def model():
    return FluxTextAlphaModel.random(
        FluxTransformerConfig.tiny(), _vae_config(), seed=0, device="cpu", fused=True, prompt_len=4
    )


def _images(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=s).astype(np.float32) for s in ((64, 64, 4), (64, 64, 4), (80, 50, 4))]


def test_server_answers_three_requests(model):
    server = InferenceServer(model, ServeConfig(max_batch=2, steps=2, auto_batch=False))
    imgs = _images()
    with server:
        futures = [server.submit(img, seed=i) for i, img in enumerate(imgs)]
        outs = [f.result(timeout=TIMEOUT_S) for f in futures]
        assert server.drain(timeout=TIMEOUT_S)
    for img, out in zip(imgs, outs):
        assert out.shape == img.shape
        assert np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0
    stats = server.stats
    assert stats["served"] == 3 and stats["pending"] == 0 and stats["batches"] == 2


def test_same_seed_same_answer_whatever_the_batch(model):
    """An answer is a function of (image, seed): served alone or beside
    another request it is bit-identical; another seed changes it."""
    img, other = _images(1)[:2]
    server = InferenceServer(model, ServeConfig(max_batch=2, steps=2, max_delay_ms=5.0, auto_batch=False))
    with server:
        alone = server.submit(img, seed=11).result(timeout=TIMEOUT_S)
        pair = [server.submit(img, seed=11), server.submit(other, seed=12)]
        together = pair[0].result(timeout=TIMEOUT_S)
        pair[1].result(timeout=TIMEOUT_S)
        reseeded = server.submit(img, seed=13).result(timeout=TIMEOUT_S)
    np.testing.assert_array_equal(alone, together)
    assert not np.array_equal(alone, reseeded)


def test_batcher_thread_runs_in_inference_mode(model):
    seen = []
    server = InferenceServer(model, ServeConfig(max_batch=1, steps=1, auto_batch=False))
    real = server._run_batch

    def spy(images, seeds):
        seen.append(torch.is_inference_mode_enabled())
        return real(images, seeds)

    server._run_batch = spy
    with server:
        server.submit(_images()[0], seed=0).result(timeout=TIMEOUT_S)
    assert seen == [True]


def test_warmup_auto_batch_picks_a_batch(model):
    server = InferenceServer(model, ServeConfig(max_batch=2, steps=1, auto_batch=True))
    server.warmup([(64, 64)])
    assert server._bucket_batch[(64, 64)] in (1, 2)


def test_stopped_server_refuses_requests(model):
    server = InferenceServer(model, ServeConfig(steps=1, auto_batch=False)).start()
    server.stop()
    with pytest.raises(RuntimeError):
        server.submit(_images()[0])


def test_snap_and_resize():
    assert snap_size(600, 400) == (576, 384)
    assert snap_size(512, 512) == (512, 512)
    out = resize_rgba(np.random.default_rng(2).uniform(size=(10, 6, 4)).astype(np.float32), (20, 12))
    assert out.shape == (20, 12, 4) and out.min() >= 0.0 and out.max() <= 1.0


def _write_jax_checkpoint(root):
    """A tiny text-alpha checkpoint tree written by the JAX package's savers."""
    import jax.numpy as jnp

    from ragb_vae_tpu.models.flux_kontext_textalpha import save_empty_prompt_embeds
    from ragb_vae_tpu.models.flux_transformer import FluxTransformerConfig as JaxFluxConfig
    from ragb_vae_tpu.models.flux_weights import save_flux_transformer_params
    from ragb_vae_tpu.models.vae_config import AutoencoderConfig as JaxAutoencoderConfig
    from ragb_vae_tpu.models.weights import save_autoencoder_params
    from tests.test_torch_flux import random_flux_params
    from tests.test_torch_vae import _random_params as random_vae_params

    t_cfg = JaxFluxConfig.tiny()
    v_cfg = JaxAutoencoderConfig.tiny()
    v_cfg.in_channels = v_cfg.out_channels = 4
    save_flux_transformer_params(t_cfg, random_flux_params(t_cfg), root / "flux" / "transformer")
    save_autoencoder_params(v_cfg, random_vae_params(v_cfg), root / "vae" / "ae")
    rng = np.random.default_rng(0)
    save_empty_prompt_embeds(
        root / "flux", rng.standard_normal((1, 4, t_cfg.joint_attention_dim)),
        rng.standard_normal((1, t_cfg.pooled_projection_dim)), jnp.zeros((4, 3)),
    )


def test_inference_run_on_a_jax_written_checkpoint(tmp_path, capsys):
    """The JAX CLI's `--compilation_cache` (default `auto`) is accepted and
    reported once as having no effect."""
    from ragb_vae_tpu_torch.data.image_io import load_rgba, save_rgba

    _write_jax_checkpoint(tmp_path)
    src = tmp_path / "in.png"
    save_rgba(np.random.default_rng(3).uniform(size=(48, 32, 4)), src)
    argv = [
        "--pretrained_model_name_or_path", str(tmp_path / "flux"),
        "--rgba_vae_path", str(tmp_path / "vae"),
        "--input_image", str(src), "--output_path", str(tmp_path / "out.png"),
        "--steps", "2", "--seed", "0", "--precision", "fp32", "--device", "cpu",
    ]
    inference.main(argv)
    first = load_rgba(tmp_path / "out.png")
    assert first.shape == (48, 32, 4)
    assert capsys.readouterr().out.count("--compilation_cache has no effect") == 1
    inference.main(argv[:7] + [str(tmp_path / "again.png")] + argv[8:] + ["--compilation_cache", "off"])
    np.testing.assert_array_equal(load_rgba(tmp_path / "again.png"), first)
    assert "--compilation_cache" not in capsys.readouterr().out
    assert inference.parse_args(argv + ["--compilation_cache", "/tmp/cache"]).compilation_cache == "/tmp/cache"


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The tiny checkpoint tree, an input PNG and rank-2 adapters (non-zero B)
    in peft format at `lora/`."""
    from ragb_vae_tpu_torch.data.image_io import save_rgba

    root = tmp_path_factory.mktemp("ckpt")
    _write_jax_checkpoint(root)
    save_rgba(np.random.default_rng(4).uniform(size=(32, 32, 4)), root / "in.png")
    lora = FluxTextAlphaModel.random(FluxTransformerConfig.tiny(), _vae_config(), seed=1, device="cpu",
                                     prompt_len=4, lora_rank=2, lora_alpha=4.0)
    with torch.no_grad():
        for name, p in lora.transformer.named_parameters():
            if name.endswith("lora_B"):
                p.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(len(name)))
    lora.save_lora_weights(root / "lora")
    return root


@pytest.mark.parametrize("flag", [["--pp", "2", "--quant", "int8"], ["--pp", "3"], ["--pp", "2"],
                                  ["--lora_path", "x", "--pp", "2", "--device", "cpu"]])
def test_inference_unported_options_raise(checkpoint, flag):
    """`--pp N` (with int8, with adapters) samples through an N-stage
    pipeline on the CPU and writes the PNG `--pp 1` writes, bit for bit
    (`x` stands for the adapters' directory)."""
    from ragb_vae_tpu_torch.data.image_io import load_rgba

    flag = [str(checkpoint / "lora") if f == "x" else f for f in flag]
    outs = []
    for pp in (flag[flag.index("--pp") + 1], "1"):
        out = checkpoint / f"out_{'_'.join(flag).replace('/', '')}_{pp}.png"
        argv = ["--pretrained_model_name_or_path", str(checkpoint / "flux"), "--rgba_vae_path", str(checkpoint / "vae"),
                "--input_image", str(checkpoint / "in.png"), "--output_path", str(out), "--steps", "1", "--seed", "0",
                "--precision", "fp32", "--device", "cpu", "--rank", "2", "--lora_alpha", "4", *flag]
        argv[argv.index("--pp", len(argv) - len(flag)) + 1] = pp
        inference.main(argv)
        outs.append(load_rgba(out))
    assert outs[0].shape == (32, 32, 4)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_pipelined_server_answers_as_the_single_device_one(model):
    from ragb_vae_tpu_torch.parallel.pipeline import PipelinedFluxTransformer

    img = _images(5)[0]
    answers = []
    for pipeline in (None, PipelinedFluxTransformer(model.transformer_config, ["cpu"] * 3).place_(model.transformer)):
        with InferenceServer(model, ServeConfig(max_batch=1, steps=2, auto_batch=False), pipeline=pipeline) as server:
            answers.append(server.submit(img, seed=21).result(timeout=TIMEOUT_S))
    np.testing.assert_array_equal(answers[0], answers[1])


def test_inference_refuses_a_missing_card(monkeypatch):
    """`--device` defaults to the card; without one the entry point raises
    instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = inference.parse_args(
        ["--pretrained_model_name_or_path", "m", "--rgba_vae_path", "v", "--input_image", "i", "--output_path", "o"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="is_available.. is False"):
        inference.run(args)
    assert inference.resolve_device("cpu") == torch.device("cpu")
    # the library's constructors too: the card is their default, and they raise before they build or read
    with pytest.raises(RuntimeError, match="is_available.. is False"):
        FluxTextAlphaModel.random(FluxTransformerConfig.tiny(), _vae_config(), prompt_len=4)
    with pytest.raises(RuntimeError, match="is_available.. is False"):
        FluxTextAlphaModel.from_pretrained("no such directory", vae_path="nor this one")


def test_inference_pp_exits_naming_the_card_count(monkeypatch):
    """On the card with fewer cards than `--pp`, before anything is read."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    args = inference.parse_args(["--pretrained_model_name_or_path", "m", "--rgba_vae_path", "v",
                                 "--input_image", "i", "--output_path", "o", "--pp", "4"])
    with pytest.raises(SystemExit, match="--pp 4 needs 4 devices, found 2"):
        inference.run(args)
