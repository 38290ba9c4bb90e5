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
        FluxTransformerConfig.tiny(), _vae_config(), seed=0, fused=True, prompt_len=4
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


def test_inference_run_on_a_jax_written_checkpoint(tmp_path):
    from ragb_vae_tpu_torch.data.image_io import load_rgba, save_rgba

    _write_jax_checkpoint(tmp_path)
    src = tmp_path / "in.png"
    save_rgba(np.random.default_rng(3).uniform(size=(48, 32, 4)), src)
    argv = [
        "--pretrained_model_name_or_path", str(tmp_path / "flux"),
        "--rgba_vae_path", str(tmp_path / "vae"),
        "--input_image", str(src), "--output_path", str(tmp_path / "out.png"),
        "--steps", "2", "--seed", "0", "--precision", "fp32",
    ]
    inference.main(argv)
    first = load_rgba(tmp_path / "out.png")
    assert first.shape == (48, 32, 4)
    inference.main(argv[:7] + [str(tmp_path / "again.png")] + argv[8:])
    np.testing.assert_array_equal(load_rgba(tmp_path / "again.png"), first)


@pytest.mark.parametrize("flag", [["--quant", "int8"], ["--tp", "2"], ["--pp", "2"], ["--lora_path", "x"]])
def test_inference_unported_options_raise(flag):
    args = inference.parse_args(
        ["--pretrained_model_name_or_path", "m", "--rgba_vae_path", "v",
         "--input_image", "i", "--output_path", "o", *flag]
    )
    with pytest.raises(NotImplementedError, match="not ported yet"):
        inference.run(args)
