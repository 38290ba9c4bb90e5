"""The port's weight-only int8 quantisation against the JAX package's.

`quantize_kernel` is the same arithmetic in torch ops (fp32 divide, round half
to even, clip), so `q` and `scale` must be bit-equal to the numpy ones. The
tree rewrite, the random quantised tree and the on-disk format are held
against the JAX functions on the tiny FLUX configuration; a checkpoint
directory written by either package is read by the other.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ragb_vae_tpu.models import quantize as jq
from ragb_vae_tpu.models.flux_transformer import FluxTransformer2D as JaxFlux
from ragb_vae_tpu.models.flux_transformer import FluxTransformerConfig as JaxFluxConfig
from ragb_vae_tpu_torch.models import flux_weights as tfw
from ragb_vae_tpu_torch.models import quantize as tq
from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformer2D, FluxTransformerConfig
from tests.test_torch_flux import _inputs, random_flux_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: tiny tensors gain
    nothing from intra-op threads, and the workers stop fighting for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _to_numpy(tree):
    return jax.tree_util.tree_map(lambda v: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v), tree)


@pytest.mark.parametrize("shape,scale", [((64, 32), 0.1), ((96, 80), 3.0), ((7, 5), 1e-3)])
def test_quantize_kernel_is_bit_equal_to_jax(shape, scale):
    w = (np.random.default_rng(0).standard_normal(shape) * scale).astype(np.float32)
    w[0, 0] = 1.5 * np.abs(w[:, 0]).max() / 127.0      # a quotient at (or an ulp from) 1.5: the rounding mode shows
    want, got = jq.quantize_kernel(w), tq.quantize_kernel(torch.from_numpy(w))
    assert got["kernel_q"].dtype == torch.int8 and got["kernel_scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["kernel_q"].numpy(), want["kernel_q"])
    np.testing.assert_array_equal(got["kernel_scale"].numpy(), want["kernel_scale"])
    deq = tq.dequantize_kernel(got["kernel_q"], got["kernel_scale"]).numpy()
    np.testing.assert_array_equal(deq, jq.dequantize_kernel(want["kernel_q"], want["kernel_scale"]))
    assert np.all(np.abs(w - deq) <= want["kernel_scale"][None, :] / 2 + 1e-7)


def test_quantize_kernel_zero_column():
    w = np.zeros((8, 4), np.float32)
    w[:, 0] = 0.5
    want, got = jq.quantize_kernel(w), tq.quantize_kernel(w)
    np.testing.assert_array_equal(got["kernel_scale"].numpy(), want["kernel_scale"])
    np.testing.assert_array_equal(got["kernel_q"].numpy(), want["kernel_q"])
    assert got["kernel_scale"][1:].tolist() == [1.0, 1.0, 1.0]


def test_tree_rewrite_matches_jax_leaf_by_leaf():
    params = random_flux_params(JaxFluxConfig.tiny())
    want = _flat(jq.quantize_transformer_params(params))
    got = _flat(_to_numpy(tq.quantize_transformer_params(params)))
    assert got.keys() == want.keys()
    assert any(k.endswith("['kernel_q']") for k in got) and not any(k.endswith("['kernel']") for k in got)
    for key, leaf in want.items():
        assert got[key].dtype == leaf.dtype, key
        np.testing.assert_array_equal(got[key], leaf, err_msg=key)


def test_random_quantized_params_like_has_jax_shapes_and_dtypes():
    shapes = random_flux_params(JaxFluxConfig.tiny())
    want = _flat(jq.random_quantized_params_like(shapes, seed=0))
    tree = tq.random_quantized_params_like(shapes, seed=0, device="cpu")
    got = _flat(_to_numpy(tree))
    assert got.keys() == want.keys()
    for key, leaf in want.items():
        assert (got[key].shape, got[key].dtype) == (leaf.shape, leaf.dtype), key
        if key.endswith("['kernel_scale']") or key.endswith("['bias']"):
            np.testing.assert_array_equal(got[key], leaf, err_msg=key)     # 3/sqrt(in)/127 and zeros
    q = got["['transformer_blocks_0']['attn']['to_q']['base']['kernel_q']"]
    assert q.min() >= -127 and q.max() <= 127 and np.abs(q).max() > 100
    again = _flat(_to_numpy(tq.random_quantized_params_like(shapes, seed=0, device="cpu")))
    assert all(np.array_equal(again[k], got[k]) for k in got)
    # the tree loads strictly into the port's int8 transformer and runs
    model = FluxTransformer2D(FluxTransformerConfig.tiny(), weight_quant="int8")
    model.load_state_dict(tfw.params_from_flax(tree), strict=True)
    with torch.no_grad():
        out = model(**{k: None if v is None else torch.from_numpy(v) for k, v in _inputs(JaxFluxConfig.tiny()).items()})
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_directory_crosses_between_the_packages(tmp_path, writer):
    jcfg, tcfg = JaxFluxConfig.tiny(), FluxTransformerConfig.tiny()
    qparams = jq.quantize_transformer_params(random_flux_params(jcfg))
    out = tmp_path / "transformer"
    if writer == "jax":
        jq.save_quantized_transformer(jcfg, qparams, out)
    else:
        as_tensors = jax.tree_util.tree_map(lambda v: torch.from_numpy(np.asarray(v)), qparams)
        tq.save_quantized_transformer(tcfg, as_tensors, out)
    assert jq.is_quantized_checkpoint(out) and tq.is_quantized_checkpoint(out)
    assert {p.name for p in out.iterdir()} == {"config.json", "quantized_params.npz", "quantization.json"}
    jcfg2, jtree = jq.load_quantized_transformer(out)
    tcfg2, ttree = tq.load_quantized_transformer(out)
    assert jcfg2 == jcfg and tcfg2 == tcfg
    want = _flat(qparams)
    for tree in (jtree, ttree):
        got = _flat(tree)
        assert got.keys() == want.keys()
        for key, leaf in want.items():
            assert got[key].dtype == leaf.dtype, key
            np.testing.assert_array_equal(got[key], leaf, err_msg=key)
    with pytest.raises(FileNotFoundError, match="not a quantized checkpoint"):
        tq.load_quantized_transformer(tmp_path)


def test_int8_state_round_trips_through_the_flax_layout():
    """`params_from_flax` carries kernel_q (transposed to (out, in), int8) and
    kernel_scale; `params_to_flax` brings them back bit for bit."""
    qparams = jq.quantize_transformer_params(random_flux_params(JaxFluxConfig.tiny()))
    state = tfw.params_from_flax(qparams)
    q = qparams["transformer_blocks_0"]["attn"]["to_q"]["base"]
    assert state["transformer_blocks.0.attn.to_q.weight_q"].dtype == torch.int8
    np.testing.assert_array_equal(state["transformer_blocks.0.attn.to_q.weight_q"].numpy(), q["kernel_q"].T)
    np.testing.assert_array_equal(state["transformer_blocks.0.attn.to_q.weight_scale"].numpy(), q["kernel_scale"])
    model = FluxTransformer2D(FluxTransformerConfig.tiny(), weight_quant="int8")
    model.load_state_dict(state, strict=True)
    assert not any(n.endswith(("weight_q", "weight_scale")) for n, _ in model.named_parameters())
    back, want = _flat(tfw.params_to_flax(model.state_dict())), _flat(qparams)
    assert back.keys() == want.keys()
    for key, leaf in want.items():
        assert back[key].dtype == leaf.dtype, key
        np.testing.assert_array_equal(back[key], leaf, err_msg=key)


def test_quantize_module_in_place_equals_the_tree_rewrite():
    params = random_flux_params(JaxFluxConfig.tiny())
    model = FluxTransformer2D(FluxTransformerConfig.tiny())
    model.load_state_dict(tfw.params_from_flax(params), strict=True)
    tq.quantize_module_(model)
    assert model.weight_quant == "int8"
    got, want = _flat(tfw.params_to_flax(model.state_dict())), _flat(jq.quantize_transformer_params(params))
    assert got.keys() == want.keys()
    for key, leaf in want.items():
        np.testing.assert_array_equal(got[key], leaf, err_msg=key)


def test_quantize_checkpoint_script_writes_what_jax_reads(tmp_path):
    """scripts/quantize_flux_checkpoint_torch.py on a tiny HF-format dir; the
    JAX package loads the result and its int8 forward tracks the plain one."""
    from ragb_vae_tpu.models.flux_kontext_textalpha import load_transformer
    from ragb_vae_tpu.models.flux_weights import save_flux_transformer_params

    jcfg = JaxFluxConfig.tiny()
    params = random_flux_params(jcfg)
    save_flux_transformer_params(jcfg, params, tmp_path / "ckpt" / "transformer")
    dst = tmp_path / "ckpt-int8" / "transformer"
    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, str(repo / "scripts" / "quantize_flux_checkpoint_torch.py"),
         "--model_path", str(tmp_path / "ckpt"), "--output_dir", str(dst), "--device", "cpu"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})     # a tiny checkpoint: no use for more
    assert proc.returncode == 0, proc.stderr
    assert "saved to" in proc.stdout
    cfg2, loaded = load_transformer(tmp_path / "ckpt-int8")
    want = _flat(jq.quantize_transformer_params(params))
    got = _flat(loaded)
    assert got.keys() == want.keys()
    for key, leaf in want.items():
        np.testing.assert_array_equal(got[key], leaf, err_msg=key)
    inputs = {k: v for k, v in _inputs(jcfg).items()}
    out = JaxFlux(cfg2, weight_quant="int8", remat=False).apply({"params": loaded}, **inputs)
    ref = JaxFlux(jcfg, remat=False).apply({"params": params}, **inputs)
    assert float(np.max(np.abs(np.asarray(out) - np.asarray(ref)))) / float(np.max(np.abs(np.asarray(ref)))) < 0.05
