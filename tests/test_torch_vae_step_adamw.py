"""The port's RGBA-VAE train step against the JAX package's compiled step:
the parameters after two optimizer steps (global-norm clip, then AdamW).

Same set-up as `tests/test_torch_vae_step.py` (tiny VAE, one set of weights
in both packages, a frozen reference, LPIPS, the JAX step's own noise
injected as `eps`), for one microbatch and for two with per-sample weights
whose second microbatch is all padding.

fp32 on both sides. AdamW divides by sqrt(v), so where a gradient is near
zero its noise decides the update's sign: each leaf is held to 5% of one
update's size (lr 1e-3) and, over the leaf, to a mean error below 0.5% of
it; every leaf must have moved by more than 10% of lr. The metrics of each
step agree to 5e-4 relative (the second step runs on parameters that
already differ by that noise).
"""
import jax
import numpy as np
import pytest
import torch

from ragb_vae_tpu.models import losses as jl
from ragb_vae_tpu.models.rgba_vae import RgbaVAE as JaxRgbaVAE
from ragb_vae_tpu.training import vae_step as jvs
from ragb_vae_tpu_torch.models import losses as tl
from ragb_vae_tpu_torch.models import weights as tw
from ragb_vae_tpu_torch.training import vae_step as tvs
from test_torch_vae_step import (  # noqa: F401
    LR, SCALES, _batches, _jax_eps, _one_torch_thread, _port_models, world)


@pytest.mark.parametrize("accum,weighted", [(1, False), (2, True)], ids=["accum1", "accum2-padded"])
def test_parameters_after_two_clipped_adamw_steps_match_jax(world, accum, weighted):
    jvae = JaxRgbaVAE(config=world["jcfg"])
    tx = jvs.make_optimizer(LR, max_grad_norm=1.0)
    jstep = jvs.make_train_step(
        jvae, tx, jl.AlphaVaeLossConfig(reduce_mean=True),
        jvs.VaeStepConfig(gradient_accumulation_steps=accum, **SCALES),
        ref_params=world["ref_params"], lpips_fn=world["jlpips"], donate=False)
    model, ref = _port_models(world)
    optimizer = tvs.make_optimizer(tvs.trainable_parameters(model), LR, max_grad_norm=1.0)
    tvs.init_train_state(model, optimizer)
    tstep = tvs.make_train_step(
        model, optimizer, tl.AlphaVaeLossConfig(reduce_mean=True),
        tvs.VaeStepConfig(gradient_accumulation_steps=accum, **SCALES),
        ref_model=ref, lpips_fn=world["tlpips"])

    jb, tb = _batches(world, weighted)
    params, opt_state = world["params"], jvs.init_train_state(jvae, world["params"], tx)
    for i in range(2):
        key = jax.random.PRNGKey(20 + i)
        params, opt_state, want = jstep(params, opt_state, jb, key)
        got = tstep(tb, eps=torch.from_numpy(_jax_eps(key, accum, (4, 16, 16, 4))))
        assert set(got) == set(want)
        for name, value in want.items():
            np.testing.assert_allclose(got[name].item(), float(value), rtol=5e-4, err_msg=f"step {i} {name}")
        assert got["train/grad_norm"].item() > 1.0  # the clip is active

    moved = tw.params_to_flax(model.module.state_dict())
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(moved))
    flat_start = dict(jax.tree_util.tree_leaves_with_path(world["params"]))
    for path, leaf in flat_want:
        name = jax.tree_util.keystr(path)
        if "to_k" in name and "bias" in name:
            continue  # its true gradient is zero (softmax ignores a constant key shift): noise decides
        err = np.abs(flat_got[path] - np.asarray(leaf))
        assert np.abs(np.asarray(leaf) - flat_start[path]).max() > 0.1 * LR, f"{name} did not move"
        assert err.max() <= 0.05 * LR and err.mean() <= 0.005 * LR, (name, err.max(), err.mean())
