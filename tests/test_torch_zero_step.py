"""The port's ZeRO-2 step (`parallel/zero_step.py`, `training/vae_step.py`
with `mesh=`) at world 2 on gloo, against the port's one-process step and the
JAX package's ZeRO-2 (`make_zero2_train_step`) and GSPMD
(`make_train_step(mesh=)`) steps on a 2-device CPU mesh.

Tiny RgbaVAE (`AutoencoderConfig.tiny()`, 4 channels), one set of random
numpy weights in both packages, 32x32 images, two optimizer steps, the
posterior noise injected per row (on the JAX side through the loss, whose
batch carries it). Two ranks are spawned once for the module; the cases are
parametrised over what that one spawn returns:

- "even": every row real (weight 1);
- "uneven": weights (1, 1 | 1, 0): the only padding row lies on rank 1, so a
  plain mean of the per-rank means would weight rank 1's one real row as
  much as rank 0's two;
- "accum2": the same weights over two micro-batches a rank;
- "offload": "uneven" with the moments in host memory between steps.

World 2 against one process on the whole batch (the same code and
framework, another summation order): metrics and gradient norm to 1e-5
relative; parameters and the gathered optimizer state by
`assert_close_after_adamw`: each tensor's mean error within 1e-5 of its
largest entry plus 1e-3 of one update (lr), no entry beyond one update
(AdamW divides by sqrt(v), so where a gradient is near zero its rounding
noise decides a visible part of that entry's update).
Against JAX: JAX's two steps agree with each other by the same rule; the
port is held to them as `tests/test_torch_vae_step_adamw.py` holds the
one-device step (gradients through ~30 convs in another framework agree to
2e-3 of a leaf's largest entry): metrics to 5e-4, each parameter's mean
error within 0.5% of lr, at most 1e-3 of its entries beyond 5% of lr and
none beyond 20%.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragb_vae_tpu.models import losses as jl
from ragb_vae_tpu.models.rgba_vae import RgbaVAE as JaxRgbaVAE
from ragb_vae_tpu.ops.gaussian import split_batch as jsplit_batch
from ragb_vae_tpu.ops.rgba import to_vae_range as jto_vae_range
from ragb_vae_tpu.ops.triplet import detail_augmented_triplet as jtriplet
from ragb_vae_tpu.parallel import create_mesh as jcreate_mesh
from ragb_vae_tpu.parallel.zero_step import init_zero2_state, make_zero2_train_step, zero2_optimizer
from ragb_vae_tpu.training import vae_step as jvs
from ragb_vae_tpu_torch.models import weights as tw
from ragb_vae_tpu_torch.models.losses import AlphaVaeLossConfig
from ragb_vae_tpu_torch.models.rgba_vae import RgbaVAE
from ragb_vae_tpu_torch.parallel.mesh import Mesh
from ragb_vae_tpu_torch.training import rgba_vae_stage as tstage
from ragb_vae_tpu_torch.training import vae_step as tvs
from test_torch_vae import _configs, _random_params
from torch_dist_worker import assert_close_after_adamw, noise_decides, spawn, zero_steps

LR = 1e-3
MAX_GRAD_NORM = 1.0
KL_SCALE = 1e-4
RTOL = 1e-5
UNEVEN = [1.0, 1.0, 1.0, 0.0]
CASES = [
    {"name": "even", "weights": [1.0] * 4, "accum": 1, "offload": False},
    {"name": "uneven", "weights": UNEVEN, "accum": 1, "offload": False},
    {"name": "accum2", "weights": UNEVEN, "accum": 2, "offload": False},
    {"name": "offload", "weights": UNEVEN, "accum": 1, "offload": True},
]
NAMES = [c["name"] for c in CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jcfg, tcfg = _configs()
    params = _random_params(jcfg, seed=0)
    rng = np.random.default_rng(3)
    payload = {
        "config": tcfg, "state": tw.params_from_flax(params), "lr": LR, "max_grad_norm": MAX_GRAD_NORM,
        "kl_scale": KL_SCALE, "cases": CASES,
        "images": [rng.uniform(size=(4, 32, 32, 4)).astype(np.float32) for _ in range(2)],
        "eps": [rng.standard_normal((4, 16, 16, 4)).astype(np.float32) for _ in range(2)],
        "partial": _partial_state_dict(),
    }
    # the one-process run and JAX's steps here while the two ranks run
    ranks, (one, jax_out) = spawn(
        "zero_steps", 2, tmp_path_factory.mktemp("zero"), payload,
        meanwhile=lambda: (zero_steps(0, 1, payload, None, mesh=Mesh()), _jax_steps(jcfg, params, payload)))
    return {"payload": payload, "jcfg": jcfg, "params": params, "ranks": ranks, "one": one, "jax": jax_out}


def _param_names(run):
    model = RgbaVAE(run["payload"]["config"])
    return [n for n, p in model.module.named_parameters() if p.requires_grad]


def _close_tree(got, want, what):
    assert_close_after_adamw(got, want, what, lr=LR, rtol=RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_world2_equals_one_process_on_the_whole_batch(run, name):
    got, want = run["ranks"][0][name], run["one"][name]
    for step, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, err_msg=f"step {step} {k}")
    _close_tree(got["params"], want["params"], "params")
    # the replicas agree bit for bit, and the checkpointed state is layout-free
    for k, v in got["params"].items():
        torch.testing.assert_close(run["ranks"][1][name]["params"][k], v, rtol=0, atol=0)
    assert got["optimizer"]["param_groups"] == want["optimizer"]["param_groups"]
    names = _param_names(run)
    for i, state in want["optimizer"]["state"].items():
        if not noise_decides(names[i]):
            _close_tree(got["optimizer"]["state"][i], state, f"optimizer state of {names[i]}")


def _jax_loss(params, batch, key, *, model, loss_cfg, step_cfg, ref_params=None, lpips_fn=None):
    """`vae_loss_fn` with the posterior noise taken from batch["eps"]."""
    del key, ref_params, lpips_fn
    weights = batch.get("weights")
    target_vae = jto_vae_range(jnp.clip(batch["images"], 0.0, 1.0))
    posterior, _, _ = jsplit_batch(model.encode(params, jtriplet(target_vae)), 3)
    pred = model.decode(params, posterior.mean + posterior.std * batch["eps"])
    recon = loss_cfg.reconstruction_loss(pred, target_vae, weights)
    kl = loss_cfg.kl_loss(posterior, weights=weights)
    total = recon + step_cfg.kl_scale * kl
    return total, {"train/recon": recon, "train/kl": kl, "train/loss": total}


def _jax_steps(jcfg, params, payload):
    """JAX's ZeRO-2 and GSPMD steps over two devices, two steps each, for
    the cases without accumulation (JAX's ZeRO-2 step refuses it)."""
    jvae = JaxRgbaVAE(config=jcfg)
    loss_cfg, step_cfg = jl.AlphaVaeLossConfig(reduce_mean=True), jvs.VaeStepConfig(kl_scale=KL_SCALE)
    mesh = jcreate_mesh(devices=jax.devices()[:2])
    loss = functools.partial(_jax_loss, model=jvae, loss_cfg=loss_cfg, step_cfg=step_cfg)
    z_tx = zero2_optimizer(LR)
    zstep = make_zero2_train_step(loss, z_tx, mesh, max_grad_norm=MAX_GRAD_NORM, donate=False)
    tx = jvs.make_optimizer(LR, max_grad_norm=MAX_GRAD_NORM)
    real_loss, jvs.vae_loss_fn = jvs.vae_loss_fn, _jax_loss    # make_train_step binds it when called
    try:
        gstep = jvs.make_train_step(jvae, tx, loss_cfg, step_cfg, mesh=mesh, donate=False,
                                    opt_state_example=jax.eval_shape(tx.init, params))
    finally:
        jvs.vae_loss_fn = real_loss
    # placed as the steps return them, so the second step reuses the first one's program
    start = jax.device_put(params, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    out = {}
    for name in ("even", "uneven"):
        weights = next(c["weights"] for c in CASES if c["name"] == name)
        for kind, step, opt in (("zero2", zstep, init_zero2_state(start, z_tx, mesh)),
                                ("gspmd", gstep, jvs.init_train_state(jvae, start, tx, mesh=mesh))):
            params_, metrics = start, []
            for images, eps in zip(payload["images"], payload["eps"]):
                batch = {"images": jnp.asarray(images), "eps": jnp.asarray(eps),
                         "weights": jnp.asarray(weights, jnp.float32)}
                params_, opt, m = step(params_, opt, batch, jax.random.PRNGKey(0))
                metrics.append({k: float(v) for k, v in m.items()})
            out[name, kind] = {"params": jax.device_get(params_), "metrics": metrics}
    return out


@pytest.fixture(scope="module")
def jax_runs(run):
    return run["jax"]


def _torch_tree(params):
    return {jax.tree_util.keystr(p): torch.from_numpy(np.asarray(v))
            for p, v in jax.tree_util.tree_leaves_with_path(params)}


@pytest.mark.parametrize("name", ["even", "uneven"])
def test_jax_zero2_and_gspmd_steps_agree(jax_runs, name):
    z, g = jax_runs[name, "zero2"], jax_runs[name, "gspmd"]
    for a, b in zip(z["metrics"], g["metrics"]):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, err_msg=k)
    _close_tree(_torch_tree(z["params"]), _torch_tree(g["params"]), "params")


@pytest.mark.parametrize("kind", ["zero2", "gspmd"])
@pytest.mark.parametrize("name", ["even", "uneven"])
def test_world2_matches_the_jax_steps_on_a_2_device_mesh(run, jax_runs, name, kind):
    want = jax_runs[name, kind]
    got = run["ranks"][0][name]
    for step, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=5e-4, err_msg=f"step {step} {k}")
    moved = dict(jax.tree_util.tree_leaves_with_path(tw.params_to_flax(got["params"])))
    start = dict(jax.tree_util.tree_leaves_with_path(run["params"]))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want["params"]):
        name_ = jax.tree_util.keystr(path)
        if noise_decides(name_):
            continue
        err = np.abs(moved[path] - np.asarray(leaf))
        assert np.abs(np.asarray(leaf) - start[path]).max() > 0.1 * LR, f"{name_} did not move"
        assert (err > 0.05 * LR).mean() <= 1e-3 and err.max() <= 0.2 * LR and err.mean() <= 0.005 * LR, (
            name_, err.max(), err.mean())


def test_offload_keeps_the_moments_on_the_host_between_steps(run):
    assert run["ranks"][0]["offload"]["moments_on_cpu"] and run["one"]["offload"]["moments_on_cpu"]


def test_world1_equals_clipped_adamw(run):
    """The one-process ZeRO-2 step against the single-device route
    (`ClippedAdamW` without a mesh) on the same batches and noise."""
    payload = run["payload"]
    model = RgbaVAE(payload["config"])
    model.module.load_state_dict(payload["state"], strict=True)
    optimizer = tvs.make_optimizer(tvs.trainable_parameters(model), LR, max_grad_norm=MAX_GRAD_NORM)
    tvs.init_train_state(model, optimizer)
    step = tvs.make_train_step(model, optimizer, AlphaVaeLossConfig(reduce_mean=True),
                               tvs.VaeStepConfig(kl_scale=KL_SCALE))
    weights = torch.tensor(UNEVEN)
    for images, eps in zip(payload["images"], payload["eps"]):
        metrics = step({"images": torch.from_numpy(images), "weights": weights}, eps=torch.from_numpy(eps))
    want = run["one"]["uneven"]
    for k, v in want["metrics"][-1].items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=RTOL, err_msg=k)
    _close_tree(model.module.state_dict(), want["params"], "params")
    sd = optimizer.state_dict()
    assert sd["param_groups"] == want["optimizer"]["param_groups"]
    names = _param_names(run)
    for i, state in sd["state"].items():
        if not noise_decides(names[i]):
            _close_tree(want["optimizer"]["state"][i], state, f"optimizer state of {names[i]}")


@pytest.mark.parametrize("option,match", [
    ({"gradient_accumulation_steps": 2}, "gradient accumulation"),
    ({"optimizer_offload": True}, "optimizer_offload"),
])
def test_shard_map_keeps_the_jax_refusals(option, match):
    cfg = {"training": {"zero_impl": "shard_map", **option}, "model": {}, "data": {}}
    with pytest.raises(ValueError, match=match):
        tstage.train_rgba_vae(cfg, device="cpu")


def test_offload_needs_a_mesh(run):
    payload = run["payload"]
    model = RgbaVAE(payload["config"])
    optimizer = tvs.make_optimizer(tvs.trainable_parameters(model), LR)
    with pytest.raises(ValueError, match="requires a mesh"):
        tvs.make_train_step(model, optimizer, AlphaVaeLossConfig(), tvs.VaeStepConfig(), offload_opt_state=True)
    with pytest.raises(ValueError, match="requires a mesh"):
        tvs.init_train_state(model, optimizer, offload=True)


# ---------------------------------------------------------------------------
# A single-device state dict in which a parameter has no state (C3)
# ---------------------------------------------------------------------------
def _partial_state_dict() -> dict:
    """Two parameters, one of them (5 elements, so the flat layout of 12 puts
    it across both ranks' slices at world 2) stepped twice: `torch.optim`
    makes a parameter's state only at its first gradient."""
    params = [torch.nn.Parameter(torch.arange(7.0)), torch.nn.Parameter(-torch.arange(5.0))]
    opt = tvs.ClippedAdamW(params, 1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.01, max_grad_norm=1.0)
    for _ in range(2):
        params[1].grad = torch.linspace(-1.0, 1.0, 5)
        opt.step()
    sd = opt.state_dict()
    assert set(sd["state"]) == {1}
    return {"params": [p.detach().clone() for p in params], "state_dict": sd}


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("way", ["wrapped", "load_state_dict"])
def test_partial_state_dict_loads_with_zero_moments(run, world, way):
    """The stepped parameter's moments and step come through, the other's
    moments are zeros, and the gathered state dict is the whole one: every
    parameter's entry, the missing one's at zero and at the stepped step."""
    partial = run["payload"]["partial"]
    want = partial["state_dict"]["state"][1]
    results = [run["one"]["partial"]] if world == 1 else [r["partial"] for r in run["ranks"]]
    flat = {k: torch.cat([r[way][k] for r in results])[:12] for k in ("exp_avg", "exp_avg_sq")}
    for k, v in flat.items():
        assert torch.equal(v[:7], torch.zeros(7)), k
        assert torch.equal(v[7:], want[k]), k
    for r in results:
        assert r[way]["step"] == float(want["step"]) == 2.0
        sd = r[way]["state_dict"]
        assert set(sd["state"]) == {0, 1}
        assert torch.equal(sd["state"][0]["exp_avg"], torch.zeros(7))
        assert torch.equal(sd["state"][1]["exp_avg_sq"], want["exp_avg_sq"])
        assert float(sd["state"][0]["step"]) == 2.0
