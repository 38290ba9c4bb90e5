"""The LoRA stage's FSDP (`parallel/fsdp.py`, `--shard_base_params`) and
sequence parallelism (`parallel/sequence_parallel.py`, `--sequence_parallel`)
against the port's one-process run and the JAX package's ("data", "sp") mesh
on `jax.devices()[:2]`.

The JAX TP tests' config (8 heads x 32, 2 + 2 blocks), the tiny RGBA `ae`,
32^2 images (2 x 64 image tokens and 4 prompt tokens a sample), fp32 unless
named. One set of random numpy weights with non-zero rank-4 adapters crosses
into the port through `params_from_flax`. The ranks split leaves of 2**12
elements and up (JAX's 2**16 would leave every leaf of the stage's tiny model
whole; the rule is otherwise JAX's).

- One world-2 gloo spawn (`axes_world2`), the cases parametrised over what it
  returns. Sequence axis 2: attention on each rank's tokens (one stream, and
  two streams gathered back in the unsharded order) against one process and
  JAX's `attention(mesh=)`; the LoRA loss and adapter gradients against one
  process and JAX's SP model; the sample in fp32, bf16 and over int8 against
  one process; the all-gathers a forward; a prompt of 3 tokens runs
  unsharded. Data axis 2: each rank's loss and gradients with the base
  FSDP-split equal the whole base's bit for bit (bf16 and int8), a rank holds
  half of the split leaves, `from_pretrained(fsdp=)` keeps exactly each
  rank's part of three checkpoint kinds, and the stage with
  `shard_base_params` lands within JAX's 1e-3 of world 1.
- One world-4 spawn (`axes_world4`): two `make_lora_train_step` steps at
  (data 2, sequence 2) with the base FSDP-split, and at (model 2, sequence
  2), each against one process on the whole batch; the stage's own loop with
  `sequence_parallel: 2` and `shard_base_params` against world 1.

Tolerances. SP against one process: the same code, each rank's queries and
tokens a contiguous part, keys gathered back into the order one process
uses; each token's sums are the same, only the key and value gradients add
two ranks' partials: JAX's own SP tolerances (loss rtol 1e-4, gradients rtol
5e-4 / atol 1e-5, sample 2e-4; bf16 one bf16 step, 2e-2; int8 3e-4). Against
JAX: the port's cross-framework bounds of `tests/test_torch_lora_loss.py`
(loss 1e-4, gradients 2e-3 relative with a 2e-6 floor) and JAX's attention
tolerance (1e-5 forward, rtol 1e-4 / atol 1e-5 gradients). FSDP copies
weights exactly: bit for bit. The world-4 steps by `assert_close_after_adamw`
at lr 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from ragb_vae_tpu.models.flux_kontext_textalpha import FluxTextAlphaModel as JaxModel
from ragb_vae_tpu.models.flux_weights import merge_params, split_lora_params
from ragb_vae_tpu.models.rgba_vae import RgbaVAE as JaxRgbaVAE
from ragb_vae_tpu.models.scheduler import FlowMatchEulerScheduler as JaxScheduler
from ragb_vae_tpu.ops.pallas.flash_attention import attention as jattention
from ragb_vae_tpu_torch.models import flux_weights as tfw
from ragb_vae_tpu_torch.models import weights as tw
from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformer2D
from ragb_vae_tpu_torch.parallel import fsdp as tfsdp
from ragb_vae_tpu_torch.parallel.mesh import Mesh
from test_tensor_parallel import tp_config
from test_torch_lora_loss import ALPHA, RANK, random_lora_flux_params
from test_torch_tensor_parallel import _port_config, _vae_configs, _write_checkpoints
from test_torch_vae import _random_params as random_vae_params
from torch_dist_worker import (
    assert_close_after_adamw,
    axes_stage,
    sp_attention,
    sp_case,
    spawn,
    tp_loads,
    tp_train_steps,
)

MIN_SIZE = 2**12
ONE_LOSS_RTOL = 1e-4
ONE_GRAD_RTOL, ONE_GRAD_ATOL = 5e-4, 1e-5
ONE_SAMPLE_TOL = {"sample": 2e-4, "bf16": 2e-2, "int8": 3e-4}
JAX_LOSS_TOL = 1e-4
JAX_GRAD_RTOL, JAX_GRAD_ATOL = 2e-3, 2e-6
ATTN_TOL, ATTN_GRAD_RTOL, ATTN_GRAD_ATOL = 1e-5, 1e-4, 1e-5
STAGE_LOSS_TOL = 1e-3
LR = 1e-3
STEPS = 2
SP = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _attention_cases(rng) -> dict:
    """(B, H, S, D) operands: one stream of 16 tokens, and a joint stream of
    4 + 12 tokens (a prompt and an image stream)."""
    def case(segments):
        s = sum(segments)
        return {**{n: rng.standard_normal((2, 2, s, 16)).astype(np.float32) for n in ("q", "k", "v", "g")},
                "segments": segments}

    return {"one stream": case((16,)), "two streams": case((4, 12))}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from data_fixtures import make_text_alpha_tree
    from test_torch_lora_stage import _cfg as lora_cfg

    jcfg = tp_config()
    jv, tv = _vae_configs()
    params = random_lora_flux_params(jcfg, seed=1)
    v_params = random_vae_params(jv, seed=2)
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("axes_stage")
    make_text_alpha_tree(root / "data", n=4)
    one_cfg = lora_cfg(root, max_train_steps=1, grad_accum_steps=1, ckpt_every_steps=1000,
                       ckpt_dir=str(root / "one"))
    one_cfg["data"].update(batch_size=2, num_workers=0)
    payload = {
        "config": _port_config(jcfg), "vae_config": tv,
        "state": tfw.params_from_flax(params), "vae_state": tw.params_from_flax(v_params),
        "prompt": rng.standard_normal((1, 4, jcfg.joint_attention_dim)).astype(np.float32),
        "pooled": rng.standard_normal((1, jcfg.pooled_projection_dim)).astype(np.float32),
        "text_ids": np.zeros((4, 3), np.float32),
        "gt": rng.uniform(size=(1, 32, 32, 4)).astype(np.float32),
        "eps": rng.standard_normal((1, 16, 16, 4)).astype(np.float32),
        "init": rng.standard_normal((1, 16, 16, 4)).astype(np.float32),
        "noises": rng.standard_normal((2, 1, 16, 16, 4)).astype(np.float32),
        "latents": [rng.standard_normal((2, 16, 16, 4)).astype(np.float32) for _ in range(3)],
        "u": np.array([0.3, 0.7], np.float32),
        "lr": LR, "seed": 5,
        "batches": [tuple(rng.uniform(size=(4, 32, 32, 4)).astype(np.float32) for _ in range(2))
                    for _ in range(STEPS)],
        "attention": _attention_cases(rng),
        "min_size": MIN_SIZE,
        "stage": {**one_cfg, "training": {**one_cfg["training"], "shard_base_params": True,
                                          "ckpt_dir": str(root / "fsdp")}},
        "stage_sp": {**one_cfg, "training": {**one_cfg["training"], "shard_base_params": True,
                                             "sequence_parallel": SP, "ckpt_dir": str(root / "sp")}},
    }
    return {"jcfg": jcfg, "jv": jv, "params": params, "v_params": v_params, "payload": payload,
            "one_cfg": one_cfg}


def _jax_runs(setup) -> dict:
    """JAX's seq-sharded attention on each case of one stream, and its SP
    model's LoRA loss and gradients, on a ("data" 1, "sp" 2) mesh."""
    p = setup["payload"]
    mesh = JaxMesh(np.array(jax.devices()[:SP]).reshape(1, SP), ("data", "sp"))
    case = p["attention"]["one stream"]
    q, k, v, g = (jnp.asarray(case[n]) for n in ("q", "k", "v", "g"))
    out, vjp = jax.vjp(lambda q_, k_, v_: jattention(q_, k_, v_, force_xla=True, mesh=mesh), q, k, v)
    attention = {"out": np.asarray(out), **dict(zip(("dq", "dk", "dv"), (np.asarray(t) for t in vjp(g))))}
    jm = JaxModel(
        transformer_config=setup["jcfg"], vae=JaxRgbaVAE(config=setup["jv"]), scheduler=JaxScheduler(),
        prompt_embeds=jnp.asarray(p["prompt"]), pooled_prompt_embeds=jnp.asarray(p["pooled"]),
        text_ids=jnp.asarray(p["text_ids"]), lora_rank=RANK, lora_alpha=ALPHA, remat=False,
        attention_mesh=mesh)
    base, lora = split_lora_params(setup["params"])

    def loss_fn(lora_tree):
        return jm.compute_loss_from_latents(merge_params(base, lora_tree),
                                            *(jnp.asarray(a) for a in p["latents"]), jnp.asarray(p["u"]))[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(lora)
    return {"attention": attention, "lora": {"loss": float(loss), "grads": jax.device_get(grads)}}


@pytest.fixture(scope="module")
def world2(setup, tmp_path_factory):
    payload = setup["payload"]
    _write_checkpoints(setup, tmp_path_factory.mktemp("axes_checkpoints"))

    def one_process():
        return {"attention": sp_attention(payload, Mesh()), "sp": sp_case(payload, Mesh()),
                "loads": tp_loads(payload, Mesh()), "stage": axes_stage(setup["one_cfg"]),
                "jax": _jax_runs(setup)}

    ranks, one = spawn("axes_world2", 2, tmp_path_factory.mktemp("axes2"), payload, meanwhile=one_process)
    return {"ranks": ranks, "one": one}


def _part(t, rank, segments=None, dim=2):
    """Rank `rank`'s tokens of `t`: its 1/2 of each stream, end to end."""
    t = torch.from_numpy(np.array(t))
    parts, start = [], 0
    for n in segments or (t.shape[dim],):
        per = n // SP
        parts.append(t.narrow(dim, start + rank * per, per))
        start += n
    return torch.cat(parts, dim=dim)


# ---------------------------------------------------------------------------
# (a) attention over the sequence axis
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case,against", [("one stream", "one process"), ("one stream", "jax"),
                                          ("two streams", "one process")])
def test_seq_sharded_attention_matches(world2, case, against):
    """q stays local, k and v are gathered (back into the unsharded order
    over two streams) and their gradients summed over the ranks."""
    want = world2["one"]["attention"][case] if against == "one process" else world2["one"]["jax"]["attention"]
    segs = (4, 12) if case == "two streams" else None
    for rank, got in enumerate(world2["ranks"]):
        got = got["attention"][case]
        np.testing.assert_allclose(got["out"], _part(want["out"], rank, segs), rtol=ATTN_TOL, atol=ATTN_TOL)
        for key in ("dq", "dk", "dv"):
            np.testing.assert_allclose(got[key], _part(want[key], rank, segs), rtol=ATTN_GRAD_RTOL,
                                       atol=ATTN_GRAD_ATOL, err_msg=key)


def test_a_stream_sp_does_not_divide_runs_unsharded(world2):
    """A prompt of 3 tokens: no gather, every rank computes the whole loss
    and gradients, which the stage's step then does not sum over the group
    (JAX's fallback)."""
    want = world2["one"]["sp"]["odd"]
    for got in world2["ranks"]:
        odd = got["sp"]["odd"]
        assert odd["counts"] == {"all_gather": 0, "reduce_scatter": 0}
        assert odd["loss"] == want["loss"]
        for path, leaf in jax.tree_util.tree_leaves_with_path(want["grads"]):
            np.testing.assert_array_equal(dict(jax.tree_util.tree_leaves_with_path(odd["grads"]))[path], leaf)
        assert got["sp"]["odd_step"] == world2["one"]["sp"]["odd_step"]


# ---------------------------------------------------------------------------
# (b) the LoRA loss and gradients at sp 2
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("against", ["one process", "jax"])
def test_sp2_lora_loss_and_gradients_match(world2, against):
    if against == "one process":
        want, loss_tol, rtol, atol = world2["one"]["sp"]["lora"], ONE_LOSS_RTOL, ONE_GRAD_RTOL, ONE_GRAD_ATOL
    else:
        want, loss_tol, rtol, atol = world2["one"]["jax"]["lora"], JAX_LOSS_TOL, JAX_GRAD_RTOL, JAX_GRAD_ATOL
    for rank in world2["ranks"]:
        got = rank["sp"]["lora"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_tol)
        flat_got = dict(jax.tree_util.tree_leaves_with_path(got["grads"]))
        flat_want = jax.tree_util.tree_leaves_with_path(want["grads"])
        assert len(flat_got) == len(flat_want)
        for path, leaf in flat_want:
            np.testing.assert_allclose(flat_got[path], np.asarray(leaf), rtol=rtol, atol=atol,
                                       err_msg=jax.tree_util.keystr(path))
    # the summed partials are the same bits on both ranks
    a, b = (dict(jax.tree_util.tree_leaves_with_path(r["sp"]["lora"]["grads"])) for r in world2["ranks"])
    for path, leaf in a.items():
        np.testing.assert_array_equal(leaf, b[path])


# ---------------------------------------------------------------------------
# (c) the sample at sp 2, and the collectives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["sample", "bf16", "int8"])
def test_sp2_sample_matches_one_process(world2, kind):
    want = world2["one"]["sp"][kind]
    tol = ONE_SAMPLE_TOL[kind]
    for rank in world2["ranks"]:
        got = rank["sp"][kind]
        for key in ("traj", "image"):
            np.testing.assert_allclose(got[key].float(), want[key].float(), rtol=tol, atol=tol, err_msg=key)
    a, b = (r["sp"][kind] for r in world2["ranks"])
    assert torch.equal(a["traj"], b["traj"]) and torch.equal(a["image"], b["image"])


def test_sp2_collectives_per_forward_and_backward(world2, setup):
    """A forward gathers k and v in each of the 2 + 2 blocks and the
    prediction once; the backward recomputes each block (gathering again)
    and reduce-scatters dK and dV; a 2-step sample makes two forwards."""
    cfg = setup["jcfg"]
    blocks = cfg.num_layers + cfg.num_single_layers
    fwd = 2 * blocks + 1
    for rank in world2["ranks"]:
        assert rank["sp"]["lora"]["counts"] == {"all_gather": fwd + 2 * blocks, "reduce_scatter": 2 * blocks}
        for kind in ("sample", "bf16", "int8"):
            assert rank["sp"][kind]["counts"] == {"all_gather": 2 * fwd, "reduce_scatter": 0}
    assert world2["one"]["sp"]["lora"]["counts"] == {"all_gather": 0, "reduce_scatter": 0}


# ---------------------------------------------------------------------------
# (d) FSDP at data 2
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("base", ["bf16", "int8"])
def test_fsdp_loss_and_gradients_equal_the_whole_base_bit_for_bit(world2, base):
    for rank in world2["ranks"]:
        runs = rank["fsdp"][base]
        assert torch.equal(runs["fsdp"]["loss"], runs["whole"]["loss"])
        assert runs["fsdp"]["grads"].keys() == runs["whole"]["grads"].keys()
        for k, g in runs["whole"]["grads"].items():
            assert torch.equal(runs["fsdp"]["grads"][k], g), k
        # one all-gather a dtype of each unit that holds split leaves, again in each recompute
        assert runs["fsdp"]["counts"]["all_gather"] > 0 and runs["whole"]["counts"]["all_gather"] == 0


@pytest.mark.parametrize("base", ["bf16", "int8"])
def test_fsdp_rank_holds_half_the_split_base(world2, base):
    """A rank's base bytes: at most half of the whole plus the leaves the
    rule keeps whole (exactly half of the split ones, as every split dim
    divides by 2); the adapters are whole."""
    for rank in world2["ranks"]:
        whole, split = rank["fsdp"][base]["whole"]["bytes"], rank["fsdp"][base]["fsdp"]["bytes"]
        total = whole["split"] + whole["whole"]
        assert whole["split"] == 0 and split["split"] > 0
        assert split["split"] + split["whole"] <= total / 2 + split["whole"]
        assert 2 * split["split"] == total - split["whole"]
        assert split["adapters"] == whole["adapters"]


@pytest.mark.parametrize("label", ["diffusers", "int8 at load", "quantised"])
def test_from_pretrained_keeps_each_rank_s_fsdp_part(world2, setup, label):
    """`from_pretrained(fsdp=)` holds exactly the rank's parts of what the
    one-process `from_pretrained` holds, bit for bit: a diffusers checkpoint
    cut as it is read, a plain one quantised at load part by part (the
    scale of each whole column), and a quantised one."""
    want = world2["one"]["loads"][label]
    quant = "none" if label == "diffusers" else "int8"
    for rank, got in enumerate(world2["ranks"]):
        meta = FluxTransformer2D(setup["payload"]["config"], weight_quant=quant, device="meta")
        plan = tfsdp.shard_base_(meta, Mesh(2, rank), min_size=MIN_SIZE).fsdp
        got = got["loads"][label]
        assert set(got) == set(want)
        assert any(plan.split_of(k) is not None for k in got)
        for key, value in got.items():
            part = plan.take(key, want[key])
            assert value.dtype == part.dtype and torch.equal(value, part), (label, key)


def test_lora_stage_with_shard_base_params_at_world2_matches_world1(world2):
    """`train_from_config` with `shard_base_params` over a data axis of 2:
    the base split (each rank holds part of it), the loss within JAX's 1e-3
    of the one-process run, the adapters as AdamW moves them there."""
    want = world2["one"]["stage"]
    assert want["bytes"]["split"] == 0
    for rank in world2["ranks"]:
        got = rank["stage"]
        assert got["bytes"]["split"] > 0 and got["seq_counts"]["all_gather"] == 0
        assert abs(got["result"]["train/loss"] - want["result"]["train/loss"]) < STAGE_LOSS_TOL
        assert got["result"]["global_step"] == want["result"]["global_step"] == 1.0
        assert_close_after_adamw(got["adapters"], want["adapters"], "stage adapters", lr=1e-3)


# ---------------------------------------------------------------------------
# (e) the world-4 spawn: (data 2, sequence 2) with FSDP and (model 2, sequence 2)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world4(setup, tmp_path_factory):
    payload = setup["payload"]
    ranks, one = spawn("axes_world4", 4, tmp_path_factory.mktemp("axes4"), payload,
                       meanwhile=lambda: tp_train_steps(0, 1, payload, None, tp=1))
    return {"ranks": ranks, "one": one}


@pytest.mark.parametrize("layout", ["dp2_sp2_fsdp", "tp2_sp2"])
@pytest.mark.parametrize("step", range(STEPS))
def test_composed_axes_steps_match_one_process(world4, layout, step):
    want = world4["one"]["steps"][step]
    for rank in world4["ranks"]:
        got = rank[layout]["steps"][step]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
        assert_close_after_adamw(got["adapters"], want["adapters"], f"{layout} adapters after step {step}", lr=LR)
    first = world4["ranks"][0][layout]["steps"][step]["adapters"]
    for other in world4["ranks"][1:]:
        for k, v in first.items():
            assert torch.equal(v, other[layout]["steps"][step]["adapters"][k]), (layout, step, k)


def test_lora_stage_at_dp2_sp2_with_fsdp_matches_world1(world4, world2):
    """`train_from_config` with `sequence_parallel: 2` and
    `shard_base_params` over a world of 4: the rows and the noise go by data
    rank, the base is split over the data group, the streams over the
    sequence group; within JAX's 1e-3 of the one-process run."""
    want = world2["one"]["stage"]
    for rank in world4["ranks"]:
        got = rank["stage"]
        assert got["bytes"]["split"] > 0 and got["seq_counts"]["all_gather"] > 0
        assert abs(got["result"]["train/loss"] - want["result"]["train/loss"]) < STAGE_LOSS_TOL
        assert got["result"]["global_step"] == want["result"]["global_step"] == 1.0
        assert_close_after_adamw(got["adapters"], want["adapters"], "stage adapters", lr=1e-3)
        for k, v in got["adapters"].items():
            assert torch.equal(v, world4["ranks"][0]["stage"]["adapters"][k]), k
