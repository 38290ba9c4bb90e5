"""Backward of the port's whole-resnet-block Functions (K6, K7 wiring)
against the JAX Pallas backward kernels run in interpret mode, and against
native autograd through the plain forward.

On the CPU the port's `autograd.Function`s take the plain backwards
(`conv3x3_stats_bwd_plain`, `upsample_conv3x3_stats_bwd_plain`), so these
tests hold the wiring the card shares with them: saved tensors, `None`
operands, the statistics cotangent. Both sides run in fp32 on the same numpy
inputs with a non-zero cotangent for y and for the statistics. The JAX kernel
rounds nothing in fp32 either, so only the order of the sums differs: sums of
up to 9*128 products per dx element and 2*8*128 per dW element, hence 2e-3
(the bound the JAX package's own kernel-vs-XLA tests use).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ragb_vae_tpu.ops.pallas.resnet_block as jrb
from ragb_vae_tpu_torch.ops.kernels import resnet_block as trb

TOL = 2e-3
NAMES = ("dx", "da", "db", "dw", "dbias", "dskip", "dws", "dwsb")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: tiny tensors gain
    nothing from intra-op threads, and the workers stop fighting for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _interpret():
    jrb.INTERPRET = True
    yield
    jrb.INTERPRET = False


@pytest.fixture
def pallas_calls(monkeypatch):
    """Counts the calls that reach the Pallas backward kernels, so a test
    knows the JAX side did not take its XLA route."""
    calls = {"chain": 0, "subpixel": 0}

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(jrb, "_chain_bwd_impl", counted("chain", jrb._chain_bwd_impl))
    monkeypatch.setattr(jrb, "_subpixel_bwd_impl", counted("subpixel", jrb._subpixel_bwd_impl))
    monkeypatch.setattr(jrb, "SUBPIXEL_BWD_MIN_PIXELS", 0)
    return calls


def _t(a, grad=False):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.requires_grad_(True) if grad else t


def _chain_case(skip, seed=0, bsz=2, h=8, w=128, c=128, n=128):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, shift=0.0: (rng.standard_normal(s) * scale + shift).astype(np.float32)
    ops = {
        "x": f(bsz, h, w, c), "a": f(bsz, c, scale=0.5, shift=1.0), "b": f(bsz, c, scale=0.2),
        "w": f(3, 3, c, n, scale=0.05), "bias": f(n, scale=0.1), "skip": None, "ws": None, "wsb": None,
    }
    if skip == "identity":
        ops["skip"] = f(bsz, h, w, n)
    elif skip == "proj":
        ops.update(skip=f(bsz, h, w, c), ws=f(c, n, scale=0.05), wsb=f(n, scale=0.1))
    return ops, f(bsz, h, w, n), f(bsz, 2, n, scale=0.01)


def _jax_chain_grads(ops, gy, gstats, activation):
    present = [k for k, v in ops.items() if v is not None]

    def fn(*args):
        o = dict(zip(present, args))
        proj = (o["ws"], o["wsb"]) if "ws" in o else None
        return jrb.gn_silu_conv3x3_stats(o["x"], o["a"], o["b"], o["w"], o["bias"], o.get("skip"),
                                         proj=proj, activation=activation)

    _, vjp = jax.vjp(fn, *(jnp.asarray(ops[k]) for k in present))
    return dict(zip(present, vjp((jnp.asarray(gy), jnp.asarray(gstats)))))


def _port_chain_grads(ops, gy, gstats, activation):
    leaves = {k: None if v is None else _t(v, grad=True) for k, v in ops.items()}
    proj = None if leaves["ws"] is None else (leaves["ws"], leaves["wsb"])
    y, stats = trb.gn_silu_conv3x3_stats(leaves["x"], leaves["a"], leaves["b"], leaves["w"], leaves["bias"],
                                         leaves["skip"], proj=proj, activation=activation)
    assert y.grad_fn is not None and stats.grad_fn is not None
    present = [k for k, v in leaves.items() if v is not None]
    grads = torch.autograd.grad([y, stats], [leaves[k] for k in present], [_t(gy), _t(gstats)])
    return dict(zip(present, grads))


@pytest.mark.parametrize("activation", ["silu", "identity"])
@pytest.mark.parametrize("skip", ["none", "identity", "proj"])
def test_conv_function_backward_matches_pallas_kernel(skip, activation, pallas_calls):
    ops, gy, gstats = _chain_case(skip)
    want = _jax_chain_grads(ops, gy, gstats, activation)
    assert pallas_calls["chain"] == 1, "the JAX side did not run its backward kernel"
    got = _port_chain_grads(ops, gy, gstats, activation)
    assert trb.CONV_BWD_LAUNCHES == 0  # a CPU tensor never reaches the CUDA kernel
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("activation", ["silu", "identity"])
@pytest.mark.parametrize("skip", ["none", "identity", "proj"])
def test_conv_function_backward_matches_native_autograd(skip, activation):
    """The Function (plain backward, explicit cotangents) against PyTorch's
    own autograd through the plain forward; small ragged shape. Same
    arithmetic in the same order: 1e-5."""
    ops, gy, gstats = _chain_case(skip, seed=1, bsz=2, h=5, w=7, c=16, n=24)
    got = _port_chain_grads(ops, gy, gstats, activation)
    leaves = {k: None if v is None else _t(v, grad=True) for k, v in ops.items()}
    y, stats = trb.conv3x3_stats_plain(*leaves.values(), activation)
    present = [k for k, v in leaves.items() if v is not None]
    want = torch.autograd.grad([y, stats], [leaves[k] for k in present], [_t(gy), _t(gstats)])
    for name, w_ in zip(present, want):
        np.testing.assert_allclose(got[name].numpy(), w_.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


def test_conv_bwd_plain_returns_none_for_absent_operands():
    ops, gy, gstats = _chain_case("none", seed=2, bsz=1, h=4, w=4, c=8, n=8)
    args = [None if v is None else _t(v) for v in ops.values()]
    y, _ = trb.conv3x3_stats_plain(*args, "silu")
    grads = trb.conv3x3_stats_bwd_plain(*args, y, _t(gy), _t(gstats), "silu")
    assert len(grads) == len(NAMES)
    assert [g is None for g in grads] == [False] * 5 + [True] * 3


def test_conv_function_handles_a_missing_stats_cotangent():
    """The last kernel of a chain: nothing reads its statistics, so autograd
    hands the backward no cotangent for them."""
    ops, gy, _ = _chain_case("identity", seed=3, bsz=1, h=4, w=6, c=8, n=8)
    x, skip = _t(ops["x"], grad=True), _t(ops["skip"], grad=True)
    y, _ = trb.gn_silu_conv3x3_stats(x, _t(ops["a"]), _t(ops["b"]), _t(ops["w"]), _t(ops["bias"]), skip)
    dx, dskip = torch.autograd.grad(y, [x, skip], _t(gy))
    np.testing.assert_allclose(dskip.numpy(), gy, rtol=1e-6, atol=1e-6)
    assert dx.shape == x.shape and bool(torch.isfinite(dx).all())


def test_weight_cotangent_keeps_the_parameter_dtype():
    """An fp64 weight under an fp32 activation receives an fp64 cotangent
    (on the card: an fp32 parameter under bf16 compute keeps fp32)."""
    ops, gy, gstats = _chain_case("none", seed=4, bsz=1, h=4, w=4, c=8, n=8)
    w = _t(ops["w"]).double().requires_grad_(True)
    y, stats = trb.gn_silu_conv3x3_stats(_t(ops["x"]), _t(ops["a"]), _t(ops["b"]), w, _t(ops["bias"]))
    (dw,) = torch.autograd.grad([y, stats], [w], [_t(gy), _t(gstats)])
    assert dw.dtype == torch.float64 and y.dtype == torch.float32


def _upsample_case(seed, bsz=2, h=8, w=128, c=128, n=128):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    return (f(bsz, h, w, c), f(3, 3, c, n, scale=0.05), f(n, scale=0.1),
            f(bsz, 2 * h, 2 * w, n), f(bsz, 2, n, scale=0.01))


def _port_upsample_grads(x, w, bias, gy, gstats):
    leaves = [_t(v, grad=True) for v in (x, w, bias)]
    y, stats = trb.fused_upsample_conv3x3_stats(*leaves)
    assert y.grad_fn is not None
    return torch.autograd.grad([y, stats], leaves, [_t(gy), _t(gstats)])


def test_upsample_function_backward_matches_pallas_kernel(pallas_calls):
    x, w, bias, gy, gstats = _upsample_case(5)
    _, vjp = jax.vjp(jrb.fused_upsample_conv3x3_stats, jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    want = vjp((jnp.asarray(gy), jnp.asarray(gstats)))
    assert pallas_calls["subpixel"] == 1, "the JAX side did not run its backward kernel"
    got = _port_upsample_grads(x, w, bias, gy, gstats)
    assert trb.UPSAMPLE_BWD_LAUNCHES == 0
    for name, g, r in zip(("dx", "dw", "dbias"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=TOL, atol=TOL, err_msg=name)


def test_upsample_function_backward_matches_native_autograd():
    x, w, bias, gy, gstats = _upsample_case(6, bsz=2, h=5, w=7, c=8, n=16)
    got = _port_upsample_grads(x, w, bias, gy, gstats)
    leaves = [_t(v, grad=True) for v in (x, w, bias)]
    y, stats = trb.upsample_conv3x3_stats_plain(*leaves)
    want = torch.autograd.grad([y, stats], leaves, [_t(gy), _t(gstats)])
    for name, g, r in zip(("dx", "dw", "dbias"), got, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


def test_subpixel_backward_restated_in_torch_matches_literal_gradient():
    """Restates, in torch, what the K7 kernels compute (dx as a stride-2
    conv4x4 of dye over `fold_subpixel_bwd_weights`; the folded weights'
    gradient tap by tap, unfolded by `unfold_subpixel_weight_grad`) and holds
    it against autograd through the literal nearest-2x + conv3x3. fp32: 1e-4
    covers the re-associated sums."""
    import torch.nn.functional as F

    x, w, bias, gy, gstats = (_t(v) for v in _upsample_case(7, bsz=2, h=5, w=6, c=8, n=4))
    y, _ = trb.upsample_conv3x3_stats_plain(x, w, bias)
    want = trb.upsample_conv3x3_stats_bwd_plain(x, w, bias, y, gy, gstats)
    dye = gy + gstats[:, 0, None, None, :] + 2.0 * y * gstats[:, 1, None, None, :]
    wb = trb.fold_subpixel_bwd_weights(w)                                   # (4, 4, N, C)
    dx = F.conv2d(dye.permute(0, 3, 1, 2), wb.permute(3, 2, 0, 1), stride=2, padding=1).permute(0, 2, 3, 1)
    _, h, wd, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    outer = lambda lhs, rhs: lhs.reshape(-1, lhs.shape[-1]).t() @ rhs.reshape(-1, rhs.shape[-1])
    dw_fold = torch.stack([torch.stack([torch.stack([
        torch.cat([outer(xp[:, pa + u : pa + u + h, pb + v : pb + v + wd], dye[:, pa::2, pb::2])
                   for v in range(2)])
        for u in range(2)]) for pb in range(2)]) for pa in range(2)])
    got = (dx, trb.unfold_subpixel_weight_grad(dw_fold), dye.sum(dim=(0, 1, 2)))
    for name, g, r in zip(("dx", "dw", "dbias"), got, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4, atol=1e-4, err_msg=name)


def test_fold_subpixel_bwd_weights_matches_jax():
    w = np.random.default_rng(8).standard_normal((3, 3, 8, 12)).astype(np.float32)
    want = np.asarray(jrb._fold_subpixel_bwd_weights(jnp.asarray(w)))       # (4, 4N, C)
    got = trb.fold_subpixel_bwd_weights(_t(w)).numpy()                      # (4, 4, N, C)
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=1e-6, atol=1e-6)


def test_fused_block_chain_gradients_match_jax():
    """Two chained blocks (the second's GroupNorm reads the first's epilogue
    statistics, so a non-zero statistics cotangent flows inside the chain):
    gradients of a scalar loss with respect to the input and every weight."""
    from test_torch_resnet_block import _block_params, _to_jax, _to_port

    x = np.random.default_rng(9).standard_normal((1, 8, 128, 128)).astype(np.float32)
    p1, p2 = _block_params(128, 128, seed=10), _block_params(128, 128, seed=11)

    def jax_loss(x_, q1, q2):
        y, s = jrb.fused_resnet_block(x_, q1, num_groups=32)
        y, s = jrb.fused_resnet_block(y, q2, num_groups=32, stats=s)
        return jnp.mean(y * y) + 1e-3 * jnp.mean(s)

    gx_j, g1_j, g2_j = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(x), _to_jax(p1), _to_jax(p2))

    def leaves(p):
        return {k: {kk: vv.requires_grad_(True) for kk, vv in v.items()} for k, v in _to_port(p).items()}

    xt, q1, q2 = _t(x, grad=True), leaves(p1), leaves(p2)
    y, s = trb.fused_resnet_block(xt, q1, num_groups=32)
    y, s = trb.fused_resnet_block(y, q2, num_groups=32, stats=s)
    (torch.mean(y * y) + 1e-3 * torch.mean(s)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=TOL, atol=1e-5)
    for got, want in ((q1, g1_j), (q2, g2_j)):
        for mod, entry in got.items():
            for name, leaf in entry.items():
                np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want[mod][name]).reshape(leaf.shape),
                                           rtol=TOL, atol=1e-5, err_msg=f"{mod}.{name}")
