"""The port's weight-only int8 matmul against the JAX package's.

On the CPU the port's `int8_matmul` takes its plain version
(`int8_matmul_plain`, the counterpart of `_xla_epilogue`); it is held against
the Pallas kernel in interpret mode and against `_xla_epilogue` itself on the
same numpy inputs. Both sides contract x with the exactly cast integers and
apply scale and bias once in fp32, so they differ by summation order only:
1e-4 in fp32; in bf16 the one output rounding (2^-8 relative) may fall the
other way, 2e-2 as the JAX package's own test. Gradients (x, scale, bias)
against `jax.grad` of the JAX entry point: 1e-4.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragb_vae_tpu_torch.ops.kernels import int8_matmul as tim

jim = importlib.import_module("ragb_vae_tpu.ops.pallas.int8_matmul")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one machine: tiny tensors gain
    nothing from intra-op threads, and the workers stop fighting for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _interpret_mode():
    jim.INTERPRET = True
    jim.enable(True)
    yield
    jim.INTERPRET = False
    jim.enable(False)


def _mk(seed, lead, k, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, k)).astype(np.float32)
    q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = (rng.random((n,)) * 0.02 + 1e-3).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32)
    return x, q, s, b


def _nk(q):
    """JAX's (K, N) `kernel_q` as the port's `weight_q` (N, K)."""
    return torch.from_numpy(q.T.copy())


def _port(x, q, s, b, dtype):
    out = tim.int8_matmul(torch.from_numpy(x).to(dtype), _nk(q), torch.from_numpy(s),
                          None if b is None else torch.from_numpy(b))
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("m,k,n", [(128, 128, 256), (256, 384, 512), (512, 256, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_pallas_kernel_and_xla_epilogue(m, k, n, dtype):
    x, q, s, b = _mk(0, (m,), k, n)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x, jdt)
    kernel = np.asarray(jim.int8_matmul(jx, jnp.asarray(q), jnp.asarray(s), jnp.asarray(b)), np.float32)
    epilogue = np.asarray(jim._xla_epilogue(jx, jnp.asarray(q), jnp.asarray(s), jnp.asarray(b)), np.float32)
    got = _port(x, q, s, b, tdt)
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, kernel, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, epilogue, rtol=tol, atol=tol)


def test_leading_dims_and_no_bias():
    x, q, s, _ = _mk(2, (2, 128), 128, 256)
    want = np.asarray(jim.int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s)))
    got = _port(x, q, s, None, torch.float32)
    assert got.shape == (2, 128, 256)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_a_shape_jax_sends_to_its_fallback():
    """m = 100 tiles nowhere: the JAX entry takes its XLA path, the port has
    one path for every shape."""
    x, q, s, b = _mk(3, (100,), 96, 80)
    want = np.asarray(jim.int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jnp.asarray(b)))
    np.testing.assert_allclose(_port(x, q, s, b, torch.float32), want, rtol=1e-4, atol=1e-4)
    dequant = x @ (q.astype(np.float32) * s[None, :]) + b[None, :]
    np.testing.assert_allclose(_port(x, q, s, b, torch.float32), dequant, rtol=1e-4, atol=1e-4)


def test_weight_is_one_row_per_output_channel():
    """`weight_q` is (N, K), the modules' own layout; JAX's (K, N) is refused
    where the two differ."""
    x, q, s, b = _mk(4, (5,), 32, 16)
    tx, ts, tb = torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b)
    got = tim.int8_matmul(tx, _nk(q), ts, tb)
    np.testing.assert_allclose(got.numpy(), (x @ q.astype(np.float32)) * s + b, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match=r"must be \(N, K\) with K = 32"):
        tim.int8_matmul(tx, torch.from_numpy(q), ts, tb)


def test_gradients_match_jax():
    x, q, s, b = _mk(5, (128,), 128, 256)

    def loss(x, s, b):
        return jnp.sum(jim.int8_matmul(x, jnp.asarray(q), s, b) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    tx, ts, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, s, b))
    tim.int8_matmul(tx, _nk(q), ts, tb).square().sum().backward()
    for got, ref, name in zip((tx.grad, ts.grad, tb.grad), want, ("dx", "dscale", "dbias")):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max(), err_msg=name)


def test_frozen_base_keeps_no_activation_and_returns_only_dx():
    """Under QLoRA scale and bias are buffers: the backward computes dx alone
    and the forward does not hold x for it."""
    x, q, s, b = _mk(6, (2, 3), 32, 16)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tim.int8_matmul(tx, _nk(q), torch.from_numpy(s), torch.from_numpy(b))
    saved = out.grad_fn.saved_tensors
    assert saved[0] is None and saved[1].dtype == torch.int8
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(out.shape).astype(np.float32))
    out.backward(g)
    want = (g.numpy() * s) @ q.astype(np.float32).T
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=1e-5, atol=1e-5)


def test_plain_never_counts_as_a_launch():
    tim.reset_launch_counts()
    x, q, s, b = _mk(8, (4,), 16, 8)
    _port(x, q, s, b, torch.float32)
    assert tim.LAUNCHES == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """The launch wrapper checks before it touches the library, so the
    refusals can be pinned without a card."""
    x = torch.zeros((4, 32), dtype=torch.float16 if bad == "dtype" else torch.bfloat16)
    wq = torch.zeros((16, 24 if bad == "shape" else 32), dtype=torch.int8)
    match = {"dtype": "bfloat16 or float32", "shape": "does not end in K", "device": "must be a CUDA tensor"}[bad]
    with pytest.raises(ValueError, match=match):
        tim.int8_matmul_cuda(x, wq, torch.ones(16), None)
    with pytest.raises(ValueError, match="multiple of 16"):
        tim.int8_matmul_cuda(torch.zeros((4, 24), dtype=torch.bfloat16), torch.zeros((16, 24), dtype=torch.int8),
                             torch.ones(16), None)
