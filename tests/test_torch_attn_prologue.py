"""The attention prologue (K13, `ops/kernels/attn_prologue.py`): its plain
version and autograd on the CPU, the kernel against them on the card.

CPU: the plain twin equals the model's former chain of ops bit for bit
(restated here as it stood), joint and single stream, bf16 and fp32; the
hand-written backward passes `gradcheck` in float64 and meets autograd
through the plain chain in fp32; the tiny transformer's forward is unchanged
bit for bit and its LoRA gradients to fp32 rounding.

Card (marked `cuda`, skipped without one; no JAX here, so run with
`--noconftest`):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_attn_prologue.py

Forward: the kernel sums the mean square in another order and rounds
everything else where the plain chain rounds, so most elements are equal;
where the two rstd differ by an fp32 ulp, the normed pair's bf16 rounding
can flip, and RoPE, which turns the pair without changing its length, moves
its elements by up to an ulp of that length. So every element lies within
one bf16 ulp of the plain twin at the scale of its rotated pair, at most two
when both elements flip, which is asserted; the shares that differ at all
and beyond one ulp of the element itself are printed. v is equal.
Backward: against autograd through the plain chain in fp32 from the same
bf16 inputs; the kernel's arithmetic is that fp32 arithmetic with its sums
in another order, rounded once to bf16, so each entry within 2^-8 of its
own size plus 1e-4 of the largest (the RMSNorm backward's r gn - coef x
cancels, and fp32 keeps about 1e-7 of the terms), and the weights' fp32 sums over every row, rounded to bf16, within
2^-8 of their own size plus 1e-3 of the largest.
"""
import pytest
import torch

from ragb_vae_tpu_torch.models import flux_transformer as FT
from ragb_vae_tpu_torch.ops.kernels import attn_prologue as AP
from ragb_vae_tpu_torch.utils.profiling import counters


# ---------------------------------------------------------------------------
# the model's former chain, as it stood before the kernel
# ---------------------------------------------------------------------------
def _old_rms_norm(x, weight, eps=1e-6):
    xf = x.float()
    normed = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (normed * weight.float()).to(x.dtype)


def _old_rope(x, cos, sin):
    xf = x.float()
    pairs = xf.reshape(*x.shape[:-1], -1, 2)
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(xf.shape)
    return (xf * cos + rot * sin).to(x.dtype)


def _old_split(x, heads):
    b, s, _ = x.shape
    return x.reshape(b, s, heads, -1).transpose(1, 2)


def _old_joint(img, txt, w, rope, heads):
    q = _old_rms_norm(_old_split(img[0], heads), w[0])
    k = _old_rms_norm(_old_split(img[1], heads), w[1])
    v = _old_split(img[2], heads)
    tq = _old_rms_norm(_old_split(txt[0], heads), w[2])
    tk = _old_rms_norm(_old_split(txt[1], heads), w[3])
    tv = _old_split(txt[2], heads)
    cos, sin = rope
    return (_old_rope(torch.cat([tq, q], dim=2), cos, sin), _old_rope(torch.cat([tk, k], dim=2), cos, sin),
            torch.cat([tv, v], dim=2))


def _old_single(x, w, rope, heads):
    cos, sin = rope
    return (_old_rope(_old_rms_norm(_old_split(x[0], heads), w[0]), cos, sin),
            _old_rope(_old_rms_norm(_old_split(x[1], heads), w[1]), cos, sin), _old_split(x[2], heads))


def _inputs(b, s_img, s_txt, heads, d, dtype, device="cpu", seed=0, w_dtype=None):
    """Projection outputs at the scale the model gives them, norm weights
    near 1 and the model's own RoPE tables."""
    gen = torch.Generator(device).manual_seed(seed)

    def draw(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=device) * scale + shift).to(w_dtype or dtype)

    img = [draw(b, s_img, heads * d, scale=2.0).to(dtype) for _ in range(3)]
    txt = [draw(b, s_txt, heads * d, scale=2.0).to(dtype) for _ in range(3)] if s_txt else None
    w = [draw(d, scale=0.1, shift=1.0) for _ in range(4)]
    ids = torch.randint(0, 64, (s_txt + s_img, 3), generator=gen, device=device)
    axes = (d // 8, d * 7 // 16 // 2 * 2)
    axes = (d - 2 * axes[1], axes[1], axes[1])
    rope = FT.rope_frequencies(ids, axes)
    return img, txt, w, rope


def _apply(img, txt, w, rope, heads):
    return AP.attn_prologue(img, w[:2], rope, heads=heads, eps=1e-6, txt=txt,
                            txt_weights=None if txt is None else w[2:])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s_txt", [0, 4], ids=["single", "joint"])
def test_plain_twin_equals_the_former_chain(dtype, s_txt):
    img, txt, w, rope = _inputs(2, 8, s_txt, 2, 32, dtype)
    got = _apply(img, txt, w, rope, 2)
    want = _old_single(img, w, rope, 2) if txt is None else _old_joint(img, txt, w, rope, 2)
    for g, ref in zip(got, want):
        assert g.dtype == dtype and g.is_contiguous()
        assert torch.equal(g, ref)


def test_module_wrappers_keep_their_arithmetic():
    img, _, w, (cos, sin) = _inputs(1, 6, 0, 2, 32, torch.bfloat16)
    norm = FT.RMSNorm(32, dtype=torch.bfloat16)
    with torch.no_grad():
        norm.weight.copy_(w[0])
    x = _old_split(img[0], 2)
    assert torch.equal(norm(x), _old_rms_norm(x, w[0]))
    assert torch.equal(FT.apply_rotary_emb(x, cos, sin), _old_rope(x, cos, sin))


@pytest.mark.parametrize("s_txt", [0, 3], ids=["single", "joint"])
def test_gradcheck_of_the_plain_route(s_txt):
    img, txt, w, rope = _inputs(1, 5, s_txt, 2, 8, torch.float64)
    rope = tuple(t.double() for t in rope)
    leaves = [t.requires_grad_() for t in img + (txt or []) + w[:2 if txt is None else 4]]
    n_img = 3

    def fn(*ts):
        t_img, rest = list(ts[:n_img]), ts[n_img:]
        t_txt, ws = (None, rest) if txt is None else (list(rest[:3]), rest[3:])
        return _apply(t_img, t_txt, list(ws) + [None] * (4 - len(ws)), rope, 2)

    assert torch.autograd.gradcheck(fn, leaves, eps=1e-6, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("s_txt", [0, 4], ids=["single", "joint"])
def test_backward_matches_autograd_through_the_plain_chain(s_txt):
    img, txt, w, rope = _inputs(2, 9, s_txt, 3, 16, torch.float32, seed=1)
    gen = torch.Generator().manual_seed(2)
    grads = [torch.randn(2, 3, s_txt + 9, 16, generator=gen) for _ in range(3)]

    def run(fn):
        leaves = [t.detach().clone().requires_grad_() for t in img + (txt or []) + w]
        t_img, t_txt = leaves[:3], (leaves[3:6] if txt else None)
        ws = leaves[-4:]
        out = fn(t_img, t_txt, ws)
        torch.autograd.backward(out, grads)
        return [t.grad for t in leaves]

    def plain(t_img, t_txt, ws):
        return AP.attn_prologue_plain(*t_img, *(t_txt or (None,) * 3), *ws[:2],
                                      *(ws[2:] if t_txt else (None, None)), *rope, heads=3, eps=1e-6)

    got = run(lambda t_img, t_txt, ws: _apply(t_img, t_txt, ws, rope, 3))
    want = run(plain)
    for g, ref in zip(got, want):
        if ref is None:
            assert g is None
            continue
        torch.testing.assert_close(g, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


def test_frozen_weights_get_no_gradient():
    img, txt, w, rope = _inputs(1, 4, 2, 2, 8, torch.float32)
    img = [t.requires_grad_() for t in img]
    out = _apply(img, txt, w, rope, 2)
    torch.autograd.backward(out, [torch.ones_like(t) for t in out])
    assert all(t.grad is not None for t in img) and all(t.grad is None for t in w)


def test_cuda_wrapper_refuses_cpu_tensors():
    img, txt, w, rope = _inputs(1, 4, 2, 2, 8, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA bfloat16"):
        AP.attn_prologue_cuda(*img, *txt, *w, *rope, heads=2, eps=1e-6)


def _former_forward(monkeypatch):
    """Put the attention modules' former forwards back in place."""
    def joint(self, img, txt, rope, seq=None):
        img, txt = FT.region_in(img, self.tp), FT.region_in(txt, self.tp)
        w = (self.norm_q.weight, self.norm_k.weight, self.norm_added_q.weight, self.norm_added_k.weight)
        q, k, v = _old_joint((self.to_q(img), self.to_k(img), self.to_v(img)),
                             (self.add_q_proj(txt), self.add_k_proj(txt), self.add_v_proj(txt)), w, rope,
                             self.heads)
        s_txt = txt.shape[1]
        out = AP.merge_heads(FT.attention(q, k, v, seq=seq, segments=(s_txt, img.shape[1])))
        return self.to_out[0](out[:, s_txt:]), self.to_add_out(out[:, :s_txt])

    def single(self, x, rope, seq=None, segments=None):
        q, k, v = _old_single((self.to_q(x), self.to_k(x), self.to_v(x)), (self.norm_q.weight, self.norm_k.weight),
                              rope, self.heads)
        return AP.merge_heads(FT.attention(q, k, v, seq=seq, segments=segments))

    monkeypatch.setattr(FT.JointAttention, "forward", joint)
    monkeypatch.setattr(FT.SingleAttention, "forward", single)


def test_tiny_transformer_forward_and_lora_gradients_unchanged(monkeypatch):
    cfg = FT.FluxTransformerConfig.tiny()
    torch.manual_seed(0)
    model = FT.FluxTransformer2D(cfg, lora_rank=4, lora_alpha=4.0, device="cpu", dtype=torch.float32)
    adapters = FT.freeze_base_parameters(model)
    with torch.no_grad():
        for p in adapters:
            p.normal_(0.0, 0.1)
        for name, p in model.named_parameters():
            if name.endswith(("norm_q.weight", "norm_k.weight", "norm_added_q.weight", "norm_added_k.weight")):
                p.normal_(1.0, 0.1)
    gen = torch.Generator().manual_seed(1)
    b, s_img, s_txt = 2, 8, 4
    args = dict(
        hidden_states=torch.randn(b, s_img, cfg.in_channels, generator=gen),
        encoder_hidden_states=torch.randn(b, s_txt, cfg.joint_attention_dim, generator=gen),
        pooled_projections=torch.randn(b, cfg.pooled_projection_dim, generator=gen),
        timestep=torch.rand(b, generator=gen), guidance=torch.rand(b, generator=gen),
        img_ids=torch.randint(0, 8, (s_img, 3), generator=gen).float(),
        txt_ids=torch.zeros(s_txt, 3))

    def run():
        model.zero_grad()
        out = model(**args)
        (out * torch.linspace(-1.0, 1.0, out.numel()).reshape(out.shape)).sum().backward()
        return out.detach(), [p.grad.clone() for p in adapters]

    out, grads = run()
    with monkeypatch.context() as m:
        _former_forward(m)
        out_ref, grads_ref = run()
    assert torch.equal(out, out_ref)
    for g, ref in zip(grads, grads_ref):
        torch.testing.assert_close(g, ref, rtol=1e-4, atol=1e-6 * max(1.0, ref.abs().max().item()))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU or interpret mode)")


def _ulp_bf16(x):
    """One bf16 ulp at each |x| (the spacing above it; 2^-133 at 0)."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _pair_length(x):
    """|(x_2i, x_2i+1)| at each element of the pair."""
    pairs = x.float().reshape(*x.shape[:-1], -1, 2)
    return pairs.square().sum(dim=-1, keepdim=True).sqrt().expand_as(pairs).reshape(x.shape)


CARD_SHAPES = [
    (4, 2048, 512, 24, 128),    # the serve cell's joint blocks (single blocks: text folded into image)
    (1, 77, 13, 12, 128),       # odd token counts at a TP-2 rank's 12 heads
    (2, 61, 0, 24, 128),        # text-free, odd
    (1, 33, 7, 3, 64),          # another head dim (16-byte chunks, 8 lanes a row)
    (1, 20, 5, 2, 36),          # 8-byte chunks
    (1, 11, 3, 2, 10),          # 4-byte chunks
    (1, 9, 4, 1, 256),          # two chunks a lane
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32], ids=["w_bf16", "w_fp32"])
def test_kernel_forward_within_one_ulp_of_the_plain_twin(_cuda, shape, w_dtype):
    b, s_img, s_txt, h, d = shape
    img, txt, w, rope = _inputs(b, s_img, s_txt, h, d, torch.bfloat16, device="cuda", w_dtype=w_dtype)
    img = [t.to(torch.bfloat16) for t in img]
    txt = None if txt is None else [t.to(torch.bfloat16) for t in txt]
    before = AP.LAUNCHES
    got = _apply(img, txt, w, rope, h)
    assert AP.LAUNCHES == before + 1
    want = AP.attn_prologue_plain(*img, *(txt or (None,) * 3), *w[:2], *(w[2:] if txt else (None, None)), *rope,
                                  heads=h, eps=1e-6)
    torch.cuda.synchronize()
    for name, g, ref in zip("qkv", got, want):
        assert g.is_contiguous() and g.shape == (b, h, s_txt + s_img, d)
        if name == "v":
            assert torch.equal(g, ref)
            continue
        diff = (g.float() - ref.float()).abs()
        pair_ulps = (diff / _ulp_bf16(_pair_length(ref))).max().item()
        print(f"[attn_prologue] {shape} {w_dtype} {name}: {(diff > 0).float().mean().item():.3e} of the "
              f"elements differ, {(diff > _ulp_bf16(ref)).float().mean().item():.3e} by more than their own "
              f"ulp; at most {pair_ulps} ulps of the pair's length")
        assert pair_ulps <= 2.0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_backward_against_fp32_autograd(_cuda, shape):
    b, s_img, s_txt, h, d = shape
    img, txt, w, rope = _inputs(b, s_img, s_txt, h, d, torch.bfloat16, device="cuda", seed=3)
    gen = torch.Generator("cuda").manual_seed(4)
    grads = [torch.randn(b, h, s_txt + s_img, d, generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(3)]
    n_w = 2 if txt is None else 4

    def leaves(dtype):
        return [t.detach().to(dtype).requires_grad_() for t in img + (txt or []) + w[:n_w]]

    got_leaves = leaves(torch.bfloat16)
    t_img, rest = got_leaves[:3], got_leaves[3:]
    t_txt, ws = (None, rest) if txt is None else (rest[:3], rest[3:])
    before = AP.BWD_LAUNCHES
    torch.autograd.backward(_apply(t_img, t_txt, list(ws) + [None] * (4 - n_w), rope, h), grads)
    assert AP.BWD_LAUNCHES == before + 1
    ref_leaves = leaves(torch.float32)
    r_img, rest = ref_leaves[:3], ref_leaves[3:]
    r_txt, rws = (None, rest) if txt is None else (rest[:3], rest[3:])
    out = AP.attn_prologue_plain(*r_img, *(r_txt or (None,) * 3), *rws[:2], *(rws[2:] if r_txt else (None, None)),
                                 *rope, heads=h, eps=1e-6)
    torch.autograd.backward(out, [g.float() for g in grads])
    torch.cuda.synchronize()
    for i, (g, ref) in enumerate(zip(got_leaves, ref_leaves)):
        got_g, ref_g = g.grad.float(), ref.grad
        scale = ref_g.abs().max().item()
        if i >= len(got_leaves) - n_w:        # a norm weight: fp32 sums over every row, rounded to bf16
            assert bool(((got_g - ref_g).abs() <= 2 ** -8 * ref_g.abs() + 1e-3 * scale).all())
        else:
            assert bool(((got_g - ref_g).abs() <= 2 ** -8 * ref_g.abs() + 1e-4 * scale).all())


@pytest.mark.cuda
def test_one_launch_a_block_and_the_counter(_cuda):
    """A forward of the FLUX depth (19 + 38 blocks) launches K13 once a
    block, 57 in all, and adds each launch's rows to `attn.prologue`."""
    cfg = FT.FluxTransformerConfig(in_channels=16, num_attention_heads=1, joint_attention_dim=32,
                                   pooled_projection_dim=16)
    model = FT.FluxTransformer2D(cfg, device="cuda", dtype=torch.bfloat16)
    b, s_img, s_txt = 2, 64, 16
    gen = torch.Generator("cuda").manual_seed(0)
    kw = {"generator": gen, "device": "cuda"}
    args = dict(hidden_states=torch.randn(b, s_img, 16, **kw).bfloat16(),
                encoder_hidden_states=torch.randn(b, s_txt, 32, **kw).bfloat16(),
                pooled_projections=torch.randn(b, 16, **kw).bfloat16(), timestep=torch.rand(b, **kw),
                guidance=torch.rand(b, **kw), img_ids=torch.zeros(s_img, 3, device="cuda"),
                txt_ids=torch.zeros(s_txt, 3, device="cuda"))
    launches, seen = AP.LAUNCHES, counters()["attn.prologue"]
    with torch.inference_mode():
        out = model(**args)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert AP.LAUNCHES - launches == 57
    now = counters()["attn.prologue"]
    assert now["count"] - seen["count"] == 57
    assert now["total"] - seen["total"] == 57 * b * (s_img + s_txt)
