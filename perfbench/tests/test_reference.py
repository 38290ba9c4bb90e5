"""The plain references against the program's plain CPU route at a tiny
size, through each cell's own driver: a sound run is correct, and reads
close to exact (fp32 on both sides)."""
import pytest

from perfbench.tests import tiny


@pytest.mark.parametrize("name, tolerance", [
    ("serve-512-bf16", {"image_rms": 2e-3, "image_max": 2.5e-3}),   # the PNG's 1/255 rounding
    ("vae-stage1-512", {"grad_gap": 1e-4, "change_gap": 1e-3, "grad_gap_rescaled": 1e-4, "data_rows": 0.0}),
    ("lora-512-b8", {"grad_gap": 1e-4, "change_gap": 1e-3, "data_rows": 0.0}),
])
def test_sound_run_is_correct(name, tolerance):
    record = tiny.run(name)
    assert record.correct, [(c.name, c.value, c.limit) for c in record.checks]
    assert {c.name for c in record.checks} == set(tolerance)
    for c in record.checks:
        assert c.value <= tolerance[c.name], (c.name, c.value)
    assert record.attempted > 0 and record.failed == 0
    assert record.e2e and all(v > 0 for v in record.e2e.values())


def test_reference_pieces_match_the_program_modules():
    """The reference transformer and VAE against the program's modules on
    the same drawn weights, one forward each."""
    import torch

    from perfbench import program
    from perfbench.reference import flux as RF
    from perfbench.reference import vae as RV
    from perfbench.reference.numerics import Numerics

    _, cfg, _ = tiny.cell("serve-512-bf16")
    dev = torch.device("cpu")
    model = program.build_textalpha_model(cfg, 7, dev, dtype=torch.float32)
    P = program.flux_state(cfg, 7, dev, torch.float32)
    flux = RF.FluxReference(P, cfg["transformer"], Numerics())
    g = torch.Generator().manual_seed(0)
    t = cfg["transformer"]
    hidden = torch.randn((2, 32, t["in_channels"]), generator=g)
    prompt, pooled = program.prompt_embeddings(cfg, 7, dev)
    ids = RF.image_ids(4, 4, dev)
    ts = torch.tensor([0.3, 0.7])
    kw = dict(timestep=ts, img_ids=torch.cat([ids, ids]), txt_ids=torch.zeros((4, 3)), guidance=torch.full((2,), 3.5))
    with torch.no_grad():
        got = model.transformer(hidden_states=hidden, encoder_hidden_states=prompt.expand(2, -1, -1),
                                pooled_projections=pooled.expand(2, -1), **kw)
        want = flux(hidden, prompt.expand(2, -1, -1), pooled.expand(2, -1), ts, kw["img_ids"], kw["txt_ids"],
                    kw["guidance"])
        assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)
        vae = RV.VaeReference(program.vae_state(cfg, 7, dev, torch.float32), cfg["vae"], Numerics())
        x = torch.rand((1, 32, 32, 4), generator=g) * 2 - 1
        post = model.vae.module.encode(x)
        mean, logvar = vae.encode(x)
        assert torch.allclose(post.mean, mean, atol=1e-4) and torch.allclose(post.logvar, logvar, atol=1e-4)
        assert torch.allclose(model.vae.module.decode(mean), vae.decode(mean), atol=1e-4)
