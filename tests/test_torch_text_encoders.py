"""The port's empty-prompt text encoders against the JAX package's
`encode_empty_prompt`, which runs the checkpoint's CLIP and T5 encoders
through `transformers` on the CPU.

Tiny checkpoints are written into the test's tmp dir: random 2-layer
encoders saved with `save_pretrained` (safetensors, the T5 one also in
shards), a CLIP `vocab.json` / `merges.txt` and a T5 `tokenizer.json` built
with `tokenizers`. Both branches run: equal widths (CLIP stream then T5
stream) and T5 alone. Everything is fp32 on the CPU; the port and JAX's
transformers route agree to TOL (max abs error over the reference's largest
magnitude).
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

# transformers (the JAX reference's route) otherwise also imports TensorFlow: ~7 s
os.environ.setdefault("USE_TF", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ragb_vae_tpu.models import flux_kontext_textalpha as jax_textalpha  # noqa: E402
from ragb_vae_tpu_torch.models import flux_kontext_textalpha as port  # noqa: E402
from ragb_vae_tpu_torch.models import text_encoders as te  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
CLIP_LEN, T5_LEN = 9, 12
# (CLIP width, T5 width): equal widths concatenate the streams, unequal keep T5's
BRANCHES = {"concat": (32, 32), "t5_only": (32, 64)}


def _clip_config(width: int, **kw):
    from transformers import CLIPTextConfig

    return CLIPTextConfig(vocab_size=12, hidden_size=width, intermediate_size=2 * width, num_hidden_layers=2,
                          num_attention_heads=2, max_position_embeddings=CLIP_LEN, hidden_act="quick_gelu",
                          bos_token_id=6, eos_token_id=7, pad_token_id=0, **kw)


def _t5_config(width: int, **kw):
    from transformers import T5Config

    kw = {"feed_forward_proj": "gated-gelu", **kw}
    return T5Config(vocab_size=10, d_model=width, d_kv=8, d_ff=48, num_layers=2, num_heads=4,
                    relative_attention_num_buckets=8, relative_attention_max_distance=20, **kw)


def _write_tokenizers(root: Path, *, pad_is_eos: bool, via_map: bool) -> None:
    """CLIP's vocab.json / merges.txt and T5's tokenizer.json (T5's special
    tokens deliberately not at ids 0 and 1). `pad_is_eos`: CLIP pads with its
    eos, as FLUX's tokenizer does. `via_map`: the special tokens stand in
    special_tokens_map.json (as objects) instead of tokenizer_config.json."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, processors

    clip, t5 = root / "tokenizer", root / "tokenizer_2"
    clip.mkdir(parents=True)
    t5.mkdir(parents=True)
    vocab = {"!": 0, "a": 1, "b": 2, "a</w>": 3, "b</w>": 4, "ab</w>": 5, "<|startoftext|>": 6,
             "<|endoftext|>": 7}
    (clip / "vocab.json").write_text(json.dumps(vocab))
    (clip / "merges.txt").write_text("#version: 0.2\na b</w>\n")
    specials = {"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>", "unk_token": "<|endoftext|>",
                "pad_token": "<|endoftext|>" if pad_is_eos else "!"}
    t5_specials = {"eos_token": "</s>", "pad_token": "<pad>", "unk_token": "<unk>"}
    for directory, names, length in ((clip, specials, CLIP_LEN), (t5, t5_specials, T5_LEN)):
        config = {"model_max_length": length, "extra_ids": 0, "additional_special_tokens": []}
        if via_map:
            (directory / "special_tokens_map.json").write_text(json.dumps(
                {k: {"content": v, "lstrip": False, "normalized": False, "rstrip": False, "single_word": False}
                 for k, v in names.items()}))
        else:
            config.update(names)
        (directory / "tokenizer_config.json").write_text(json.dumps(config))
    pieces = [("<unk>", 0.0), ("▁", -1.0), ("<pad>", 0.0), ("a", -2.0), ("</s>", 0.0), ("b", -2.0),
              ("▁a", -1.5)]
    tok = Tokenizer(models.Unigram(pieces, unk_id=0))
    tok.pre_tokenizer = pre_tokenizers.Sequence([pre_tokenizers.WhitespaceSplit(), pre_tokenizers.Metaspace()])
    tok.post_processor = processors.TemplateProcessing(single="$A </s>", pair="$A </s> $B </s>",
                                                       special_tokens=[("</s>", 4)])
    tok.decoder = decoders.Metaspace()
    tok.add_special_tokens(["<unk>", "<pad>", "</s>"])
    tok.save(str(t5 / "tokenizer.json"))


def _write_encoders(root: Path, clip_width: int, t5_width: int, *, seed: int = 0, **t5_kw) -> None:
    from transformers import CLIPTextModel, T5EncoderModel

    torch.manual_seed(seed)
    CLIPTextModel(_clip_config(clip_width)).eval().save_pretrained(root / "text_encoder")
    # sharded, as FLUX's text_encoder_2 is
    T5EncoderModel(_t5_config(t5_width, **t5_kw)).eval().save_pretrained(root / "text_encoder_2",
                                                                          max_shard_size="20KB")


def write_text_checkpoint(root: Path, branch: str, *, pad_is_eos: bool = True, via_map: bool = False) -> Path:
    _write_tokenizers(root, pad_is_eos=pad_is_eos, via_map=via_map)
    _write_encoders(root, *BRANCHES[branch])
    return root


@pytest.fixture(scope="module", params=sorted(BRANCHES))
def checkpoint(request, tmp_path_factory):
    """(branch, a tiny text checkpoint, JAX's embeddings of its empty prompt).
    JAX writes its npz on its first call, so it encodes a copy."""
    root = write_text_checkpoint(tmp_path_factory.mktemp(request.param), request.param,
                                 pad_is_eos=request.param == "concat", via_map=request.param == "t5_only")
    jax_dir = root.parent / f"{root.name}-jax"
    shutil.copytree(root, jax_dir)
    return request.param, root, jax_textalpha.encode_empty_prompt(jax_dir)


def _close(got, want, tol=TOL) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want))))
    assert err <= tol, f"error {err:.3e} > {tol}"
    return err


def test_encode_empty_prompt_matches_jax(checkpoint, tmp_path):
    branch, root, (prompt, pooled, text_ids) = checkpoint
    work = tmp_path / "ckpt"
    shutil.copytree(root, work)
    got = port.encode_empty_prompt(work, device="cpu")
    expected_len = CLIP_LEN + T5_LEN if branch == "concat" else T5_LEN
    assert prompt.shape == (1, expected_len, BRANCHES[branch][1])
    assert pooled.shape == (1, BRANCHES[branch][0])
    for a, b in zip(got, (prompt, pooled, text_ids)):
        assert a.dtype == np.float32
        _close(a, b)
    np.testing.assert_array_equal(got[2], np.zeros((expected_len, 3), np.float32))
    assert (work / port.EMPTY_PROMPT_FILE).exists()
    # the second call reads the file back bit for bit
    for a, b in zip(port.encode_empty_prompt(work, device="cpu"), got):
        np.testing.assert_array_equal(a, b)


def test_the_pooled_embedding_is_the_final_norm_applied_twice_at_token_0(checkpoint, tmp_path):
    """JAX's (and so the port's) pooled output is not transformers'
    `pooler_output` (the eos token after one final LayerNorm)."""
    _, root, (_, pooled, _) = checkpoint
    clip = te.load_clip_text_encoder(root / "text_encoder", device="cpu")
    ids, mask = te.clip_empty_prompt_ids(root / "tokenizer")
    with torch.no_grad():
        hidden = clip(ids, mask)
        _close(clip.text_model.final_layer_norm(hidden)[:, 0], pooled)
        assert not np.allclose(hidden[:, 1].numpy(), pooled, atol=1e-3)


@pytest.mark.parametrize("kind", ["clip", "t5"])
def test_token_ids_and_masks_match_transformers(checkpoint, kind):
    from transformers import CLIPTokenizer, T5TokenizerFast

    _, root, _ = checkpoint
    sub, cls, ours = {"clip": ("tokenizer", CLIPTokenizer, te.clip_empty_prompt_ids),
                      "t5": ("tokenizer_2", T5TokenizerFast, te.t5_empty_prompt_ids)}[kind]
    tok = cls.from_pretrained(root / sub)
    want = tok([""], padding="max_length", max_length=tok.model_max_length, truncation=True, return_tensors="pt")
    ids, mask = ours(root / sub)
    assert torch.equal(ids, want["input_ids"]) and torch.equal(mask, want["attention_mask"])
    assert int(mask.sum()) == (2 if kind == "clip" else 1)


@pytest.mark.parametrize("kind", ["clip", "t5"])
@pytest.mark.parametrize("missing", ["eos_token", "pad_token", "model_max_length"])
def test_a_missing_tokenizer_field_raises(tmp_path, kind, missing):
    _write_tokenizers(tmp_path, pad_is_eos=False, via_map=False)
    directory = tmp_path / ("tokenizer" if kind == "clip" else "tokenizer_2")
    config = json.loads((directory / "tokenizer_config.json").read_text())
    del config[missing]
    (directory / "tokenizer_config.json").write_text(json.dumps(config))
    with pytest.raises(ValueError, match=missing):
        (te.clip_empty_prompt_ids if kind == "clip" else te.t5_empty_prompt_ids)(directory)


def test_a_token_without_an_id_raises(tmp_path):
    _write_tokenizers(tmp_path, pad_is_eos=False, via_map=False)
    (tmp_path / "tokenizer" / "vocab.json").write_text(json.dumps({"a": 0}))
    with pytest.raises(ValueError, match="no id"):
        te.clip_empty_prompt_ids(tmp_path / "tokenizer")


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("buckets,distance", [(32, 128), (8, 20)])
def test_relative_buckets_match_transformers(bidirectional, buckets, distance):
    from transformers.models.t5.modeling_t5 import T5Attention

    pos = torch.arange(512)
    rel = pos[None, :] - pos[:, None]
    want = T5Attention._relative_position_bucket(rel, bidirectional, buckets, distance)
    assert torch.equal(te.relative_position_bucket(rel, bidirectional, buckets, distance), want)


def _hf_pair(root: Path):
    from transformers import CLIPTextModel, T5EncoderModel

    return (CLIPTextModel.from_pretrained(root / "text_encoder").eval(),
            T5EncoderModel.from_pretrained(root / "text_encoder_2").eval())


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
def test_each_encoder_matches_transformers(checkpoint, masked):
    """Each encoder's last hidden state against transformers' on the empty
    prompt's ids, with and without the padding mask; dropping the mask moves
    the output far past TOL, so the mask is what the comparison holds."""
    _, root, _ = checkpoint
    hf_clip, hf_t5 = _hf_pair(root)
    ours = (te.load_clip_text_encoder(root / "text_encoder", device="cpu"),
            te.load_t5_encoder(root / "text_encoder_2", device="cpu"))
    inputs = (te.clip_empty_prompt_ids(root / "tokenizer"), te.t5_empty_prompt_ids(root / "tokenizer_2"))
    with torch.no_grad():
        for hf, mine, (ids, mask) in zip((hf_clip, hf_t5), ours, inputs):
            m = mask if masked else None
            want = hf(input_ids=ids, attention_mask=m).last_hidden_state
            _close(mine(ids, m), want)
            other = mine(ids, None if masked else mask)
            assert float((other - want).abs().max() / want.abs().max().clamp(min=1.0)) > 100 * TOL


@pytest.mark.parametrize("proj", ["relu", "gated-gelu"])
def test_t5_feed_forward_kinds_and_relu_checkpoints_load(tmp_path, proj):
    from transformers import T5EncoderModel

    torch.manual_seed(1)
    hf = T5EncoderModel(_t5_config(32, feed_forward_proj=proj)).eval()
    hf.save_pretrained(tmp_path)
    mine = te.load_t5_encoder(tmp_path, device="cpu")
    assert mine.config.is_gated == (proj == "gated-gelu")
    ids = torch.tensor([[4, 3, 5, 2, 2]])
    mask = torch.tensor([[1, 1, 1, 0, 0]])
    with torch.no_grad():
        _close(mine(ids, mask), hf(input_ids=ids, attention_mask=mask).last_hidden_state)


def test_the_tied_embedding_loads_once_and_strict_loading_rejects_strangers(tmp_path):
    """A checkpoint holding both names of T5's tied embedding loads; a key the
    module lacks raises."""
    from safetensors.torch import save_file

    torch.manual_seed(2)
    module = te.T5Encoder(te.T5EncoderConfig(vocab_size=10, d_model=16, d_kv=4, d_ff=24, num_layers=1,
                                             num_heads=2, feed_forward_proj="gated-gelu"))
    te.save_text_encoder(module, tmp_path)
    state = {k: v.clone() for k, v in module.state_dict().items()}
    save_file({**state, "encoder.embed_tokens.weight": state["shared.weight"].clone()}, str(tmp_path / te.WEIGHT_FILE))
    loaded = te.load_t5_encoder(tmp_path, device="cpu")
    assert torch.equal(loaded.shared.weight, module.shared.weight)
    save_file({**state, "lm_head.weight": state["shared.weight"].clone()}, str(tmp_path / te.WEIGHT_FILE))
    with pytest.raises(RuntimeError, match="lm_head"):
        te.load_t5_encoder(tmp_path, device="cpu")


def test_random_init_keeps_a_deep_t5_finite():
    """The smoke test's seeded full-size encoders use transformers' stds; at
    narrow width, 24 layers stay finite and O(1) after the final norm."""
    gen = torch.Generator().manual_seed(0)
    for module in (te.T5Encoder(te.T5EncoderConfig(d_model=64, d_kv=16, d_ff=96, num_layers=24, num_heads=4,
                                                   feed_forward_proj="gated-gelu")),
                   te.CLIPTextEncoder(te.CLIPTextConfig(hidden_size=64, intermediate_size=128))):
        te.init_text_encoder_(module, gen)
        length = 77 if isinstance(module, te.CLIPTextEncoder) else 32
        mask = torch.zeros(1, length, dtype=torch.long)
        mask[:, :2] = 1
        with torch.no_grad():
            out = module(torch.randint(0, 100, (1, length), generator=gen), mask)
        assert torch.isfinite(out).all() and 0.1 < float(out.abs().max()) < 100


def test_npz_files_interchange_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    arrays = (rng.standard_normal((1, 5, 8)), rng.standard_normal((1, 4)), np.zeros((5, 3)))
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    jax_textalpha.save_empty_prompt_embeds(tmp_path / "a", *arrays)
    port.save_empty_prompt_embeds(tmp_path / "b", *arrays)
    # each package reads the other's file (a directory without encoders: only the npz can answer)
    for got, want in ((port.encode_empty_prompt(tmp_path / "a", device="cpu"), arrays),
                      (jax_textalpha.encode_empty_prompt(tmp_path / "b"), arrays)):
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w.astype(np.float32))
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == [port.EMPTY_PROMPT_FILE]


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        port.encode_empty_prompt(tmp_path, device="cuda")


def _write_model_tree(root: Path) -> None:
    """flux/{transformer, tokenizer*, text_encoder*} (no npz) and vae/ae:
    a tiny transformer that takes the T5-only branch's (1, 12, 64) prompt."""
    from ragb_vae_tpu_torch.models.flux_transformer import FluxTransformerConfig
    from ragb_vae_tpu_torch.models.flux_weights import save_flux_transformer_params
    from ragb_vae_tpu_torch.models.vae_config import AutoencoderConfig
    from ragb_vae_tpu_torch.models.weights import save_autoencoder_params

    t_cfg = FluxTransformerConfig.tiny()
    t_cfg.joint_attention_dim, t_cfg.pooled_projection_dim = BRANCHES["t5_only"][1], BRANCHES["t5_only"][0]
    v_cfg = AutoencoderConfig.tiny()
    v_cfg.in_channels = v_cfg.out_channels = 4
    model = port.FluxTextAlphaModel.random(t_cfg, v_cfg, seed=0, device="cpu", prompt_len=4)
    save_flux_transformer_params(t_cfg, model.transformer.state_dict(), root / "flux" / "transformer")
    save_autoencoder_params(v_cfg, model.vae.module.state_dict(), root / "vae" / "ae")
    write_text_checkpoint(root / "flux", "t5_only")


def test_from_pretrained_without_an_npz_writes_one(tmp_path):
    _write_model_tree(tmp_path)
    flux = tmp_path / "flux"
    assert not (flux / port.EMPTY_PROMPT_FILE).exists()
    model = port.FluxTextAlphaModel.from_pretrained(flux, vae_path=tmp_path / "vae", device="cpu")
    assert (flux / port.EMPTY_PROMPT_FILE).exists()
    assert model.prompt_embeds.shape == (1, T5_LEN, 64) and model.pooled_prompt_embeds.shape == (1, 32)
    jax_dir = tmp_path / "jax"
    shutil.copytree(flux, jax_dir, ignore=shutil.ignore_patterns(port.EMPTY_PROMPT_FILE))
    want = jax_textalpha.encode_empty_prompt(jax_dir)
    _close(model.prompt_embeds.numpy(), want[0])
    _close(model.pooled_prompt_embeds.numpy(), want[1])
    again = port.FluxTextAlphaModel.from_pretrained(flux, vae_path=tmp_path / "vae", device="cpu")
    assert torch.equal(again.prompt_embeds, model.prompt_embeds)
    assert torch.equal(again.pooled_prompt_embeds, model.pooled_prompt_embeds)


def test_the_port_encodes_without_transformers_or_jax(tmp_path):
    """In a fresh interpreter: the port's encoders, tokens and from_pretrained's
    prompt step import neither transformers nor jax."""
    write_text_checkpoint(tmp_path / "ckpt", "concat")
    code = (
        "import sys\n"
        "from ragb_vae_tpu_torch.models.flux_kontext_textalpha import encode_empty_prompt\n"
        f"prompt, pooled, ids = encode_empty_prompt({str(tmp_path / 'ckpt')!r}, device='cpu')\n"
        f"assert prompt.shape == (1, {CLIP_LEN + T5_LEN}, 32), prompt.shape\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('transformers', 'jax', 'jaxlib', 'flax',"
        " 'tokenizers', 'ragb_vae_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_left_padding_is_refused(tmp_path):
    _write_tokenizers(tmp_path, pad_is_eos=False, via_map=False)
    path = tmp_path / "tokenizer_2" / "tokenizer_config.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "padding_side": "left"}))
    with pytest.raises(ValueError, match="padding_side"):
        te.t5_empty_prompt_ids(tmp_path / "tokenizer_2")


def test_chip_smoke_textenc_phase_runs_on_the_cpu_at_narrow_width(tmp_path, monkeypatch):
    """chip_smoke's `textenc` phase, rehearsed on the CPU with the published
    configs narrowed: FLUX-style tokenizer files, the depth-2 hold and its
    planted fault, and from_pretrained writing the npz."""
    import chip_smoke

    monkeypatch.setattr(te.CLIPTextConfig, "clip_l", classmethod(
        lambda cls: cls(hidden_size=48, intermediate_size=96, num_attention_heads=2, num_hidden_layers=3)))
    monkeypatch.setattr(te.T5EncoderConfig, "t5_xxl", classmethod(
        lambda cls: cls(d_model=64, d_kv=16, d_ff=96, num_layers=3, num_heads=4, feed_forward_proj="gated-gelu")))
    assert chip_smoke.phase_textenc(tmp_path, device="cpu") == {}
    assert (tmp_path / "ckpt" / "flux" / port.EMPTY_PROMPT_FILE).exists()
