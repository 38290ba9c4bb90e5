"""The empty-prompt text encoders of FLUX: CLIP-L and the T5-v1.1 encoder.

The JAX package runs the checkpoint's two text encoders once through
`transformers` on the host (`encode_empty_prompt`); the port carries its own
plain PyTorch copies, so it needs neither `transformers` nor a tokenizer
library. Both modules use transformers' parameter names, so a checkpoint's
state dict loads into them as it is:

- `CLIPTextEncoder`: token and position embeddings, pre-LN layers (queries
  scaled by head_dim**-0.5, the causal and the padding mask both added, the
  config's `hidden_act` in the MLP), a final LayerNorm.
- `T5Encoder`: a shared embedding, RMSNorm layers (variance in fp32), a
  relative position bias computed by layer 0 and reused by every layer
  (bidirectional buckets), unscaled scores with the padding mask added as
  `finfo.min` and the softmax in fp32, a gated `gelu_new` (or `relu`)
  feed-forward without biases, a final RMSNorm.

`""` tokenises to constants: `[bos, eos, pad...]` for CLIP and
`[eos, pad...]` for T5, padded to the tokenizer's `model_max_length`. The
ids are read from the checkpoint's tokenizer files; a missing field raises.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ragb_vae_tpu_torch.device import resolve_device
from ragb_vae_tpu_torch.models.weights import iter_torch_state, save_torch_state

Tensor = torch.Tensor
PathLike = Union[str, Path]


def _new_gelu(x: Tensor) -> Tensor:
    """transformers' `gelu_new` (the tanh approximation), written as it is."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3.0))))


ACTIVATIONS = {
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "gelu_new": _new_gelu,
    "relu": F.relu,
}


def _activation(name: str):
    if name not in ACTIVATIONS:
        raise ValueError(f"Unsupported activation {name!r}: one of {sorted(ACTIVATIONS)}.")
    return ACTIVATIONS[name]


def _from_json(cls, path: PathLike):
    """A config dataclass from a transformers `config.json` (other keys are
    ignored; an absent key keeps transformers' default)."""
    raw = json.loads(Path(path).read_text())
    return cls(**{f.name: raw[f.name] for f in dataclasses.fields(cls) if f.name in raw})


# ---------------------------------------------------------------------------
# Configs (transformers' field names and defaults)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5

    @classmethod
    def clip_l(cls) -> "CLIPTextConfig":
        """FLUX.1-Kontext-dev's `text_encoder/config.json` (CLIP ViT-L/14's text tower)."""
        return cls(hidden_size=768, intermediate_size=3072, num_attention_heads=12)

    @classmethod
    def from_json(cls, path: PathLike) -> "CLIPTextConfig":
        return _from_json(cls, path)

    def to_json(self, path: PathLike) -> None:
        Path(path).write_text(json.dumps({"architectures": ["CLIPTextModel"], "model_type": "clip_text_model",
                                          **dataclasses.asdict(self)}, indent=2))


@dataclasses.dataclass
class T5EncoderConfig:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    feed_forward_proj: str = "relu"
    layer_norm_epsilon: float = 1e-6

    @classmethod
    def t5_xxl(cls) -> "T5EncoderConfig":
        """FLUX.1-Kontext-dev's `text_encoder_2/config.json` (T5-v1.1-XXL)."""
        return cls(d_model=4096, d_kv=64, d_ff=10240, num_layers=24, num_heads=64,
                   feed_forward_proj="gated-gelu")

    @property
    def is_gated(self) -> bool:
        return self.feed_forward_proj.split("-")[0] == "gated"

    @property
    def dense_act(self) -> str:
        """transformers' `dense_act_fn`: "gated-gelu" means `gelu_new`."""
        return "gelu_new" if self.feed_forward_proj == "gated-gelu" else self.feed_forward_proj.split("-")[-1]

    @classmethod
    def from_json(cls, path: PathLike) -> "T5EncoderConfig":
        return _from_json(cls, path)

    def to_json(self, path: PathLike) -> None:
        Path(path).write_text(json.dumps({"architectures": ["T5EncoderModel"], "model_type": "t5",
                                          **dataclasses.asdict(self)}, indent=2))


# ---------------------------------------------------------------------------
# CLIP text encoder
# ---------------------------------------------------------------------------
class _CLIPAttention(nn.Module):
    def __init__(self, c: CLIPTextConfig, device=None):
        super().__init__()
        d = c.hidden_size
        self.heads = c.num_attention_heads
        self.scale = (d // self.heads) ** -0.5
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, nn.Linear(d, d, device=device))

    def forward(self, x: Tensor, bias: Tensor) -> Tensor:
        b, s, d = x.shape

        def heads(t):
            return t.view(b, s, self.heads, -1).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        scores = torch.matmul(q, k.transpose(2, 3)) * self.scale + bias
        out = torch.matmul(torch.softmax(scores, dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, d))


class _CLIPMLP(nn.Module):
    def __init__(self, c: CLIPTextConfig, device=None):
        super().__init__()
        self.act = _activation(c.hidden_act)
        self.fc1 = nn.Linear(c.hidden_size, c.intermediate_size, device=device)
        self.fc2 = nn.Linear(c.intermediate_size, c.hidden_size, device=device)

    def forward(self, x: Tensor) -> Tensor:
        return self.fc2(self.act(self.fc1(x)))


class _CLIPLayer(nn.Module):
    def __init__(self, c: CLIPTextConfig, device=None):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps, device=device)
        self.self_attn = _CLIPAttention(c, device)
        self.layer_norm2 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps, device=device)
        self.mlp = _CLIPMLP(c, device)

    def forward(self, x: Tensor, bias: Tensor) -> Tensor:
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


class _CLIPEmbeddings(nn.Module):
    def __init__(self, c: CLIPTextConfig, device=None):
        super().__init__()
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden_size, device=device)
        self.position_embedding = nn.Embedding(c.max_position_embeddings, c.hidden_size, device=device)

    def forward(self, input_ids: Tensor) -> Tensor:
        positions = torch.arange(input_ids.shape[-1], device=input_ids.device)
        return self.token_embedding(input_ids) + self.position_embedding(positions)[None]


class _CLIPEncoder(nn.Module):
    def __init__(self, c: CLIPTextConfig, device=None):
        super().__init__()
        self.layers = nn.ModuleList(_CLIPLayer(c, device) for _ in range(c.num_hidden_layers))


class _CLIPTextTransformer(nn.Module):
    def __init__(self, c: CLIPTextConfig, device=None):
        super().__init__()
        self.embeddings = _CLIPEmbeddings(c, device)
        self.encoder = _CLIPEncoder(c, device)
        self.final_layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps, device=device)


class CLIPTextEncoder(nn.Module):
    """transformers' `CLIPTextModel` up to `last_hidden_state`."""

    def __init__(self, config: CLIPTextConfig, device=None):
        super().__init__()
        self.config = config
        self.text_model = _CLIPTextTransformer(config, device)

    def forward(self, input_ids: Tensor, attention_mask: Optional[Tensor] = None) -> Tensor:
        tm = self.text_model
        x = tm.embeddings(input_ids)
        s = input_ids.shape[-1]
        lowest = torch.finfo(x.dtype).min
        # the causal mask and the padding mask, each lowest where it forbids,
        # added as transformers adds them
        bias = torch.triu(torch.full((s, s), lowest, dtype=x.dtype, device=x.device), diagonal=1)[None, None]
        if attention_mask is not None:
            bias = bias + (1.0 - attention_mask[:, None, None, :].to(x.dtype)) * lowest
        for layer in tm.encoder.layers:
            x = layer(x, bias)
        return tm.final_layer_norm(x)


# ---------------------------------------------------------------------------
# T5 encoder
# ---------------------------------------------------------------------------
def relative_position_bucket(relative_position: Tensor, bidirectional: bool = True, num_buckets: int = 32,
                             max_distance: int = 128) -> Tensor:
    """transformers' `T5Attention._relative_position_bucket`, step by step."""
    buckets = torch.zeros_like(relative_position)
    if bidirectional:
        num_buckets //= 2
        buckets += (relative_position > 0).to(torch.long) * num_buckets
        relative_position = torch.abs(relative_position)
    else:
        relative_position = -torch.min(relative_position, torch.zeros_like(relative_position))
    max_exact = num_buckets // 2
    is_small = relative_position < max_exact
    large = max_exact + (
        torch.log(relative_position.float() / max_exact) / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.long)
    large = torch.min(large, torch.full_like(large, num_buckets - 1))
    return buckets + torch.where(is_small, relative_position, large)


class T5LayerNorm(nn.Module):
    """RMSNorm without a bias, its variance taken in fp32."""

    def __init__(self, d: int, eps: float, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, device=device))
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        variance = x.to(torch.float32).pow(2).mean(-1, keepdim=True)
        x = x * torch.rsqrt(variance + self.eps)
        if self.weight.dtype in (torch.float16, torch.bfloat16):
            x = x.to(self.weight.dtype)
        return self.weight * x


class _T5Attention(nn.Module):
    def __init__(self, c: T5EncoderConfig, has_bias: bool, device=None):
        super().__init__()
        self.heads, self.d_kv = c.num_heads, c.d_kv
        inner = c.num_heads * c.d_kv
        for name in ("q", "k", "v"):
            setattr(self, name, nn.Linear(c.d_model, inner, bias=False, device=device))
        self.o = nn.Linear(inner, c.d_model, bias=False, device=device)
        self.buckets, self.max_distance = c.relative_attention_num_buckets, c.relative_attention_max_distance
        if has_bias:
            self.relative_attention_bias = nn.Embedding(self.buckets, self.heads, device=device)

    def position_bias(self, length: int, device) -> Tensor:
        """(1, heads, length, length): layer 0's bias, which every layer adds."""
        pos = torch.arange(length, dtype=torch.long, device=device)
        bucket = relative_position_bucket(pos[None, :] - pos[:, None], True, self.buckets, self.max_distance)
        return self.relative_attention_bias(bucket).permute(2, 0, 1)[None]

    def forward(self, x: Tensor, bias: Tensor) -> Tensor:
        b, s, _ = x.shape

        def heads(t):
            return t.view(b, s, self.heads, self.d_kv).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        scores = torch.matmul(q, k.transpose(3, 2)) + bias          # T5 does not scale its scores
        weights = torch.softmax(scores.float(), dim=-1).type_as(scores)
        return self.o(torch.matmul(weights, v).transpose(1, 2).reshape(b, s, -1))


class _T5LayerSelfAttention(nn.Module):
    def __init__(self, c: T5EncoderConfig, has_bias: bool, device=None):
        super().__init__()
        self.SelfAttention = _T5Attention(c, has_bias, device)
        self.layer_norm = T5LayerNorm(c.d_model, c.layer_norm_epsilon, device)

    def forward(self, x: Tensor, bias: Tensor) -> Tensor:
        return x + self.SelfAttention(self.layer_norm(x), bias)


class _T5Dense(nn.Module):
    """`T5DenseGatedActDense` (wi_0, wi_1, wo) or `T5DenseActDense` (wi, wo)."""

    def __init__(self, c: T5EncoderConfig, device=None):
        super().__init__()
        self.gated = c.is_gated
        self.act = _activation(c.dense_act)
        for name in (("wi_0", "wi_1") if self.gated else ("wi",)):
            setattr(self, name, nn.Linear(c.d_model, c.d_ff, bias=False, device=device))
        self.wo = nn.Linear(c.d_ff, c.d_model, bias=False, device=device)

    def forward(self, x: Tensor) -> Tensor:
        h = self.act(self.wi_0(x)) * self.wi_1(x) if self.gated else self.act(self.wi(x))
        return self.wo(h.to(self.wo.weight.dtype))


class _T5LayerFF(nn.Module):
    def __init__(self, c: T5EncoderConfig, device=None):
        super().__init__()
        self.DenseReluDense = _T5Dense(c, device)
        self.layer_norm = T5LayerNorm(c.d_model, c.layer_norm_epsilon, device)

    def forward(self, x: Tensor) -> Tensor:
        return x + self.DenseReluDense(self.layer_norm(x))


class _T5Block(nn.Module):
    def __init__(self, c: T5EncoderConfig, has_bias: bool, device=None):
        super().__init__()
        self.layer = nn.ModuleList([_T5LayerSelfAttention(c, has_bias, device), _T5LayerFF(c, device)])

    def forward(self, x: Tensor, bias: Tensor) -> Tensor:
        return self.layer[1](self.layer[0](x, bias))


class _T5Stack(nn.Module):
    def __init__(self, c: T5EncoderConfig, device=None):
        super().__init__()
        self.block = nn.ModuleList(_T5Block(c, i == 0, device) for i in range(c.num_layers))
        self.final_layer_norm = T5LayerNorm(c.d_model, c.layer_norm_epsilon, device)


class T5Encoder(nn.Module):
    """transformers' `T5EncoderModel` up to `last_hidden_state`."""

    def __init__(self, config: T5EncoderConfig, device=None):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model, device=device)
        self.encoder = _T5Stack(config, device)

    def forward(self, input_ids: Tensor, attention_mask: Optional[Tensor] = None) -> Tensor:
        x = self.shared(input_ids)
        blocks = self.encoder.block
        bias = blocks[0].layer[0].SelfAttention.position_bias(input_ids.shape[-1], x.device)
        if attention_mask is not None:
            bias = bias + (1.0 - attention_mask[:, None, None, :].to(x.dtype)) * torch.finfo(x.dtype).min
        for block in blocks:
            x = block(x, bias)
        return self.encoder.final_layer_norm(x)


# ---------------------------------------------------------------------------
# Random weights (transformers' per-layer stds; tests and the smoke test)
# ---------------------------------------------------------------------------
@torch.no_grad()
def init_text_encoder_(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise a `CLIPTextEncoder` or `T5Encoder` in place with the stds
    transformers' `_init_weights` uses (initializer factor 1), norm scales 1
    and biases 0; draws follow `named_parameters` order."""
    if isinstance(module, CLIPTextEncoder):
        c = module.config
        d, layers = c.hidden_size, c.num_hidden_layers
        attn_in = d ** -0.5 * (2 * layers) ** -0.5

        def std(name: str) -> float:
            if "embedding" in name:
                return 0.02
            if "out_proj" in name:
                return d ** -0.5
            if "fc1" in name:
                return (2 * d) ** -0.5
            return attn_in                                   # q, k, v and fc2
    elif isinstance(module, T5Encoder):
        c = module.config

        def std(name: str) -> float:
            if name == "shared.weight":
                return 1.0
            if ".q." in name:
                return (c.d_model * c.d_kv) ** -0.5
            if ".o." in name:
                return (c.num_heads * c.d_kv) ** -0.5
            if ".wo." in name:
                return c.d_ff ** -0.5
            return c.d_model ** -0.5                         # k, v, wi*, the relative bias
    else:
        raise TypeError(f"not a text encoder: {type(module).__name__}")
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif p.ndim == 1:
            p.fill_(1.0)
        else:
            p.normal_(0.0, std(name), generator=generator)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------
WEIGHT_FILE = "model.safetensors"
# entries of a transformers checkpoint that hold no weight of these modules
_SKIPPED_KEYS = ("text_model.embeddings.position_ids",)


def _weight_files(directory: Path):
    """The directory's safetensors files: the shards its index names, or one file."""
    index = directory / f"{WEIGHT_FILE}.index.json"
    if index.exists():
        return [directory / shard for shard in sorted(set(json.loads(index.read_text())["weight_map"].values()))]
    if (directory / WEIGHT_FILE).exists():
        return [directory / WEIGHT_FILE]
    raise FileNotFoundError(f"No {WEIGHT_FILE} or {WEIGHT_FILE}.index.json in {directory}.")


def _load(module: nn.Module, directory: Path, device: torch.device) -> nn.Module:
    """Read the directory's weights one tensor at a time, each upcast to fp32
    on `device`, into `module` (built on the meta device), strictly. T5's
    tied embedding (`shared.weight`, also saved as
    `encoder.embed_tokens.weight`) is loaded once."""
    state = {}
    for path in _weight_files(directory):
        for key, value in iter_torch_state(path):
            if key in _SKIPPED_KEYS:
                continue
            if key == "encoder.embed_tokens.weight":
                key = "shared.weight"
            if key not in state:
                state[key] = value.to(device=device, dtype=torch.float32)
    module.load_state_dict(state, strict=True, assign=True)
    return module.eval().requires_grad_(False)


def load_clip_text_encoder(directory: PathLike, *, device="cuda") -> CLIPTextEncoder:
    directory = Path(directory)
    return _load(CLIPTextEncoder(CLIPTextConfig.from_json(directory / "config.json"), device="meta"),
                 directory, resolve_device(device))


def load_t5_encoder(directory: PathLike, *, device="cuda") -> T5Encoder:
    directory = Path(directory)
    return _load(T5Encoder(T5EncoderConfig.from_json(directory / "config.json"), device="meta"),
                 directory, resolve_device(device))


def save_text_encoder(module: Union[CLIPTextEncoder, T5Encoder], directory: PathLike) -> None:
    """config.json and model.safetensors under transformers' names."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    module.config.to_json(directory / "config.json")
    save_torch_state(module.state_dict(), directory / WEIGHT_FILE)


# ---------------------------------------------------------------------------
# The empty prompt's token ids
# ---------------------------------------------------------------------------
def _read_json(path: Path) -> dict:
    return json.loads(path.read_text()) if path.exists() else {}


def _token_name(directory: Path, field: str) -> str:
    """A special token's text from tokenizer_config.json, else special_tokens_map.json."""
    for name in ("tokenizer_config.json", "special_tokens_map.json"):
        value = _read_json(directory / name).get(field)
        if value is not None:
            return value["content"] if isinstance(value, dict) else value
    raise ValueError(f"{directory}: no {field} in tokenizer_config.json or special_tokens_map.json.")


def _padded(directory: Path, head: list, pad_id: int) -> Tuple[Tensor, Tensor]:
    """`head` padded on the right with `pad_id` to model_max_length, and its mask."""
    config = _read_json(directory / "tokenizer_config.json")
    if config.get("padding_side", "right") != "right":
        raise ValueError(f"{directory}: padding_side {config['padding_side']!r} (only 'right' is read).")
    length = config.get("model_max_length")
    if not isinstance(length, int):
        raise ValueError(f"{directory}: tokenizer_config.json names no integer model_max_length.")
    if length < len(head):
        raise ValueError(f"{directory}: model_max_length {length} is shorter than the empty prompt's tokens.")
    n = length - len(head)
    return torch.tensor([head + [pad_id] * n]), torch.tensor([[1] * len(head) + [0] * n])


def _ids_of(directory: Path, names, tables) -> list:
    """The ids of the token texts `names`, from the first table that has each."""
    out = []
    for name in names:
        found = next((t[name] for t in tables if name in t), None)
        if found is None:
            raise ValueError(f"{directory}: the tokenizer files give no id for {name!r}.")
        out.append(int(found))
    return out


def _added_tokens(directory: Path) -> dict:
    """text -> id of tokenizer_config.json's `added_tokens_decoder`."""
    decoder = _read_json(directory / "tokenizer_config.json").get("added_tokens_decoder", {})
    return {v["content"]: int(k) for k, v in decoder.items()}


def clip_empty_prompt_ids(directory: PathLike) -> Tuple[Tensor, Tensor]:
    """(input_ids, attention_mask), each (1, model_max_length): what
    `CLIPTokenizer` gives `[""]` with max_length padding."""
    directory = Path(directory)
    names = [_token_name(directory, f) for f in ("bos_token", "eos_token", "pad_token")]
    vocab = _read_json(directory / "vocab.json")
    bos, eos, pad = _ids_of(directory, names, (_added_tokens(directory), vocab))
    return _padded(directory, [bos, eos], pad)


def t5_empty_prompt_ids(directory: PathLike) -> Tuple[Tensor, Tensor]:
    """(input_ids, attention_mask), each (1, model_max_length): what
    `T5TokenizerFast` gives `[""]` with max_length padding."""
    directory = Path(directory)
    names = [_token_name(directory, f) for f in ("eos_token", "pad_token")]
    added = {t["content"]: t["id"] for t in _read_json(directory / "tokenizer.json").get("added_tokens", [])}
    eos, pad = _ids_of(directory, names, (_added_tokens(directory), added))
    return _padded(directory, [eos], pad)
