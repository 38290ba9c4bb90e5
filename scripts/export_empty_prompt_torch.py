#!/usr/bin/env python3
"""Write the empty prompt's CLIP + T5 embeddings to empty_prompt_embeds.npz
beside a FLUX checkpoint, with the port's own text encoders.

The flags of `scripts/export_empty_prompt.py` plus `--device` (the card
unless `--device cpu`; a missing card raises). The checkpoint directory needs
`tokenizer/`, `text_encoder/`, `tokenizer_2/` and `text_encoder_2/` in
Hugging Face's layout; neither `transformers` nor a tokenizer library is
used. `FluxTextAlphaModel.from_pretrained` does the same when the npz is
absent; an npz that already exists is read, not rewritten.

    python scripts/export_empty_prompt_torch.py --model-path FLUX.1-Kontext-dev [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ragb_vae_tpu_torch.models.flux_kontext_textalpha import EMPTY_PROMPT_FILE, encode_empty_prompt  # noqa: E402


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", required=True,
                        help="Local HF-layout FLUX dir (tokenizer/, text_encoder/, tokenizer_2/, text_encoder_2/).")
    parser.add_argument("--device", default="cuda", help="Where the encoders run (default: the card).")
    args = parser.parse_args(argv)
    prompt, pooled, text_ids = encode_empty_prompt(args.model_path, device=args.device)
    print(
        f"Exported empty prompt embeds to {Path(args.model_path) / EMPTY_PROMPT_FILE}: "
        f"prompt {prompt.shape}, pooled {pooled.shape}, text_ids {text_ids.shape}"
    )


if __name__ == "__main__":
    main()
