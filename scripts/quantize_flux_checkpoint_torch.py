#!/usr/bin/env python
"""Quantize a FLUX transformer checkpoint to weight-only int8 on disk (PyTorch).

Counterpart of `scripts/quantize_flux_checkpoint.py` for the PyTorch package:
same arguments, and it writes the same directory (config.json +
quantized_params.npz + quantization.json; per-output-channel symmetric int8,
`ragb_vae_tpu_torch/models/quantize.py`), which either package loads through
`FluxTextAlphaModel.from_pretrained(..., weight_quant="int8")` and its
`inference --quant int8`. The arithmetic runs on `--device` (default `cuda`: a
missing card is an error; `--device cpu` runs it on the host), one kernel there
at a time.

Usage:
  python scripts/quantize_flux_checkpoint_torch.py \
      --model_path /ckpts/flux-kontext --subfolder transformer \
      --output_dir /ckpts/flux-kontext-int8/transformer
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_path", required=True,
                   help="HF-format checkpoint root (dir containing the transformer subfolder).")
    p.add_argument("--subfolder", default="transformer")
    p.add_argument("--output_dir", required=True,
                   help="Destination for the quantized checkpoint (config.json + "
                        "quantized_params.npz + quantization.json).")
    p.add_argument("--device", default="cuda",
                   help="Where each kernel is quantised. 'cuda' without a CUDA device is an error.")
    args = p.parse_args(argv)

    from ragb_vae_tpu_torch.device import resolve_device
    from ragb_vae_tpu_torch.models.flux_weights import (
        iter_leaves,
        load_flux_transformer_params,
        params_to_flax,
    )
    from ragb_vae_tpu_torch.models.quantize import (
        quantize_transformer_params,
        save_quantized_transformer,
    )

    device = resolve_device(args.device)
    config, state = load_flux_transformer_params(args.model_path, args.subfolder)
    params = params_to_flax(state)
    n_params = sum(int(leaf.size) for _, leaf in iter_leaves(params))
    qparams = quantize_transformer_params(params, device)
    q_bytes = sum(leaf.numel() * leaf.element_size() if hasattr(leaf, "numel") else leaf.nbytes
                  for _, leaf in iter_leaves(qparams))
    save_quantized_transformer(config, qparams, args.output_dir)
    print(
        f"Quantized {n_params/1e9:.2f} B params -> {q_bytes/2**30:.2f} GiB resident "
        f"(bf16 would be {2*n_params/2**30:.2f} GiB); saved to {args.output_dir}"
    )


if __name__ == "__main__":
    main()
