#!/usr/bin/env python
"""Training entry point of the PyTorch port:

    python scripts/train_torch.py --config configs/flux_vae.yaml [--stage S] [--device cuda]

Loads a `{data, training, model}` YAML (with `${env:VAR}` expansion) and runs
the stage `training.stage` names (`--stage` overrides it) through
`ragb_vae_tpu_torch.training.run_stage`, on `--device`: the card by default;
a missing card raises. `--device cpu` runs on the CPU. The installed
`ragb-train-torch` entry point runs the same code
(`ragb_vae_tpu_torch._cli.run_training`). Data parallel over N processes:

    torchrun --nproc_per_node N scripts/train_torch.py --config CFG.yaml

(each process on `cuda:LOCAL_RANK`; `--device cpu` joins a gloo group).
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ragb_vae_tpu_torch._cli import run_training  # noqa: E402


def main(argv=None):
    return run_training(argv)


if __name__ == "__main__":
    main()
