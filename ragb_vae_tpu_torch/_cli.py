"""Console entry points of the PyTorch port (pyproject [project.scripts]):
`ragb-train-torch`, `ragb-infer-torch` and `ragb-serve-torch`, the
counterparts of `ragb-train`, `ragb-infer` and `ragb-serve`. Each runs on
`--device` (default `cuda`; a missing card raises)."""
from __future__ import annotations

import argparse


def run_training(argv=None) -> dict:
    """Parse the training flags, load the `{data, training, model}` YAML
    (with `${env:VAR}` expansion) and run the stage that `training.stage`
    names (`--stage` overrides it) on `--device`. -> the stage's last metrics.
    Under `torchrun --nproc_per_node N` each process joins the group and
    trains on `cuda:LOCAL_RANK`, data parallel (ZeRO-2)."""
    parser = argparse.ArgumentParser(description="Train ragb-vae stages on PyTorch.")
    parser.add_argument("--config", required=True, help="Path to the YAML config.")
    parser.add_argument("--stage", default=None, help="Override training.stage from the config.")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    args = parser.parse_args(argv)

    from ragb_vae_tpu_torch.config import load_config
    from ragb_vae_tpu_torch.device import resolve_device
    from ragb_vae_tpu_torch.parallel.mesh import local_device, maybe_init_distributed
    from ragb_vae_tpu_torch.training import run_stage

    device = local_device(resolve_device(args.device))
    maybe_init_distributed(device)
    cfg = load_config(args.config)
    if args.stage:
        cfg.setdefault("training", {})["stage"] = args.stage
    return run_stage(cfg, device=device)


def train_main(argv=None) -> None:
    run_training(argv)


def infer_main(argv=None) -> None:
    from ragb_vae_tpu_torch.inference import main

    main(argv)


def serve_main(argv=None) -> None:
    from ragb_vae_tpu_torch.serving_daemon import main

    main(argv)
