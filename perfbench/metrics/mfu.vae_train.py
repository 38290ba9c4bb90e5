"""Model FLOPs of the traced steps' images (the frozen `vae_train_step_flops`:
triplet encode, decode, LPIPS and their backward; recompute excluded) over
the traced stretch (whole synchronised steps) and the card's bf16 peak, in %."""
from perfbench.yardstick.readers import model_flops_util


def read(run):
    c = run.counters
    if not c.get("traced_steps"):
        return None
    return model_flops_util(run, c.get("flops_per_image"), c["traced_steps"] * c["images_per_step"])
