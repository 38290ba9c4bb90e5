"""Model FLOPs of the traced steps' pairs (the frozen `lora_train_step_flops`:
the forward and the frozen base's input gradients; recompute excluded) over
the traced stretch (whole synchronised steps) and the card's bf16 peak, in %."""
from perfbench.yardstick.readers import model_flops_util


def read(run):
    c = run.counters
    if not c.get("traced_steps"):
        return None
    return model_flops_util(run, c.get("flops_per_pair"), c["traced_steps"] * c["pairs_per_step"])
