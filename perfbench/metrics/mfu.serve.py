"""Model FLOPs of the traced transformer steps (the frozen
`flux_transformer_flops` at the packed image and prompt tokens, a row a
forward) over the traced stretch and the card's bf16 peak, in %. The steps
are nearly all of a request's model FLOPs (the VAE's encode and decode are
under 1% of `textalpha_sample_flops` at 512x512 and 20 steps)."""
from perfbench.yardstick import flops as FL
from perfbench.yardstick.readers import model_flops_util


def read(run):
    c = run.counters
    if not c.get("traced_forward_rows"):
        return None
    per_row = FL.flux_transformer_flops(FL.as_config(run.config["transformer"]), c["img_seq"], c["txt_seq"])
    return model_flops_util(run, per_row, c["traced_forward_rows"])
