"""The attention of the traced transformer steps (each forward's 57 joint
attentions over the packed image and prompt tokens), as its least time on
the card's roofline over the device time of the attention kernels (K3), in %."""
from perfbench.yardstick import work
from perfbench.yardstick.readers import roofline_pct


def read(run):
    c, cfg = run.counters, run.config
    if not c.get("traced_forward_rows"):
        return None
    calls, heads, seq, d = work.flux_attention_calls(cfg["transformer"], c["img_seq"], c["txt_seq"])
    jobs = [(c["traced_forward_rows"] * calls, work.attention_fwd(1, heads, seq, d))]
    return roofline_pct(run, jobs, ("k3_attention",))
