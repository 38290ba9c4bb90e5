"""The attention backward of the traced steps (each pair's 57 joint
attentions over the packed image and prompt tokens), as its least time on
the card's roofline over the device time of the kernels that compute it
(K4 dQ and K5 dK/dV), in %."""
from perfbench.yardstick import work
from perfbench.yardstick.readers import roofline_pct


def read(run):
    c = run.counters
    steps, pairs = c.get("traced_steps"), c.get("pairs_per_step")
    if not steps or not pairs:
        return None
    calls, heads, seq, d = work.flux_attention_calls(run.config["transformer"], c["img_seq"], c["txt_seq"])
    return roofline_pct(run, [(steps * pairs * calls, work.attention_bwd(1, heads, seq, d))],
                        ("k4_attention_dq", "k5_attention_dkv"))
