"""The resnet blocks' forward convolutions that the traced steps ask for
(the triplet's encode and the decode, their recompute under gradient
checkpointing, the frozen reference's encode), as their least time on the
card's roofline over the device time of the kernels that compute them (K1;
K8 where the Winograd route takes them), in %."""
from perfbench.yardstick import work
from perfbench.yardstick.readers import roofline_pct


def read(run):
    c = run.counters
    steps, rows = c.get("traced_steps"), c.get("images_per_step")
    if run.trace is None or not steps or not rows:
        return None
    v = run.config["vae"]
    again = 2 if c.get("remat") else 1
    jobs = []
    for ops, nbytes, in_stack in work.resnet_blocks(v, c["image_size"], "encoder"):
        jobs.append((steps * 3 * rows * ((again if in_stack else 1) + 1), (ops, nbytes)))  # + the reference ae
    for ops, nbytes, in_stack in work.resnet_blocks(v, c["image_size"], "decoder"):
        jobs.append((steps * rows * (again if in_stack else 1), (ops, nbytes)))
    return roofline_pct(run, jobs, ("k1_resnet_conv", "k8_wino_conv", "k8_wino_act"))
