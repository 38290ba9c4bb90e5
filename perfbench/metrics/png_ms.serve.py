"""Mean time the daemon's handler spent on a request's PNGs, in ms: reading
and decoding the body to float, and clipping, encoding and writing the
answer (the program's `http.png` counter)."""


def read(run):
    try:
        from ragb_vae_tpu_torch.utils.profiling import counters
    except ImportError:      # a program without counters
        return None
    c = counters().get("http.png")
    return 1000.0 * c["total"] / c["count"] if c and c["count"] else None
