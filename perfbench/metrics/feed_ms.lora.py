"""Host ms a traced step in the feed: the program's `data.next` spans (one a
batch handed over by `cuda_prefetch`: the loader's queue, the padding, the
pinning and the copy's enqueue) inside the traced window, over the traced
steps."""


def read(run):
    steps = run.counters.get("traced_steps")
    if run.trace is None or not steps:
        return None
    w = run.trace.window_s
    spans = [(s, s + d) for n, s, d in run.trace.host_ops if n == "data.next"]
    if not spans:
        return None
    return 1000.0 * sum(max(0.0, min(b, w) - max(a, 0.0)) for a, b in spans) / steps
