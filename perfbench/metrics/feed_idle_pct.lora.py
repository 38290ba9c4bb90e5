"""Share of the traced window in which no kernel runs on the card while the
loop's thread is in the feed (a `data.next` span of the program is open),
in %. `idle_share` also serves `model_idle_pct.lora`."""
from perfbench import harness


def idle_share(run, kind):
    """% of the traced window with no kernel running and a span of `kind` open."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    spans = [(s, s + d) for n, s, d in run.trace.host_ops if n.split("#")[0] == kind]
    if not spans:
        return None
    w = run.trace.window_s
    idle, cursor = [], 0.0
    for s, e in harness.merged([(s, s + d) for _, s, d in run.trace.kernels]):
        if s > cursor:
            idle.append((cursor, s))
        cursor = max(cursor, e)
    idle.append((cursor, w))
    both = sum(max(0.0, min(b, d) - max(a, c)) for a, b in harness.merged(spans) for c, d in idle)
    return 100.0 * both / w


def read(run):
    return idle_share(run, "data.next")
