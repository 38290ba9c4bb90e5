"""Requests served per batch launched (`InferenceServer.stats`: served / batches) over the run."""


def read(run):
    served, batches = run.counters.get("served"), run.counters.get("server_batches")
    if not served or not batches:
        return None
    return served / batches
