"""Host ms a step that the loop waited for its next batch from the
prefetching feed (`cuda_prefetch` over the stage's loader), over the window."""


def read(run):
    return run.counters.get("loader_wait_ms")
