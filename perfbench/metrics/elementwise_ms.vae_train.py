"""Device ms a traced step in kernels that are neither the port's nor a GEMM,
conv or collective library's: PyTorch's own elementwise, copy and reduce
work (and the copies and fills between host and card)."""
from perfbench.yardstick import work


def read(run):
    steps = run.counters.get("traced_steps")
    if run.trace is None or not steps:
        return None
    return 1000.0 * work.class_seconds(run.trace.kernels).get(work.ELEMENTWISE, 0.0) / steps
