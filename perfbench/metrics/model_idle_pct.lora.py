"""Share of the traced window in which no kernel runs on the card while the
loop's thread is in a training step (a `lora.step` span of the program is
open: the encodes, the loss, its backward and the optimizer), in %."""
from pathlib import Path

from perfbench import harness


def read(run):
    feed = harness.load_file_module(Path(__file__).with_name("feed_idle_pct.lora.py"), "perfbench_metric_idle_share")
    return feed.idle_share(run, "lora.step")
