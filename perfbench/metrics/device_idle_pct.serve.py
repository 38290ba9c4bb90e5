"""Share of the traced stretch (whole transformer steps of one batch) in
which no kernel ran on the card, in %."""
from perfbench.yardstick.readers import device_idle_pct as read  # noqa: F401
