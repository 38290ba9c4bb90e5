"""Share of the traced steps (whole, synchronised at both ends) in which no
kernel ran on the card, in %."""
from perfbench.yardstick.readers import device_idle_pct as read  # noqa: F401
